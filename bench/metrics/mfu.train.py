"""mfu.train: the least time the card could take for the window's steps
over the window's time in its steps, in %: each step the larger of its model
operations (6 · parameters · tokens, no recomputation) over the bf16
peak and its compulsory bytes over the memory rate."""
from bench.metrics.common import (bound, share, sizes, steps_len,
                                  window_steps)
from bench.yardstick.work import train_step_work


def read(run):
    s = sizes(run)
    total = sum(bound(train_step_work(s, sp["info"]["tokens"]))
                for sp in window_steps(run))
    return share(total, steps_len(run))
