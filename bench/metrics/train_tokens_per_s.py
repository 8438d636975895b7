"""train_tokens_per_s: tokens of the steps completed in the window, over
the time from the window's start to the synchronised end of its last
step (host clock)."""
from bench.metrics.common import window_len, window_steps


def read(run):
    n = sum(s["info"]["tokens"] for s in window_steps(run))
    t = window_len(run)
    return n / t if t and n else None
