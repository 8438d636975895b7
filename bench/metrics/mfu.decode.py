"""mfu.decode: the least time the card could take for the window's work
over the window's time in its steps, in %: for each decode step the larger of its
model operations over the bf16 peak and its compulsory bytes (packed
weights, head, KV rows read and written) over the memory rate, for each
prefill the same of the prefill; summed over the window."""
from bench.metrics.common import (bound, share, sizes, steps_len,
                                  window_steps)
from bench.yardstick.work import decode_step_work, prefill_work


def read(run):
    s = sizes(run)
    total = 0.0
    for sp in window_steps(run):
        i = sp["info"]
        n = i.get("decode_steps", 0)
        if n and i["lanes"]:
            total += n * bound(decode_step_work(s, i["lanes"],
                                                i["kv_rows"] // n))
        for S in i.get("admitted", []):
            total += bound(prefill_work(s, S))
    return share(total, steps_len(run))
