"""roofline.paged_decode.decode: row 2 (``paged_flash_decode``) in the
traced sub-window: the live KV rows every decode step reads, from the
harness's own per-lane lengths (prompt + tokens returned + the step's
offset in its segment), at their bound, over the device time of the
kernels named in ``common.PAGED_DECODE``, in %."""
from bench.metrics.common import (PAGED_DECODE, bound, share, sizes,
                                  window_steps)
from bench.yardstick.work import decode_work


def read(run):
    if run.traced is None:
        return None
    s = sizes(run)
    total = 0.0
    for sp in window_steps(run, traced=True):
        i = sp["info"]
        n = i.get("decode_steps", 0)
        if n and i["lanes"]:
            total += s.n_layers * bound(decode_work(
                i["kv_rows"], s.kvp, s.group, s.hd, i["lanes"] * n))
    return share(total, run.traced.kernel_s(PAGED_DECODE))
