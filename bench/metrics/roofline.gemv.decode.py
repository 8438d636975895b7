"""roofline.gemv.decode: row 1 (``packed_xnor_gemv``) in the traced
sub-window: the bound of every Boolean projection of every decode step
(bf16 x of the live lanes, packed words, fp32 y; 2·M·K·N operations),
over the device time of the kernels named in ``common.GEMV``, in %."""
from bench.metrics.common import GEMV, bound, share, sizes, window_steps
from bench.yardstick.work import gemv_work


def read(run):
    if run.traced is None:
        return None
    s = sizes(run)
    total = 0.0
    for sp in window_steps(run, traced=True):
        i = sp["info"]
        if i.get("decode_steps") and i["lanes"]:
            per_step = sum(bound(gemv_work(i["lanes"], K, N))
                           for _, K, N in s.projections())
            total += i["decode_steps"] * s.n_layers * per_step
    return share(total, run.traced.kernel_s(GEMV))
