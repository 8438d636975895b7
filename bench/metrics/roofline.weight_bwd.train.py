"""roofline.weight_bwd.train: row 3 (``boolean_weight_bwd``) in the
traced sub-window: the votes of every Boolean projection of every layer
of every microbatch of the traced steps (2·M·K·N operations: bf16 x and
z, fp32 votes), at their bound, over the device time of the kernels
named in ``common.WEIGHT_BWD``, in %."""
from bench.metrics.common import (WEIGHT_BWD, bound, share, sizes,
                                  window_steps)
from bench.yardstick.work import weight_bwd_work


def read(run):
    if run.traced is None:
        return None
    s = sizes(run)
    micro = int(run.cell["traffic_params"]["microbatches"])
    total = 0.0
    for sp in window_steps(run, traced=True):
        rows = sp["info"]["tokens"] // micro
        total += micro * s.n_layers * sum(
            bound(weight_bwd_work(rows, K, N)) for _, K, N in s.projections())
    return share(total, run.traced.kernel_s(WEIGHT_BWD))
