"""scan_ms.train: device ms a step of the selective scan: the kernels
launched by aten ops that read a tensor whose last two dims are
(d_inner, N), forward, recompute and backward, as chip_smoke.py's phase
18 groups them, in the one step traced with shapes after the window
(``Run.shape_probe``)."""
from bench.metrics.common import sizes


def read(run):
    t = run.shape_traced
    if t is None:
        return None
    n = sum(1 for sp in run.spans if sp["name"] == "train.step"
            and sp["t0"] >= t.t0 and sp["t1"] <= t.t1)
    s = sizes(run)
    sec = t.op_kernels_reading((s.di, s.ssm_state))
    return sec * 1e3 / n if n and sec else None
