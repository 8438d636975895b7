"""scan_fwd_ms.train: device ms a training step spends in the selective
scan's forward: the kernels attributed to the ``mamba.scan`` ranges
(``models/mamba.py::mamba_ssm``, the forward and the remat's recompute),
over the harness's ``train.step`` ranges in the traced sub-window."""
from bench import spans


def read(run):
    sp = spans.of(run)
    n = sp.steps("train.step") if sp else 0
    if not n or not sp.count(spans.SCAN):
        return None
    return sp.device_s(spans.SCAN) * 1e3 / n
