"""scan_bwd_ms.train: device ms a training step spends in the selective
scan's backward: the kernels attributed to the autograd functions whose
sequence number and forward thread are those of an op under a
``mamba.scan`` range (``bench.spans``: ``mamba.scan.backward``), over
the harness's ``train.step`` ranges in the traced sub-window."""
from bench import spans


def read(run):
    sp = spans.of(run)
    n = sp.steps("train.step") if sp else 0
    if not n or not sp.count(spans.SCAN_BACKWARD):
        return None
    return sp.device_s(spans.SCAN_BACKWARD) * 1e3 / n
