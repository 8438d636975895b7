"""optimizer_ms.train: device ms a training step spends in the
optimizer (the flip rule for Boolean leaves, Adam for the others): the
kernels attributed to the ``train.optimizer`` range
(``train/step.py``), over the harness's ``train.step`` ranges in the
traced sub-window."""
from bench import spans


def read(run):
    sp = spans.of(run)
    n = sp.steps("train.step") if sp else 0
    if not n or not sp.count("train.optimizer"):
        return None
    return sp.device_s("train.optimizer") * 1e3 / n
