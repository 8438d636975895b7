"""unpack_ms.decode: device ms a cold prefill spends expanding packed
Boolean weights to a ±1 view: the kernels attributed to the
``linear.unpack`` ranges (``core/boolean_linear.py``, contractions of
more than ``PACKED_GEMV_MAX_M`` rows), over the ``serve.prefill`` ranges
that hold one, in the traced sub-window."""
from bench import spans


def read(run):
    sp = spans.of(run)
    n = sp.holding("serve.prefill", "linear.unpack") if sp else 0
    return sp.device_s("linear.unpack") * 1e3 / n if n else None
