"""decode_tokens_per_s: output tokens the window's steps returned to the
clients, over the window's seconds (host clock; the window ends with the
last step that began inside it)."""
from bench.metrics.common import window_len, window_steps


def read(run):
    n = sum(s["info"]["emitted"] for s in window_steps(run))
    t = window_len(run)
    return n / t if t else None
