"""host_step_ms.decode: median host wall of one decode step: each
``session.step()`` of the window that decoded, its wall over the decode
steps it ran (host clock on the harness's spans)."""
from bench.metrics.common import median, window_steps


def read(run):
    return median((s["t1"] - s["t0"]) * 1e3 / s["info"]["decode_steps"]
                  for s in window_steps(run)
                  if s["info"].get("decode_steps"))
