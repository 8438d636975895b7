"""HTTP/SSE serving gateway: network front door for ``ServeSession``.

The port of the JAX package's ``gateway/``, with the same public names.
Transport-thin by design — admission, quotas, deadlines, and fault
containment all live in ``repro_torch.serve``; this package only maps HTTP
requests onto ``session.submit()``, streams tokens 1:1 as Server-Sent
Events, and renders a Prometheus-text ``/metrics`` page.
"""
from .metrics import GatewayMetrics, Histogram, ITL_BUCKETS, TTFT_BUCKETS
from .server import (DuplicateRequestId, Gateway, GatewayHTTP,
                     parse_generate_body, run_gateway)

__all__ = [
    "DuplicateRequestId", "Gateway", "GatewayHTTP", "GatewayMetrics",
    "Histogram", "ITL_BUCKETS", "TTFT_BUCKETS", "parse_generate_body",
    "run_gateway",
]
