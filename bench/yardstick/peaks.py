"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates), as
``repro_torch.launch.hlo_analysis.H100_SXM`` and ``chip_smoke.py`` hold
them. Rates assume the card's full 700 W power limit."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak rates of one card and its links (per card, per direction)."""
    name: str
    peak_flops_bf16: float      # FLOP/s
    peak_ops_int8: float        # OP/s
    hbm_bw: float               # bytes/s
    node_bw: float              # bytes/s a card on links within a node
    net_bw: float               # bytes/s a card across nodes
    node_size: int              # cards a node


H100_SXM = Hardware("NVIDIA H100 SXM5 80GB (datasheet)", 989.4e12,
                    1978.9e12, 3.35e12, 450e9, 50e9, 8)

# chip_smoke.py phase 2's table: the memory rate and the tensor-core (bf16,
# int8) and CUDA-core (fp32) rates a kernel's bound is taken against
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}


def bound_s(bytes_moved: float, flops: float, kind: str = "bf16") -> float:
    """The least seconds of a piece of work: its bytes over the memory
    rate or its operations over the peak of ``kind``, whichever is
    larger (``chip_smoke.bound``, in seconds)."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def roofline_terms(flops: float, nbytes: float, hw: Hardware = H100_SXM):
    """The compute and memory terms of ``hlo_analysis.roofline_terms`` on
    one card with no collective: seconds and the bound."""
    compute_s = flops / hw.peak_flops_bf16
    memory_s = nbytes / hw.hbm_bw
    return {"compute_s": compute_s, "memory_s": memory_s,
            "step_time_lower_bound_s": max(compute_s, memory_s),
            "bottleneck": "compute" if compute_s >= memory_s else "memory"}
