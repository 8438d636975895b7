"""Analytic energy model (paper Appendix E), a copy of the JAX package's
``energy/model.py`` name for name and number for number.

Energy = compute energy + memory-movement energy over a tiled memory
hierarchy. Memory energy is (number of accesses per level) × (per-access
cost), with the tiling found by exhaustive search (Alg 9) under buffer
capacity constraints and filter-stationary data movement (Alg 10); access
counts follow Tables 18 (forward) and 19 (backward).

Hierarchies (the model's data about those chips, unchanged from the JAX
package; none of them is a measurement of the card the port runs on):
  ASCEND  — Table 14 (energy-efficiency GBPS/mW -> pJ/byte, L3..L0).
  V100    — Table 15 (normalized cost per access level vs 1 MAC at ALU).
  TPU_V5E — the JAX package's extension: HBM -> VMEM -> VREG
            (coefficients scaled from public 7nm estimates).

Arithmetic costs: MAC energy by dtype; Boolean XNOR+count on int8/1-bit
datapaths uses the paper's convention ADD-INTn = (2n-1) logic-gate units.
Pure Python arithmetic: the results equal the JAX package's exactly.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Hardware descriptions
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Hierarchy:
    name: str
    # per-byte access energy (pJ/byte), outermost (DRAM) first
    level_names: Tuple[str, ...]
    pj_per_byte: Tuple[float, ...]
    # capacity in bytes per level (None = unbounded DRAM)
    capacity: Tuple[Optional[int], ...]
    # compute energy (pJ) per MAC by bitwidth
    mac_pj: Dict[str, float]


def _ee_to_pj(gbps_per_mw: float) -> float:
    # Table 14: EE [GBPS/mW]; energy per byte = power/throughput
    # 1 mW / 1 GBPS = 1e-3 J / 1e9 B = 1e-12 J/B = 1 pJ/B.
    return 1.0 / gbps_per_mw


# Ascend (Table 14): EE [GBPS/mW] = {L3: .02, L2: .2, L1: .4, L0A: 4.9,
# L0B: 3.5, L0C: 5.4}; capacities KB: L2 8192, L1 1024, L0A/B 64, L0C 256.
ASCEND = Hierarchy(
    name="ascend",
    level_names=("L3", "L2", "L1", "L0"),
    pj_per_byte=(_ee_to_pj(0.02), _ee_to_pj(0.2), _ee_to_pj(0.4),
                 _ee_to_pj(4.2)),          # L0 averaged over A/B/C
    capacity=(None, 8192 * 1024, 1024 * 1024, 64 * 1024),
    # 1.7 TOPS/W cube => ~0.59 pJ/op fp16 MAC; int8 ~0.3; Boolean XNOR+count
    # modeled at 1-bit logic: ADD-INTn = (2n-1) gates.
    mac_pj={"fp32": 2.3, "fp16": 0.59, "int8": 0.30, "int4": 0.16,
            "bool": 0.025},
)

# V100 (Table 15): normalized energy per access, RF=1x=1 MAC at ALU.
_V100_MAC_PJ = 4.6  # fp32 MAC at 12nm, ~4.6 pJ (Horowitz-scaled)
V100 = Hierarchy(
    name="v100",
    level_names=("DRAM", "L2", "L1", "RF"),
    pj_per_byte=tuple(x * _V100_MAC_PJ / 4 for x in (200, 6, 2, 1)),
    capacity=(None, 6 * 2 ** 20, 128 * 2 ** 10, 64 * 2 ** 10),
    mac_pj={"fp32": 4.6, "fp16": 1.5, "int8": 0.8, "int4": 0.4,
            "bool": 0.06},
)

# TPU v5e extension: HBM ~ 3.5 pJ/byte (HBM2e), VMEM ~0.18, VREG ~0.05;
# MXU bf16 MAC ~0.35 pJ, int8 ~0.18.
TPU_V5E = Hierarchy(
    name="tpu_v5e",
    level_names=("HBM", "VMEM", "VREG"),
    pj_per_byte=(3.5, 0.18, 0.05),
    capacity=(None, 128 * 2 ** 20, 16 * 2 ** 10),
    mac_pj={"fp32": 1.2, "bf16": 0.35, "fp16": 0.35, "int8": 0.18,
            "int4": 0.10, "bool": 0.02},
)

BYTES = {"fp32": 4.0, "fp16": 2.0, "bf16": 2.0, "int8": 1.0, "int4": 0.5,
         "bool": 1.0 / 8.0, "int16": 2.0}

# Adder-only fraction of a full MAC's energy (±1 weights remove the
# multiplier; the paper's ADD-INTn = (2n-1) gate-unit convention).
_ADD_FRACTION = 0.2
_NUMERIC_EQUIV = {"int16": "fp16", "bf16": "fp16"}


def _mac_energy(hw: "Hierarchy", w_dtype: str, a_dtype: str) -> float:
    if w_dtype == "bool" and a_dtype == "bool":
        return hw.mac_pj["bool"]             # XNOR + popcount increment
    if w_dtype == "bool" or a_dtype == "bool":
        # mixed-type xnor(a, x) = ±x: sign-flip + ADD only, at the numeric
        # operand's width
        num = a_dtype if w_dtype == "bool" else w_dtype
        num = _NUMERIC_EQUIV.get(num, num)
        return _ADD_FRACTION * hw.mac_pj.get(num, hw.mac_pj["fp32"])
    wide = w_dtype if BYTES[w_dtype] >= BYTES[a_dtype] else a_dtype
    wide = _NUMERIC_EQUIV.get(wide, wide)
    return hw.mac_pj.get(wide, hw.mac_pj["fp32"])


# ---------------------------------------------------------------------------
# Layer shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ConvShape:
    """Table 16 parameters."""
    N: int; M: int; C: int
    HI: int; WI: int
    HF: int; WF: int
    stride: int = 1

    @property
    def HO(self): return self.HI // self.stride
    @property
    def WO(self): return self.WI // self.stride

    def macs(self) -> float:
        return float(self.N) * self.M * self.C * self.HO * self.WO \
            * self.HF * self.WF

    def ifmap_elems(self): return float(self.N) * self.C * self.HI * self.WI
    def filter_elems(self): return float(self.M) * self.C * self.HF * self.WF
    def ofmap_elems(self): return float(self.N) * self.M * self.HO * self.WO


@dataclasses.dataclass(frozen=True)
class LinearShape:
    N: int      # batch (tokens)
    Cin: int
    Cout: int

    def as_conv(self) -> ConvShape:
        return ConvShape(N=self.N, M=self.Cout, C=self.Cin, HI=1, WI=1,
                         HF=1, WF=1)


# ---------------------------------------------------------------------------
# Tiling search (Alg 9) + access counts (Tables 18/19)
# ---------------------------------------------------------------------------
def _candidates(total: int) -> List[int]:
    """Divisor-ish tile sizes (powers of two + total)."""
    cands = {total}
    t = 1
    while t < total:
        cands.add(t)
        t *= 2
    return sorted(cands)


def _tile_level(shape: ConvShape, upper: dict, cap: Optional[int],
                b_i: float, b_f: float) -> dict:
    """One level of Alg 9: maximize buffer use within capacity."""
    if cap is None:
        return upper
    best, best_q = None, -1.0
    for m in _candidates(upper["M"]):
        for n in _candidates(upper["N"]):
            for hi in _candidates(upper["HI"]):
                wi = upper["WI"]
                q_i = n * shape.C * hi * wi * b_i
                q_f = m * shape.C * shape.HF * shape.WF * b_f
                if q_i + q_f > cap:
                    continue
                q = q_i + q_f
                if q > best_q:
                    best_q = q
                    best = {"M": m, "N": n, "HI": hi, "WI": wi}
    return best or {"M": 1, "N": 1, "HI": min(shape.HF, upper["HI"]),
                    "WI": upper["WI"]}


def _access_counts(shape: ConvShape, tiles: List[dict]) -> Dict[str, List[float]]:
    """Tables 18: per-level access multipliers under filter-stationary
    movement (Alg 10): filters read once per level; ifmaps re-read once per
    filter block of the level below."""
    n_levels = len(tiles)
    i_acc, f_acc, o_acc = [], [], []
    for li in range(n_levels):
        upper = tiles[li - 1] if li > 0 else {"M": shape.M, "N": shape.N,
                                              "HI": shape.HI, "WI": shape.WI}
        cur = tiles[li]
        i_acc.append(max(upper["M"] // max(cur["M"], 1), 1))
        f_acc.append(max((upper["N"] // max(cur["N"], 1))
                         * (upper["HI"] // max(cur["HI"], 1)), 1))
        o_acc.append(1.0)
    return {"I": i_acc, "F": f_acc, "O": o_acc}


def layer_energy(shape, hw: Hierarchy, w_dtype: str = "fp32",
                 a_dtype: str = "fp32", mode: str = "forward") -> Dict[str, float]:
    """Energy (pJ) of one layer pass on one hierarchy.

    mode: forward | backward (backward = dLoss/dF + dLoss/dI convs, Eq 53/54,
    ~2x forward MACs with OFMAP-grad as input — Table 19 structure).
    """
    if isinstance(shape, LinearShape):
        shape = shape.as_conv()
    b_i, b_f = BYTES[a_dtype], BYTES[w_dtype]

    # --- compute energy -----------------------------------------------------
    macs = shape.macs() * (2.0 if mode == "backward" else 1.0)
    e_compute = macs * _mac_energy(hw, w_dtype, a_dtype)

    # --- tiling (Alg 9) ------------------------------------------------------
    tiles = []
    upper = {"M": shape.M, "N": shape.N, "HI": shape.HI, "WI": shape.WI}
    for cap in hw.capacity:
        cur = _tile_level(shape, upper, cap, b_i, b_f)
        tiles.append(cur)
        upper = cur

    acc = _access_counts(shape, tiles)

    # --- movement energy (Eq 51/52) ------------------------------------------
    q_i = shape.ifmap_elems() * b_i
    q_f = shape.filter_elems() * b_f
    # OFMAP: partial sums are >=16-bit ONLY near the compute unit (L0-C);
    # the activation written back through DRAM is the network's activation
    # dtype (1-bit post-threshold in Boolean nets) — this is the data-
    # movement saving the paper's whole argument rests on.
    q_o_act = shape.ofmap_elems() * b_i
    q_o_psum = shape.ofmap_elems() * max(b_i, 2.0)
    if mode == "backward":
        q_i = q_i + q_o_act                        # grads flow both ways

    e_mem = 0.0
    cum_i = cum_f = 1.0
    n_lv = len(hw.pj_per_byte)
    for li, pj in enumerate(hw.pj_per_byte):
        cum_i *= acc["I"][li]
        cum_f *= acc["F"][li]
        e_mem += q_i * cum_i * pj + q_f * cum_f * pj
        if li >= n_lv - 2:
            e_mem += q_o_psum * 2.0 * pj           # near-compute partials r/w
        else:
            e_mem += q_o_act * pj                  # committed activations

    return {"compute_pj": e_compute, "memory_pj": e_mem,
            "total_pj": e_compute + e_mem, "macs": macs}


def network_energy(layers: Sequence, hw: Hierarchy, w_dtype="fp32",
                   a_dtype="fp32", mode="forward") -> Dict[str, float]:
    tot = {"compute_pj": 0.0, "memory_pj": 0.0, "total_pj": 0.0, "macs": 0.0}
    for l in layers:
        e = layer_energy(l, hw, w_dtype, a_dtype, mode)
        for k in tot:
            tot[k] += e[k]
    return tot


def training_energy(layers: Sequence, hw: Hierarchy, w_dtype="fp32",
                    a_dtype="fp32", g_dtype: Optional[str] = None,
                    latent_weights: bool = False) -> Dict[str, float]:
    """One training iteration = forward + backward + weight update.

    latent_weights=True models BNN-style training (binary forward weights
    but FP32 gradients through FP convs + FP32 latent copies + FP optimizer
    — the paper's central complexity critique); B⊕LD passes
    latent_weights=False with w_dtype='bool': Boolean-weight backward with
    16-bit signals (paper Table 6: W/A/G = 1/1/16) and updates that touch
    bit-packed weights + bf16 accumulators only.
    """
    if g_dtype is None:
        g_dtype = "fp32" if (latent_weights or w_dtype != "bool") else "int16"
    fwd = network_energy(layers, hw, w_dtype, a_dtype, "forward")
    # backward flows g_dtype signals through the (binary) weights: BNNs pay
    # fp32-width adds + fp32 latent/grad movement; B⊕LD pays int16 adds.
    bwd = network_energy(layers, hw, w_dtype, g_dtype, "backward")
    # weight update traffic
    n_w = sum((l.as_conv() if isinstance(l, LinearShape) else l)
              .filter_elems() for l in layers)
    dram = hw.pj_per_byte[0]
    if latent_weights:
        # read+write fp32 latents + fp32 grads + 2 Adam moments
        upd = n_w * (2 * 4 + 4 + 2 * 2 * 4) * dram
    elif w_dtype == "bool":
        # read/write packed weights + bf16 accumulator r/w (B⊕LD optimizer)
        upd = n_w * (2 * BYTES["bool"] + 2 * 2) * dram
    else:
        upd = n_w * (2 * BYTES[w_dtype] + 4 + 4 * 4) * dram
    total = {k: fwd[k] + bwd[k] for k in fwd}
    total["update_pj"] = upd
    total["total_pj"] += upd
    return total
