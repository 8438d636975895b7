"""Collective records and the roofline: the counterpart of the JAX
package's ``launch/hlo_analysis.py``, whose name it keeps so that a reader
finds it. There is no HLO here: the port runs eagerly, so it reads the
record of the collectives that a traced step dispatches.

1. **Collectives.** ``CollectiveRecord`` is a ``TorchDispatchMode`` that
   notes every ``c10d`` op dispatched inside it: its kind (the JAX
   package's five, ``all-reduce``, ``all-gather``, ``reduce-scatter``,
   ``all-to-all``, ``collective-permute``; a broadcast, the serve mesh's
   command channel, under its own kind), its result's dtype and shape, its
   group's size and global ranks, and the call site (the ``TrainMesh`` /
   ``ServeMesh`` method and counter, where there is one). The dry run
   traces one rank's step, so the record holds that rank's collectives.
   ``collective_bytes`` and ``collective_breakdown`` sum it with the JAX
   package's operand-from-result rules and ring factors. Eager code runs
   every loop iteration (microbatches, layer groups, chunks), so each op is
   in the record as many times as it runs: no trip counts are needed and
   none is missed, and ``ops_below_known_loops`` (the JAX package's count
   of ops nested deeper than its trip counts reach) is always 0.

2. **FLOPs / bytes** come from the analytic model in ``flops_model.py``,
   validated against ``torch.utils.flop_counter.FlopCounterMode`` on
   loop-free calibration configs (``dryrun --calibrate``).

**Hardware.** ``roofline_terms`` takes a ``Hardware`` record as ``hw=``;
its default, ``H100_SXM``, holds NVIDIA's datasheet figures for the H100
SXM5 80GB (the card the port is measured on: NVIDIA H100 80GB HBM3, power
limit 700.00 W): 989.4 TFLOP/s bf16 dense, 1,978.9 TOPS int8 dense,
3.35 TB/s HBM3, NVLink 4 at 450 GB/s a direction within an 8-card node,
NDR InfiniBand at 400 Gb/s = 50 GB/s a card across nodes. An op's
collective time divides its bytes by the rate of the slowest link its
group crosses: NVLink if all of its ranks share ``rank // 8``, the network
otherwise (a 16 x 16 mesh spans 32 nodes). These are datasheet peaks: a
roofline from them is a prediction, not a reading.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode


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

    def link_bw(self, ranks: Sequence[int]) -> float:
        """The rate of the slowest link a group of global ``ranks``
        crosses: the node's links if they all share a node, else the
        network's."""
        nodes = {r // self.node_size for r in ranks}
        return self.node_bw if len(nodes) <= 1 else self.net_bw


H100_SXM = Hardware("NVIDIA H100 SXM5 80GB (datasheet)", 989.4e12,
                    1978.9e12, 3.35e12, 450e9, 50e9, 8)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op -> (kind, name of its result argument)
_C10D = {
    "allreduce_": ("all-reduce", "tensors"),
    "allreduce_coalesced_": ("all-reduce", "tensors"),
    "_allgather_base_": ("all-gather", "output_tensor"),
    "allgather_": ("all-gather", "output_tensors"),
    "allgather_into_tensor_coalesced_": ("all-gather", "outputs"),
    "_reduce_scatter_base_": ("reduce-scatter", "output_tensor"),
    "reduce_scatter_": ("reduce-scatter", "output_tensors"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "outputs"),
    "alltoall_base_": ("all-to-all", "output"),
    "alltoall_": ("all-to-all", "output_tensors"),
    "send": ("collective-permute", "tensors"),
    "recv_": ("recv", "tensors"),
    "broadcast_": ("broadcast", "tensors"),
    "barrier": ("barrier", None),
}

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64",
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _call_site() -> str:
    """The ``TrainMesh`` / ``ServeMesh`` method (with its ``count``
    argument, where it has one) on the stack, else the innermost function
    of the port that issued the op."""
    from repro_torch.distributed import ServeMesh, TrainMesh

    inner = None
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if "repro_torch" in code.co_filename \
                and not code.co_filename.endswith("hlo_analysis.py"):
            this = f.f_locals.get("self")
            if isinstance(this, (TrainMesh, ServeMesh)):
                count = f.f_locals.get("count")
                site = f"{type(this).__name__}.{code.co_name}"
                return site + (f"[{count}]" if isinstance(count, str) else "")
            if inner is None:
                mod = f.f_globals.get("__name__", "?").rsplit(".", 1)[-1]
                inner = f"{mod}.{code.co_name}"
        f = f.f_back
    return inner or "?"


class CollectiveRecord(TorchDispatchMode):
    """Within its context, note every ``c10d`` op dispatched: ``ops`` is a
    list of dicts {"kind", "dtype", "shape", "bytes" (the result's), "group"
    (its size), "ranks" (global), "site"}. Ops of a kind outside
    ``COLLECTIVES`` (a broadcast, a barrier, a receive) are noted and kept
    out of ``collective_bytes``."""

    def __init__(self):
        super().__init__()
        self.ops: List[Dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._note(func, args, kwargs)
        return out

    def _note(self, func, args, kwargs) -> None:
        name = func._schema.name.split("::")[-1]
        kind, result = _C10D.get(name, (name, None))
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        ts = _tensors(named.get(result)) if result else []
        pg = named.get("process_group")
        if isinstance(pg, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(pg)
        ranks = tuple(dist.get_process_group_ranks(pg)) if pg is not None \
            else ()
        shape = tuple(ts[0].shape) if len(ts) == 1 else \
            [tuple(t.shape) for t in ts]
        self.ops.append({
            "kind": kind,
            "dtype": _DTYPE_NAMES.get(ts[0].dtype, str(ts[0].dtype))
            if ts else "",
            "shape": shape,
            "bytes": sum(t.numel() * t.element_size() for t in ts),
            "group": len(ranks) or 1,
            "ranks": ranks,
            "site": _call_site(),
        })


def _operand_and_ring(op) -> tuple:
    """(operand bytes, ring bytes) of one op, from its result: the JAX
    package's rules. Operand: the result for all-reduce / all-to-all /
    permute, result / g for all-gather, result · g for reduce-scatter.
    Ring (what a link carries per device): AR = 2·P·(g-1)/g, RS / A2A =
    P·(g-1)/g (P = full operand), AG = R·(g-1)/g (R = gathered result),
    CP = P."""
    kind, rbytes, g = op["kind"], op["bytes"], op["group"]
    if kind == "all-gather":
        obytes = rbytes // max(g, 1)
    elif kind == "reduce-scatter":
        obytes = rbytes * g
    else:
        obytes = rbytes
    f = (g - 1) / g if g > 1 else 0.0
    if kind == "all-reduce":
        rb = 2.0 * obytes * f
    elif kind in ("reduce-scatter", "all-to-all"):
        rb = obytes * f
    elif kind == "all-gather":
        rb = rbytes * f
    else:
        rb = obytes
    return obytes, rb


def _type(op) -> str:
    shape = op["shape"]
    if isinstance(shape, list):
        return "(" + ", ".join(f"{op['dtype']}[{','.join(map(str, s))}]"
                               for s in shape) + ")"
    return f"{op['dtype']}[{','.join(map(str, shape))}]"


def collective_bytes(record) -> Dict[str, object]:
    """Per-kind collective operand bytes of a ``CollectiveRecord`` (or its
    ``ops``), with ``count``, ``total``, ``ring_total`` (physical ring
    bytes a device sends) and ``ops_below_known_loops`` (0: an eager
    record holds every iteration)."""
    ops = getattr(record, "ops", record)
    out: Dict[str, object] = {k: 0 for k in COLLECTIVES}
    ring = 0.0
    n_ops = 0
    for op in ops:
        if op["kind"] not in COLLECTIVES:
            continue
        obytes, rb = _operand_and_ring(op)
        out[op["kind"]] += obytes
        ring += rb
        n_ops += 1
    out["count"] = n_ops
    out["ops_below_known_loops"] = 0
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["ring_total"] = int(ring)
    return out


def collective_breakdown(record, top: int = 12) -> List[Dict]:
    """Top collective contributors grouped by (kind, result type, call
    site, group size): {"kind", "type", "site", "group", "count",
    "bytes"} (operand bytes), largest first."""
    agg: Dict[tuple, Dict] = {}
    for op in getattr(record, "ops", record):
        if op["kind"] not in COLLECTIVES:
            continue
        t = _type(op)[:60]
        key = (op["kind"], t, op["site"], op["group"])
        e = agg.setdefault(key, {"kind": op["kind"], "type": t,
                                 "site": op["site"], "group": op["group"],
                                 "count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += _operand_and_ring(op)[0]
    return sorted(agg.values(), key=lambda e: -e["bytes"])[:top]


def collective_seconds(record, hw: Hardware = H100_SXM) -> tuple:
    """(operand seconds, ring seconds) of a record: each op's bytes over
    the rate of the slowest link its group crosses."""
    op_s = ring_s = 0.0
    for op in getattr(record, "ops", record):
        if op["kind"] not in COLLECTIVES:
            continue
        bw = hw.link_bw(op["ranks"] or (0,))
        obytes, rb = _operand_and_ring(op)
        op_s += obytes / bw
        ring_s += rb / bw
    return op_s, ring_s


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_total: float, n_chips: int,
                   int8_fraction: float = 0.0,
                   ring_total: float = None, *, hw: Hardware = H100_SXM,
                   record=None) -> Dict[str, float]:
    """Three-term roofline (seconds per step, per chip) on ``hw``.

    collective_s follows the operand-sum convention; collective_ring_s
    additionally reports physical ring traffic (what a link carries: AR
    counts 2(g-1)/g etc). With ``record`` (a ``CollectiveRecord`` or its
    ops) each op's bytes go over the rate of the slowest link its group
    crosses (``collective_seconds``); without it, ``coll_total`` and
    ``ring_total`` go over the slowest link of a group of ``n_chips``
    ranks."""
    compute_s = flops_per_dev / hw.peak_flops_bf16
    compute_s_int8 = (flops_per_dev * (1 - int8_fraction) / hw.peak_flops_bf16
                      + flops_per_dev * int8_fraction / hw.peak_ops_int8)
    memory_s = bytes_per_dev / hw.hbm_bw
    ring_s: Optional[float] = None
    if record is not None:
        collective_s, ring_s = collective_seconds(record, hw)
    else:
        bw = hw.link_bw(range(n_chips))
        collective_s = coll_total / bw
        if ring_total is not None:
            ring_s = ring_total / bw
    terms = {"compute_s": compute_s,
             "compute_s_int8path": compute_s_int8,
             "memory_s": memory_s,
             "collective_s": collective_s,
             "hlo_flops_per_device": flops_per_dev,
             "hlo_bytes_per_device": bytes_per_dev,
             "collective_bytes_per_device": float(coll_total),
             "n_chips": n_chips}
    if ring_s is not None:
        terms["collective_ring_s"] = ring_s
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(compute_s, memory_s, collective_s)
    terms["step_time_lower_bound_s"] = total
    terms["roofline_fraction_of_compute"] = (compute_s / total
                                             if total > 0 else 0.0)
    return terms


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful work" yardstick: 6·N·D train, 2·N_active·D infer)
# ---------------------------------------------------------------------------
def model_flops(cfg, shape) -> float:
    n_active = active_params(cfg)
    n_tokens = shape.global_batch * (shape.seq_len
                                     if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * n_tokens


def total_params(cfg) -> float:
    return _params(cfg, active_only=False)


def active_params(cfg) -> float:
    return _params(cfg, active_only=True)


def _params(cfg, active_only: bool) -> float:
    from repro_torch.models import block_roles
    D, hd = cfg.d_model, cfg.head_dim_
    hp, kvp = cfg.heads_padded(), cfg.kv_heads_padded()
    per_group = 0.0
    for role in block_roles(cfg):
        if role["mixer"] == "mamba":
            DI, N, R = cfg.d_inner_, cfg.ssm_state, cfg.dt_rank_
            per_group += D * DI * 2 + DI * (R + 2 * N) + R * DI + DI * D \
                + DI * (N + cfg.conv_width + 2)
        else:
            per_group += D * hp * hd + 2 * D * kvp * hd + hp * hd * D
        if role["ffn"] is None:
            continue
        if "moe" in role["ffn"]:
            e = cfg.top_k if active_only else cfg.n_experts
            per_group += 3 * D * cfg.d_ff * e + D * cfg.n_experts
        if "dense" in role["ffn"]:
            per_group += 3 * D * cfg.dense_ff_
    n = per_group * cfg.n_groups
    n += 2 * cfg.vocab_padded * D        # embed + head
    return n
