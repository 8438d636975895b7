"""Paged attention over a block-table KV pool, pages read in place.

The counterparts of the JAX package's ``kernels/paged_attention.py``:

  * ``paged_flash_decode`` -- one new token per lane over its block-table
    pages. CPU tensors run ``paged_flash_decode_plain`` (gather the lane's
    table into a contiguous window, int8 rows dequantised to fp32, masked
    softmax in fp32); CUDA tensors launch the route of
    ``csrc/paged_flash_decode.cu`` that ``decode_route`` names (the scores
    on the tensor cores for bf16 q over bf16 or int8 pools with pages TMA
    can box, the CUDA-core kernel for the rest), or raise. Both stream pages
    through an online softmax split over the page range (the tensor-core
    route over ``decode_shares`` of the live window), so their reduction
    order differs from the plain version's: they agree to a tolerance, not
    bit for bit.
  * ``paged_prefix_attention`` -- the prefix-cache tail prefill: the tail's
    queries over [the cached prefix's pool pages ; the tail's own K/V].
    CPU tensors run ``paged_prefix_attention_plain`` (the JAX package's
    parity oracle: ``gather_prefix_rows`` + ``flash_attention_abs``); CUDA
    tensors launch the route of ``csrc/paged_prefix_attention.cu`` that
    ``prefix_route`` names (``wgmma`` for bf16 q over bf16 or int8 pools
    with pages TMA can box, the CUDA-core kernel for the rest), or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import build

#: head dims every kernel here (both routes of each) is built for
_HEAD_DIMS = (64, 128, 256)
#: head dims the CUDA-core kernels are also built for (the smoke configs'
#: 16; lanes past hd hold nothing)
_CC_HEAD_DIMS = (16,) + _HEAD_DIMS
_GROUP_SIZES = (1, 2, 4, 6, 8)


def _dequant(x, scale):
    """int8 rows -> fp32 * their per-row scale; other dtypes -> fp32 (the
    JAX kernels' ``_dequant``)."""
    if x.dtype == torch.int8:
        return x.to(torch.float32) * scale[..., None]
    return x.to(torch.float32)


def _check_scales(k_pool, v_pool, k_scale, v_scale, who: str):
    """int8 pools need (n_pages, page, KV) fp32 scales; others take none."""
    quant = k_pool.dtype == torch.int8
    if (v_pool.dtype == torch.int8) != quant:
        raise TypeError(f"{who}: k and v pools differ in dtype "
                        f"({k_pool.dtype}, {v_pool.dtype})")
    if not quant:
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"{who}: scales given for a {k_pool.dtype} pool")
        return False
    if k_scale is None or v_scale is None:
        raise ValueError(f"{who}: int8 pools need k_scale and v_scale")
    want = tuple(k_pool.shape[:3])
    for sc in (k_scale, v_scale):
        if tuple(sc.shape) != want or sc.dtype != torch.float32:
            raise ValueError(f"{who}: scales must be fp32 {want}, got "
                             f"{sc.dtype} {tuple(sc.shape)}")
    return True


def paged_flash_decode_plain(q, k_pool, v_pool, block_table, pos,
                             k_scale=None, v_scale=None, *,
                             window: int = 0, softcap_val: float = 0.0):
    """Gather + masked softmax in fp32 (int8 rows dequantised to fp32).
    Shapes as ``paged_flash_decode``."""
    L, KV, R, hd = q.shape
    page = k_pool.shape[1]
    C = block_table.shape[1]
    bt = block_table.long()
    k = _dequant(k_pool[bt], None if k_scale is None else k_scale[bt])
    v = _dequant(v_pool[bt], None if v_scale is None else v_scale[bt])
    k = k.reshape(L, C * page, KV, hd)
    v = v.reshape(L, C * page, KV, hd)
    s = torch.einsum("lgrd,lcgd->lgrc", q.to(torch.float32), k) \
        * (1.0 / math.sqrt(hd))
    if softcap_val > 0:
        s = softcap_val * torch.tanh(s / softcap_val)
    kpos = torch.arange(C * page, device=q.device)
    p = pos.long()[:, None]
    valid = kpos[None, :] <= p
    if window > 0:
        valid &= kpos[None, :] > p - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    acc = torch.einsum("lgrc,lcgd->lgrd", e, v)
    return acc / torch.clamp(e.sum(dim=-1), min=1e-30)[..., None]


def decode_split(L: int, KV: int, C: int, sms: int) -> int:
    """Shares of each lane's pages, on both routes: as many as keep the
    (lane, KV head, share) blocks to one wave of two blocks on each of the
    card's ``sms`` SMs, at least one, and no more than the ``C`` pages of
    the table. (The CUDA-core kernel then rounds it to whole pages a share:
    ``_decode_launch``.)"""
    return max(1, min(C, 2 * sms // (L * KV)))


def decode_window(pos: int, page: int, C: int,
                  window: int) -> Tuple[int, int, int]:
    """(n_live, lo, hi) of one lane: its live pages are [0, n_live), and
    the rows valid for the token at ``pos`` are [lo, hi], none when lo >
    hi (the lane then averages every live row, as the reference does)."""
    n_live = max(0, min(C, (pos + page) // page))
    lo = max(0, pos - window + 1) if window > 0 else 0
    return n_live, lo, min(pos, n_live * page - 1)


def decode_shares(pos: int, page: int, C: int, window: int,
                  nsplit: int) -> List[Tuple[int, int]]:
    """The tensor-core route's shares of one lane, as page ranges [c0, c1)
    in split order: the window starts at page first = lo // page of
    ``decode_window``'s valid rows [lo, hi], or 0 when no row is valid;
    [first, n_live) splits evenly. The CUDA kernel (``tc::share``) is the
    same arithmetic, line for line."""
    n_live, lo, hi = decode_window(pos, page, C, window)
    first = lo // page if lo <= hi else 0
    n = n_live - first
    return [(first + z * n // nsplit, first + (z + 1) * n // nsplit)
            for z in range(nsplit)]


def decode_route(q: torch.Tensor, k_pool: torch.Tensor) -> str:
    """The kernel a CUDA launch takes: ``"tensor_cores"`` for bf16 q over
    bf16 or int8 pools at a head dim and group size the route is built for,
    whose page is a power of two of at least 8 rows (a ring stage holds 16
    key rows: two pages of 8, or one TMA box of 16 rows of a larger page),
    else ``"cuda_cores"`` (fp32, or other pages). A function of dtypes and
    shapes alone; the wrapper checks contiguity and alignment before it
    asks."""
    R, hd = q.shape[-2:]
    page = k_pool.shape[1]
    if (q.dtype == torch.bfloat16
            and k_pool.dtype in (torch.bfloat16, torch.int8)
            and hd in _HEAD_DIMS and R in _GROUP_SIZES
            and page >= 8 and page & (page - 1) == 0):
        return "tensor_cores"
    return "cuda_cores"


class DecodePlan(NamedTuple):
    """One tensor-core instance's ring stages, dynamic shared bytes and
    threads a block, as ``csrc/paged_flash_decode.cu`` builds it."""
    stages: int
    smem: int
    threads: int


def decode_tc_plan(hd: int, R: int, quant: bool, KV: int) -> DecodePlan:
    """The tensor-core route's plan at head dim ``hd``, group size ``R``,
    an int8 (``quant``) or bf16 pool and ``KV`` heads, read from the
    library."""
    out = (ctypes.c_int * 3)()
    rc = build.library("paged_flash_decode").paged_flash_decode_tc_plan(
        hd, R, int(quant), KV, out)
    build.check("paged_flash_decode", "paged_flash_decode", rc)
    return DecodePlan(*out)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(dev: torch.device) -> int:
    """The SMs a launch on ``dev`` plans for (``build.H100_SMS`` for a
    traced one)."""
    return _sm_count(dev.index) if dev.type == "cuda" else build.H100_SMS


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 tickets for the tensor-core route's last-block
    merge on ``stream``: zero when made, and every launch leaves them zero
    (each lane's last block resets its own). One set a stream, so launches
    on two streams never share one."""
    t = _TICKETS.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 256),), dtype=torch.int32, device=dev)
        _TICKETS[(dev.index, stream)] = t
    return t


def _decode_launch(route: str, q, k_pool, v_pool, block_table, pos, k_scale,
                   v_scale, *, window: int, softcap_val: float,
                   nsplit: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel of ``route`` on checked CUDA operands (a traced
    launch allocates the same buffers and returns); counts nothing. The
    wrapper calls it with ``decode_route``'s answer and the
    shares of ``decode_split`` at the device's SM count (at the unsharded
    KV head count under a serve mesh: ``plan_kv``). ``nsplit`` is also a
    measurement hook: a measurement may time a route with another number
    of shares, or the CUDA-core kernel on bf16."""
    L, KV, R, hd = q.shape
    n_pages, page = k_pool.shape[:2]
    C = block_table.shape[1]
    quant = k_pool.dtype == torch.int8
    dev = q.device
    if nsplit is None:
        nsplit = decode_split(L, KV, C, _sms(dev))
    out = torch.empty((L, KV, R, hd), dtype=torch.float32, device=dev)
    part_m = part_l = part_ml = part_acc = None
    if route == "tensor_cores":
        if nsplit > 1:
            part_ml = torch.empty((L, KV, nsplit, R, 2), dtype=torch.float32,
                                  device=dev)
            part_acc = torch.empty((L, KV, nsplit, R, hd),
                                   dtype=torch.float32, device=dev)
    else:
        pps = -(-C // nsplit)          # whole pages a share
        nsplit = -(-C // pps)
        part_m = torch.empty((L, KV, nsplit, R), dtype=torch.float32,
                             device=dev)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((L, KV, nsplit, R, hd), dtype=torch.float32,
                               device=dev)
    if build.traced(q):
        return out
    lib = build.library("paged_flash_decode")
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        scales = (k_scale.data_ptr() if quant else None,
                  v_scale.data_ptr() if quant else None)
        if route == "tensor_cores":
            tickets = _tickets(dev, stream.value, L * KV) if nsplit > 1 \
                else None
            rc = lib.paged_flash_decode_tc(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
                block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (part_ml, part_acc, tickets)),
                int(quant), n_pages, L, KV, R, hd, page, C, nsplit, int(window),
                float(softcap_val), 1.0 / math.sqrt(hd), stream)
        else:
            rc = lib.paged_flash_decode(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
                int(q.dtype == torch.bfloat16), int(quant),
                block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), L,
                KV, R, hd, page, C, nsplit, pps, int(window),
                float(softcap_val), 1.0 / math.sqrt(hd), stream)
    build.check("paged_flash_decode", "paged_flash_decode", rc)
    return out


def paged_flash_decode(q, k_pool, v_pool, block_table, pos,
                       k_scale=None, v_scale=None, *,
                       window: int = 0, softcap_val: float = 0.0,
                       plan_kv: Optional[int] = None):
    """Flash-decode over a paged pool, pages read in place per lane.

    q: (L, KV, R, hd) grouped queries; k_pool/v_pool: (n_pages, page, KV,
    hd) in q's dtype, or int8 with k_scale/v_scale (n_pages, page, KV) fp32
    per-(token, head) scales; block_table: (L, C) int32 lane-logical page
    -> physical page; pos: (L,) int32 positions (new token already written
    at pos). Returns (L, KV, R, hd) fp32. CUDA tensors launch the kernel
    ``decode_route`` names. ``paged_flash_decode.launches`` counts kernel
    launches, ``.tc_launches`` and ``.cc_launches`` those of the
    tensor-core and CUDA-core routes; a traced launch (``build.traced``)
    allocates the output and the split buffers and counts
    ``.fake_launches``.

    ``plan_kv``: split each lane's pages into the shares ``decode_split``
    gives ``plan_kv`` KV heads. A serve-mesh rank holding a head slice
    passes the unsharded count, so each head merges the shares of the
    unsharded launch, in its order.
    """
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged decode shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    L, KV, R, hd = q.shape
    n_pages, page, kvp, hdp = k_pool.shape
    if (kvp, hdp) != (KV, hd) or block_table.dim() != 2 \
            or block_table.shape[0] != L or tuple(pos.shape) != (L,):
        raise ValueError(f"paged decode shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, block_table "
                         f"{tuple(block_table.shape)}, pos {tuple(pos.shape)}")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("block_table and pos must be int32")
    quant = _check_scales(k_pool, v_pool, k_scale, v_scale, "paged decode")
    tensors = (q, k_pool, v_pool, block_table, pos) \
        + ((k_scale, v_scale) if quant else ())
    if all(t.device.type == "cpu" for t in tensors):
        return paged_flash_decode_plain(q, k_pool, v_pool, block_table, pos,
                                        k_scale, v_scale, window=window,
                                        softcap_val=softcap_val)
    if not all(build.on_card(t) and t.device == q.device for t in tensors):
        raise ValueError("paged decode operands must all lie on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or (
            not quant and (k_pool.dtype != q.dtype or v_pool.dtype != q.dtype)):
        raise TypeError(f"paged decode takes bf16 or fp32 q and pools of the "
                        f"same dtype or int8, got {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}")
    if hd not in _CC_HEAD_DIMS or R not in _GROUP_SIZES:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{_CC_HEAD_DIMS} (the tensor-core route "
                         f"{_HEAD_DIMS}) and group size in {_GROUP_SIZES}, "
                         f"got {hd}, {R}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode operands must be contiguous")
    route = decode_route(q, k_pool)
    # the CUDA-core kernel reads q and pool rows by vector loads of up to 16
    # bytes (hd / 32 elements a lane, one at hd 16, .cu load_row); the
    # tensor-core route asks it of every operand (TMA boxes of the pools,
    # bulk copies of the scales)
    if any(build.address(t) % 16 for t in
           (tensors if route == "tensor_cores" else (q, k_pool, v_pool))):
        raise ValueError(f"paged decode on the {route} route takes "
                         "16-byte-aligned operands")
    nsplit = None if plan_kv is None else decode_split(
        L, plan_kv, block_table.shape[1], _sms(q.device))
    out = _decode_launch(route, q, k_pool, v_pool, block_table, pos, k_scale,
                         v_scale, window=window, softcap_val=softcap_val,
                         nsplit=nsplit)
    if build.traced(*tensors):
        paged_flash_decode.fake_launches += 1
        return out
    paged_flash_decode.launches += 1
    if route == "tensor_cores":
        paged_flash_decode.tc_launches += 1
    else:
        paged_flash_decode.cc_launches += 1
    return out


paged_flash_decode.launches = 0
paged_flash_decode.tc_launches = 0
paged_flash_decode.cc_launches = 0
paged_flash_decode.fake_launches = 0


# ---------------------------------------------------------------------------
# Prefix-cache tail prefill: tail queries over [prefix pages ; tail K/V]
# ---------------------------------------------------------------------------
def gather_prefix_rows(pool, page_ids, scale=None):
    """The rows of pages ``page_ids`` of one pool leaf, in page order, in
    fp32 (int8 rows times their per-row ``scale``): pool (..., n_pages,
    page, KV, hd) -> (..., npp * page, KV, hd). Entries past the live pages
    may be the garbage page 0; the caller masks its rows."""
    idx = page_ids.to(device=pool.device, dtype=torch.long)
    g = _dequant(pool.index_select(-4, idx),
                 None if scale is None else scale.index_select(-3, idx))
    return g.reshape(g.shape[:-4] + (-1,) + g.shape[-2:])


def flash_attention_abs(q, k, v, q_pos, k_pos, k_valid, *, window: int = 0,
                        softcap_val: float = 0.0, chunk: int = 1024,
                        out_dtype=None):
    """Online-softmax attention with EXPLICIT absolute positions.

    The prefix-cache tail prefill attends queries at absolute positions
    ``q_pos`` over keys at ``k_pos`` (the cached prefix's rows, then the
    tail's own), so masking is ``k_valid & (k_pos <= q_pos)`` (& the sliding
    window) in position space. q: (B, T, H, hd); k/v: (B, K, H, hd) (kv
    already group-broadcast); q_pos (T,), k_pos (K,) int; k_valid (K,) bool.
    Scans KV in ``chunk``-row chunks: scores fp32, the probabilities cast to
    v's dtype before the value product, as in the JAX package. Returns
    (B, T, H, hd) in ``out_dtype`` (default q's dtype).
    """
    B, T, H, hd = q.shape
    K = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    ck = min(chunk, K)
    qt = q.transpose(1, 2).to(torch.float32)            # (B, H, T, hd)
    m = torch.full((B, H, T), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, T, hd), device=q.device)
    for c0 in range(0, K, ck):
        c1 = min(K, c0 + ck)
        kc = k[:, c0:c1].transpose(1, 2).to(torch.float32)
        vc = v[:, c0:c1].transpose(1, 2)
        s = torch.matmul(qt, kc.transpose(-1, -2)) * scale
        if softcap_val > 0:
            s = softcap_val * torch.tanh(s / softcap_val)
        kpos = k_pos[c0:c1]
        valid = k_valid[None, c0:c1] & (kpos[None, :] <= q_pos[:, None])
        if window > 0:
            valid &= q_pos[:, None] - kpos[None, :] < window
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.to(vc.dtype).to(torch.float32), vc.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(out_dtype or q.dtype)


def paged_prefix_attention_plain(q, k_tail, v_tail, k_pool, v_pool, page_ids,
                                 offset, prefix_len, length, k_scale=None,
                                 v_scale=None, *, n_rep: int, window: int = 0,
                                 softcap_val: float = 0.0, chunk: int = 1024):
    """The JAX package's parity oracle of the kernel: gather the prefix rows
    out of the pool (``gather_prefix_rows``: int8 -> fp32 * scale), cast
    them to the tail's dtype, and run ``flash_attention_abs`` over [prefix ;
    tail] with absolute positions. Shapes as ``paged_prefix_attention``;
    returns (H, T, hd) fp32."""
    S = k_tail.shape[0]
    P = page_ids.shape[0] * k_pool.shape[1]
    dt = k_tail.dtype
    k = torch.cat([gather_prefix_rows(k_pool, page_ids, k_scale).to(dt),
                   k_tail])
    v = torch.cat([gather_prefix_rows(v_pool, page_ids, v_scale).to(dt),
                   v_tail])
    dev = q.device
    positions = torch.arange(S, dtype=torch.int32, device=dev) + int(offset)
    k_pos = torch.cat([torch.arange(P, dtype=torch.int32, device=dev),
                       positions])
    k_valid = torch.cat([torch.arange(P, device=dev) < int(prefix_len),
                         torch.arange(S, device=dev) < int(length)])
    # the GQA broadcast: q head h reads KV head h // n_rep
    out = flash_attention_abs(
        q.transpose(0, 1)[None], k.repeat_interleave(n_rep, dim=1)[None],
        v.repeat_interleave(n_rep, dim=1)[None], positions[:q.shape[1]],
        k_pos, k_valid, window=window, softcap_val=softcap_val, chunk=chunk,
        out_dtype=torch.float32)
    return out[0].transpose(0, 1)


def prefix_route(q: torch.Tensor, k_pool: torch.Tensor) -> str:
    """The kernel a CUDA launch takes: ``"tensor_cores"`` for bf16 q (and
    tail) at a head dim the routes are built for, over pools whose page is
    a power of two of at least 8 rows (one TMA box a page, each box on a
    whole 1,024-byte swizzle period), else ``"cuda_cores"`` (fp32, or other
    pages). A function of dtype, head dim and page size alone; both routes
    take only contiguous, 16-byte-aligned operands, which the wrapper
    checks before it asks."""
    page = k_pool.shape[1]
    if (q.dtype == torch.bfloat16 and q.shape[-1] in _HEAD_DIMS
            and page >= 8 and page & (page - 1) == 0):
        return "tensor_cores"
    return "cuda_cores"


class AttentionTiles(NamedTuple):
    """The attention kernels' tensor-core tiles: query rows a block, key
    rows a tile, and by head dim the ring's stages and its dynamic shared
    bytes."""
    bq: int
    bk: int
    stages: Dict[int, int]
    smem: Dict[int, int]


@functools.lru_cache(maxsize=None)
def attention_tc_tiles(name: str = "paged_prefix_attention") -> AttentionTiles:
    """The tiles as ``csrc/attention_tc.cuh`` builds them (its one source),
    read from library ``name`` (``flash_attention`` or
    ``paged_prefix_attention``, which both build it)."""
    out = (ctypes.c_int * 11)()
    n = getattr(build.library(name), f"{name}_tc_tiles")(out)
    rows = [tuple(out[2 + 3 * i:5 + 3 * i]) for i in range(n)]
    return AttentionTiles(out[0], out[1], {r[0]: r[1] for r in rows},
                          {r[0]: r[2] for r in rows})


@functools.lru_cache(maxsize=None)
def attention_source_tiles() -> AttentionTiles:
    """The tiles as ``csrc/attention_tc.cuh`` writes them (``BQ``, ``BK``),
    read from its text: what a traced launch (``build.traced``) plans
    with, where no library is built. The stages and shared bytes by head
    dim are the libraries', and left empty."""
    (bq,), (bk,) = (build.source_ints("attention_tc.cuh", n)
                    for n in ("BQ", "BK"))
    return AttentionTiles(bq, bk, {}, {})


def prefix_split(H: int, T: int, KV: int, n_tiles: int, bq: int,
                 sms: int) -> int:
    """Shares of the key window for the tensor-core route: its blocks --
    (n_rep * T) / ``bq`` query tiles of each KV head -- times the shares
    fill one wave of the card's ``sms`` SMs at one block an SM, each share
    at least two of the ``n_tiles`` key tiles."""
    blocks = -(-(H // KV) * T // bq) * KV
    return max(1, min(sms // blocks, n_tiles // 2))


def _prefix_launch(route: str, q, k_tail, v_tail, k_pool, v_pool, page_ids,
                   offset: int, prefix_len: int, length: int, k_scale,
                   v_scale, *, n_rep: int, window: int, softcap_val: float,
                   nsplit: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel of ``route`` on checked CUDA operands (a traced
    launch allocates the same buffers and returns); counts nothing. The
    wrapper calls it with ``prefix_route``'s answer, and the
    tensor-core route takes its shares from ``prefix_split``. ``nsplit``
    is a measurement hook that the serving path never passes: a
    measurement may time the tensor-core route with another number of
    shares, or the CUDA-core kernel on bf16."""
    H, T, hd = q.shape
    S, KV = k_tail.shape[:2]
    n_pages, page = k_pool.shape[:2]
    quant = k_pool.dtype == torch.int8
    traced = build.traced(q)
    out = torch.empty((H, T, hd), dtype=torch.float32, device=q.device)
    part_o = part_ml = None
    if route == "tensor_cores":
        if nsplit is None:
            tiles = attention_source_tiles() if traced \
                else attention_tc_tiles()
            n_live = min(page_ids.shape[0], -(-prefix_len // page))
            n_tiles = -(-n_live * page // tiles.bk) + -(-S // tiles.bk)
            nsplit = prefix_split(H, T, KV, n_tiles, tiles.bq, _sms(q.device))
        if nsplit > 1:
            part_o = torch.empty((nsplit, H * T, hd), dtype=torch.float32,
                                 device=q.device)
            part_ml = torch.empty((nsplit, H * T, 2), dtype=torch.float32,
                                  device=q.device)
    if traced:
        return out
    lib = build.library("paged_prefix_attention")
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        ptrs = (q.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None, page_ids.data_ptr(),
                out.data_ptr())
        rest = (H, T, S, KV, hd, n_rep, page, page_ids.shape[0], offset,
                prefix_len, length, int(window), float(softcap_val),
                1.0 / math.sqrt(hd), stream)
        if route == "tensor_cores":
            rc = lib.paged_prefix_attention_tc(
                *ptrs, None if part_o is None else part_o.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(), int(quant),
                n_pages, nsplit, *rest)
        else:
            rc = lib.paged_prefix_attention(
                *ptrs, int(q.dtype == torch.bfloat16), int(quant), *rest)
    build.check("paged_prefix_attention", "paged_prefix_attention", rc)
    return out


def paged_prefix_attention(q, k_tail, v_tail, k_pool, v_pool, page_ids,
                           offset: int, prefix_len: int, length: int,
                           k_scale=None, v_scale=None, *, n_rep: int,
                           window: int = 0, softcap_val: float = 0.0,
                           chunk: int = 1024):
    """Tail-prefill attention over in-place prefix pages + the tail's K/V.

    q: (H, T, hd) tail queries, H = KV * n_rep (GQA broadcast order);
    k_tail/v_tail: (S, KV, hd) the tail's own rows (S >= T) in q's dtype;
    k_pool/v_pool: (n_pages, page, KV, hd) pool blocks in q's dtype, or int8
    with k_scale/v_scale (n_pages, page, KV) fp32; page_ids: (npp,) int32
    physical pages of the cached prefix (entries past the live ones may be
    the garbage page 0, never read); offset: absolute position of tail row
    0; prefix_len / length: live prefix rows / true tail rows; ``chunk``:
    the key rows of one online-softmax step of the plain version (the
    model's ``attn_chunk``; the kernels stream 64- or 32-row tiles).
    Returns (H, T, hd) fp32. CUDA tensors launch the kernel
    ``prefix_route`` names. ``paged_prefix_attention.launches`` counts
    kernel launches, ``.tc_launches`` and ``.cc_launches`` those of the
    tensor-core and CUDA-core kernels; a traced launch (``build.traced``)
    allocates the output and the split buffers and counts
    ``.fake_launches``.
    """
    if q.dim() != 3 or k_tail.dim() != 3 or k_pool.dim() != 4 \
            or k_tail.shape != v_tail.shape or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged prefix shapes: q {tuple(q.shape)}, tail "
                         f"{tuple(k_tail.shape)} / {tuple(v_tail.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    H, T, hd = q.shape
    S, KV, hdt = k_tail.shape
    n_pages, page, kvp, hdp = k_pool.shape
    if (hdt, hdp, kvp) != (hd, hd, KV) or H != KV * n_rep or T > S \
            or page_ids.dim() != 1:
        raise ValueError(f"paged prefix shapes: q {tuple(q.shape)}, tail "
                         f"{tuple(k_tail.shape)}, pools {tuple(k_pool.shape)}, "
                         f"page_ids {tuple(page_ids.shape)}, n_rep {n_rep}")
    if page_ids.dtype != torch.int32:
        raise TypeError("page_ids must be int32")
    quant = _check_scales(k_pool, v_pool, k_scale, v_scale, "paged prefix")
    offset, prefix_len, length = int(offset), int(prefix_len), int(length)
    if not (0 <= prefix_len <= page_ids.shape[0] * page and 0 <= length <= S):
        raise ValueError(f"paged prefix bounds: prefix_len {prefix_len} over "
                         f"{page_ids.shape[0]} pages of {page}, length {length} "
                         f"over {S} tail rows")
    tensors = (q, k_tail, v_tail, k_pool, v_pool, page_ids) \
        + ((k_scale, v_scale) if quant else ())
    if all(t.device.type == "cpu" for t in tensors):
        return paged_prefix_attention_plain(
            q, k_tail, v_tail, k_pool, v_pool, page_ids, offset, prefix_len,
            length, k_scale, v_scale, n_rep=n_rep, window=window,
            softcap_val=softcap_val, chunk=chunk)
    if not all(build.on_card(t) and t.device == q.device for t in tensors):
        raise ValueError("paged prefix operands must all lie on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_tail.dtype != q.dtype or v_tail.dtype != q.dtype \
            or (not quant and k_pool.dtype != q.dtype):
        raise TypeError(f"paged prefix takes bf16 or fp32 q and tail, pools of "
                        f"their dtype or int8, got {q.dtype}/{k_tail.dtype}/"
                        f"{k_pool.dtype}")
    if hd not in _CC_HEAD_DIMS:
        raise ValueError(f"paged prefix kernel takes head_dim in "
                         f"{_CC_HEAD_DIMS} (the tensor-core route "
                         f"{_HEAD_DIMS}), got {hd}")
    if not all(t.is_contiguous() and build.address(t) % 16 == 0
               for t in tensors):
        raise ValueError("paged prefix operands must be contiguous and "
                         "16-byte aligned")
    route = prefix_route(q, k_pool)
    out = _prefix_launch(route, q, k_tail, v_tail, k_pool, v_pool, page_ids,
                         offset, prefix_len, length, k_scale, v_scale,
                         n_rep=n_rep, window=window, softcap_val=softcap_val)
    if build.traced(*tensors):
        paged_prefix_attention.fake_launches += 1
        return out
    paged_prefix_attention.launches += 1
    if route == "tensor_cores":
        paged_prefix_attention.tc_launches += 1
    else:
        paged_prefix_attention.cc_launches += 1
    return out


paged_prefix_attention.launches = 0
paged_prefix_attention.tc_launches = 0
paged_prefix_attention.cc_launches = 0
paged_prefix_attention.fake_launches = 0
