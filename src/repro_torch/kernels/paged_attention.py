"""Paged flash-decode: one new token per lane over its block-table pages.

The counterpart of the JAX package's ``kernels/paged_attention.py::
paged_flash_decode``. CPU tensors run ``paged_flash_decode_plain`` (gather
the lane's table into a contiguous window, masked softmax in fp32); CUDA
tensors launch ``csrc/paged_flash_decode.cu`` or raise. The kernel streams
pages through an online softmax split over the page range, so its
reduction order differs from the plain version's: the two agree to a
tolerance, not bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

# Fill the card: aim for this many (lane, KV head, split) blocks.
_TARGET_BLOCKS = 264
_HEAD_DIMS = (64, 128, 256)
_GROUP_SIZES = (1, 2, 4, 8)


def paged_flash_decode_plain(q, k_pool, v_pool, block_table, pos, *,
                             window: int = 0, softcap_val: float = 0.0):
    """Gather + masked softmax in fp32. Shapes as ``paged_flash_decode``."""
    L, KV, R, hd = q.shape
    page = k_pool.shape[1]
    C = block_table.shape[1]
    bt = block_table.long()
    k = k_pool[bt].reshape(L, C * page, KV, hd).to(torch.float32)
    v = v_pool[bt].reshape(L, C * page, KV, hd).to(torch.float32)
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


def decode_split(L: int, KV: int, C: int):
    """(nsplit, pages per split) for the CUDA kernel's page-range split."""
    nsplit = max(1, min(C, -(-_TARGET_BLOCKS // (L * KV))))
    pps = -(-C // nsplit)
    return -(-C // pps), pps


def paged_flash_decode(q, k_pool, v_pool, block_table, pos, *,
                       window: int = 0, softcap_val: float = 0.0):
    """Flash-decode over a paged pool, pages read in place per lane.

    q: (L, KV, R, hd) grouped queries; k_pool/v_pool: (n_pages, page, KV,
    hd) in q's dtype; block_table: (L, C) int32 lane-logical page ->
    physical page; pos: (L,) int32 positions (new token already written at
    pos). Returns (L, KV, R, hd) fp32. ``paged_flash_decode.launches``
    counts kernel launches.
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
    tensors = (q, k_pool, v_pool, block_table, pos)
    if all(t.device.type == "cpu" for t in tensors):
        if k_pool.dtype == torch.int8:
            raise NotImplementedError("int8 KV pools come with the kv-quant slice")
        return paged_flash_decode_plain(q, k_pool, v_pool, block_table, pos,
                                        window=window, softcap_val=softcap_val)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged decode operands must all lie on one CUDA device")
    if k_pool.dtype == torch.int8:
        raise NotImplementedError("int8 KV pools come with the kv-quant slice")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged decode takes bf16 or fp32 q and pools of the "
                        f"same dtype, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if hd not in _HEAD_DIMS or R not in _GROUP_SIZES:
        raise ValueError(f"paged decode kernel takes head_dim in {_HEAD_DIMS} "
                         f"and group size in {_GROUP_SIZES}, got {hd}, {R}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode operands must be contiguous")
    C = block_table.shape[1]
    nsplit, pps = decode_split(L, KV, C)
    dev = q.device
    out = torch.empty((L, KV, R, hd), dtype=torch.float32, device=dev)
    part_m = torch.empty((L, KV, nsplit, R), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((L, KV, nsplit, R, hd), dtype=torch.float32,
                           device=dev)
    lib = build.library("paged_flash_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_flash_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            int(q.dtype == torch.bfloat16), block_table.data_ptr(),
            pos.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), L, KV, R, hd, page, C,
            nsplit, pps, int(window), float(softcap_val),
            1.0 / math.sqrt(hd), ctypes.c_void_p(stream))
    build.check("paged_flash_decode", "paged_flash_decode", rc)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
