"""Causal flash attention over (BH, S, hd): the prefill kernel.

The counterpart of the JAX package's ``kernels/flash_attention.py::
flash_attention_tpu``, at the call site of the reference model's cold
prefill, which runs ``models/attention.py::flash_attention``: the scale
after the dot, and the probabilities cast to v's dtype before the value
product. CPU tensors run ``flash_attention_plain``, that function step by
step; CUDA tensors launch the route of ``csrc/flash_attention.cu`` that
``flash_route`` names, or raise:

  * ``"tensor_cores"`` -- bf16: ``wgmma`` for Q·Kᵀ and P·V, p rounded to
    bf16 as the reference model rounds it;
  * ``"cuda_cores"`` -- fp32: the TPU kernel's arithmetic (p kept in fp32,
    which for fp32 inputs is the same function: the cast is a no-op).

The kernel has no backward (nor has the TPU kernel), so the wrapper refuses
inputs that require grad: training attention keeps the plain chunked
``models.attention.flash_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

#: the CUDA-core kernel's query and key tiles; the plain version walks the
#: same
BLOCK_Q, BLOCK_K = 64, 32
#: head dims both routes are built for
_HEAD_DIMS = (64, 128, 256)
#: head dims the CUDA-core kernel is also built for (the smoke configs'
#: 16; lanes past hd sit idle in its value product)
_CC_HEAD_DIMS = (16,) + _HEAD_DIMS


def _kv_rows(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(BH / n_rep, S, hd) -> (BH, S, hd): q row bh reads KV row bh // n_rep."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=0)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, n_rep: int = 1):
    """The kernel's function in fp32 steps: (BLOCK_Q, BLOCK_K) blocks, the
    block-level causal/window skip, the query scaled before the dot, the
    softcap, -1e30 masking, an online softmax whose p is summed into l in
    fp32 and cast to v's dtype for the value product (as the reference
    model's ``models/attention.py::flash_attention`` casts it: bf16 inputs
    give the tensor-core route's function; for fp32 inputs the cast is a
    no-op and this is the TPU kernel's order, p in fp32), and ``acc /
    max(l, 1e-30)`` in q's dtype."""
    BH, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(torch.float32) * scale
    kf = _kv_rows(k, n_rep).to(torch.float32)
    vf = _kv_rows(v, n_rep).to(torch.float32)
    pos = torch.arange(S, device=q.device)
    out = torch.empty((BH, S, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, BLOCK_Q):
        q1 = min(S, q0 + BLOCK_Q)
        qpos = pos[q0:q1, None]
        m = torch.full((BH, q1 - q0, 1), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((BH, q1 - q0, hd), device=q.device)
        for k0 in range(0, S, BLOCK_K):
            if causal and (k0 > q0 + BLOCK_Q - 1 or (
                    window > 0 and k0 + BLOCK_K - 1 < q0 - window + 1)):
                continue                        # wholly masked block
            k1 = min(S, k0 + BLOCK_K)
            kpos = pos[None, k0:k1]
            s = torch.matmul(qf[:, q0:q1], kf[:, k0:k1].transpose(1, 2))
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            valid = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                               device=q.device)
            if causal:
                valid &= qpos >= kpos
            if window > 0:
                valid &= qpos - kpos < window
            s = torch.where(valid, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(p.to(v.dtype).to(torch.float32),
                                            vf[:, k0:k1])
            m = m_new
        out[:, q0:q1] = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_route(q: torch.Tensor) -> str:
    """The kernel a CUDA launch takes: ``"tensor_cores"`` for bf16 q at a
    head dim the routes are built for, else ``"cuda_cores"`` (fp32, which
    the bf16 tensor cores would round). A function of dtype and head dim
    alone; both routes take only contiguous, 16-byte-aligned operands
    (TMA's bases and row strides), which the wrapper checks before it
    asks."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in _HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def _launch(route: str, q, k, v, *, causal: bool, window: int,
            softcap: float, n_rep: int) -> torch.Tensor:
    """Launch the kernel of ``route`` on checked CUDA operands; counts
    nothing. The wrapper calls it with ``flash_route``'s answer; a
    measurement may call it to time the CUDA-core kernel on bf16."""
    BH, S, hd = q.shape
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        args = (BH, S, hd, n_rep, int(causal), int(window), float(softcap),
                1.0 / math.sqrt(hd), stream)
        if route == "tensor_cores":
            rc = lib.flash_attention_tc(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), out.data_ptr(), *args)
        else:
            rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(),
                                         v.data_ptr(), out.data_ptr(),
                                         int(q.dtype == torch.bfloat16), *args)
    build.check("flash_attention", "flash_attention", rc)
    return out


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, n_rep: int = 1):
    """Causal online-softmax attention without a materialised score matrix.

    q: (BH, S, hd); k, v: (BH / n_rep, S, hd), the q row bh reading KV row
    bh // n_rep (the GQA broadcast, for rows laid out (batch, head)).
    ``window`` > 0 limits attention to the last ``window`` positions;
    ``softcap`` > 0 applies the tanh logit cap. Returns (BH, S, hd) in q's
    dtype. CUDA tensors launch the kernel ``flash_route`` names.
    ``flash_attention_fwd.launches`` counts kernel launches, ``.tc_launches``
    and ``.cc_launches`` those of the tensor-core and CUDA-core kernels; a
    traced launch (``build.traced``) allocates the output and counts
    ``.fake_launches``.
    """
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or n_rep < 1 \
            or q.shape[0] != k.shape[0] * n_rep or q.shape[1:] != k.shape[1:]:
        raise ValueError(f"flash attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, n_rep {n_rep}")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention_fwd has no backward: an input "
                         "requires grad (training attention runs the plain "
                         "chunked flash_attention)")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes bf16 or fp32 q, k, v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, n_rep=n_rep)
    if not all(build.on_card(t) and t.device == q.device for t in tensors):
        raise ValueError("flash attention operands must all lie on one CUDA "
                         "device")
    hd = q.shape[2]
    if hd not in _CC_HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{_CC_HEAD_DIMS} (the tensor-core route "
                         f"{_HEAD_DIMS}), got {hd}")
    if not all(t.is_contiguous() and build.address(t) % 16 == 0
               for t in tensors):
        raise ValueError("flash attention operands must be contiguous and "
                         "16-byte aligned")
    route = flash_route(q)
    if build.traced(*tensors):
        flash_attention_fwd.fake_launches += 1
        return torch.empty_like(q)          # what _launch allocates
    out = _launch(route, q, k, v, causal=causal, window=window,
                  softcap=softcap, n_rep=n_rep)
    flash_attention_fwd.launches += 1
    if route == "tensor_cores":
        flash_attention_fwd.tc_launches += 1
    else:
        flash_attention_fwd.cc_launches += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0
flash_attention_fwd.cc_launches = 0
flash_attention_fwd.fake_launches = 0
