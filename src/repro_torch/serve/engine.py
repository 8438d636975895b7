"""Serving engine: packed Boolean weights and continuous batching over a
paged cache pool, on one device.

``ServeEngine.session`` is the traffic-shaped entry point (serve/session.py);
``generate_batch`` is a thin wrapper over it. With ``packed=True`` every
Boolean projection is bit-packed once at engine init (32 weights per int32
word; q/k/v and gate/up fused), and decode contractions stream the packed
words through the packed-XNOR GEMV kernel — under continuous batching ONCE
per step for the whole lane pool.

Entry points run on the card: ``device`` defaults to ``"cuda"`` and a host
without one raises instead of serving on the CPU. ``device="cpu"`` runs the
kernels' plain versions (the tests' setting).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import PackedBool, pack_boolean_weight
from repro_torch.models import (ModelConfig, cache_init, lm_decode_step_paged,
                                lm_prefill)

from .paged_cache import commit_prefill, paged_pool_init
from .scheduler import SamplingParams
from .session import ServeSession


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA on a host that has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions")
    return dev


def tree_to(tree, device):
    """Move every tensor / PackedBool leaf of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _fusable(*projs) -> bool:
    """Boolean bias-free proj dicts over the same input dim can fuse."""
    return all(isinstance(p, dict) and "b" not in p
               and isinstance(p.get("w"), torch.Tensor)
               and p["w"].dtype == torch.int8
               and p["w"].shape[:-1] == projs[0]["w"].shape[:-1]
               for p in projs)


def pack_weights(params):
    """Bit-pack every Boolean int8 projection leaf for serving.

    q/k/v (and FFN gate/up) projections sharing an input dim fuse into one
    packed leaf (``wqkv`` / ``wgu``, columns [q|k|v] and [g|u]), so a
    decode token makes one pass per block over activations and packed
    words. FP leaves (embed, head, norms, biases) pass through untouched.
    """
    def walk(node):
        if not isinstance(node, dict):
            return node
        node = dict(node)
        if {"wq", "wk", "wv"} <= node.keys() \
                and _fusable(node["wq"], node["wk"], node["wv"]):
            w = torch.cat([node.pop("wq")["w"], node.pop("wk")["w"],
                           node.pop("wv")["w"]], dim=-1)
            node["wqkv"] = {"w": pack_boolean_weight(w)}
        if {"wg", "wu"} <= node.keys() and _fusable(node["wg"], node["wu"]):
            w = torch.cat([node.pop("wg")["w"], node.pop("wu")["w"]], dim=-1)
            node["wgu"] = {"w": pack_boolean_weight(w)}
        out = {}
        for k, v in node.items():
            if k == "w" and isinstance(v, torch.Tensor) \
                    and v.dtype == torch.int8 and v.dim() >= 2:
                out[k] = pack_boolean_weight(v)
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def _count_packed(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_packed(v) for v in tree.values())
    return int(isinstance(tree, PackedBool))


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int,
                 packed: bool = False, device="cuda"):
        """``params``: the model tree (``lm_init`` or ``bridge.
        params_from_numpy``), moved to ``device``. ``packed=True`` packs the
        Boolean projections once, here."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.packed = packed
        params = tree_to(params, self.device)
        if packed:
            params = pack_weights(params)
            if _count_packed(params) == 0:
                raise ValueError(
                    "packed=True but no Boolean int8 projection leaves were "
                    "found to pack (FP baseline model?)")
        self.params = params

    def init_pool(self, n_pages: int, page_size: int):
        """A zeroed page pool for one session on the engine's device."""
        return paged_pool_init(self.cfg, n_pages, page_size, self.device)

    def prefill_commit(self, pool, prompt: np.ndarray, length: int,
                       page_ids: np.ndarray, page_size: int):
        """Batch-1 prefill of a bucket-padded prompt with its true
        ``length``, then the masked scatter of its K/V rows into the pool
        pages ``page_ids`` (entries past the request's pages point at the
        garbage page). Returns the (1, 1, Vp) fp32 last-position logits."""
        tokens = torch.from_numpy(prompt[None]).to(self.device)
        scratch = cache_init(self.cfg, 1, prompt.shape[0], self.device)
        logits, pcache = lm_prefill(self.cfg, self.params, {"tokens": tokens},
                                    cache=scratch, length=length)
        commit_prefill(self.cfg, pool, pcache["blocks"],
                       torch.from_numpy(page_ids), page_size, length=length)
        return logits

    def decode_step(self, cache, tokens):
        """One paged decode step over every lane (pool updated in place)."""
        return lm_decode_step_paged(self.cfg, self.params, cache, tokens)

    def session(self, *, lanes: int = 4, page_size: int = 16,
                n_pages: Optional[int] = None, segment: int = 1,
                buckets: Optional[Sequence[int]] = None) -> ServeSession:
        """Open a streaming serve session (serve/session.py)."""
        return ServeSession(self, lanes=lanes, page_size=page_size,
                            n_pages=n_pages, segment=segment, buckets=buckets)

    def generate_batch(self, prompts: Sequence,
                       n_tokens: Union[int, Sequence[int]], *,
                       lanes: int = 4, page_size: int = 16,
                       n_pages: Optional[int] = None, segment: int = 1):
        """Greedy continuous-batching generation: submit every request, run
        the session until idle, return a list of (n_tokens_i,) int32 arrays
        in request order."""
        n = len(prompts)
        n_tok = ([int(n_tokens)] * n if isinstance(n_tokens, int)
                 else [int(t) for t in n_tokens])
        if len(n_tok) != n:
            raise ValueError(f"{n} prompts but {len(n_tok)} n_tokens")
        with self.session(lanes=lanes, page_size=page_size, n_pages=n_pages,
                          segment=segment) as sess:
            handles = [sess.submit(p, SamplingParams(max_tokens=nt))
                       for p, nt in zip(prompts, n_tok)]
            sess.run_until_idle()
            return [h.result() for h in handles]
