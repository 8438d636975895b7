"""Serving engine: packed Boolean weights and continuous batching over a
paged cache pool, on one device or tensor-parallel over a serve mesh.

``ServeEngine.session`` is the traffic-shaped entry point (serve/session.py);
``generate_batch`` is a thin wrapper over it. ``generate`` and
``generate_eager`` serve one fixed batch over a contiguous cache (prefill,
then one decode step a token, greedy or on the batch-level random stream):
the JAX package's parity oracles, ``generate`` on a cache reused across
calls of one batch size (``CachePool``), ``generate_eager`` on a fresh one.
With ``packed=True`` every Boolean projection is bit-packed once at engine
init (32 weights per int32 word; q/k/v and gate/up fused where no bias
keeps them apart), and decode contractions stream the packed words through
the packed-XNOR GEMV kernel — under continuous batching ONCE per step for
the whole lane pool.

Entry points run on the card: ``device`` defaults to ``"cuda"`` and a host
without one raises instead of serving on the CPU. ``device="cpu"`` runs the
kernels' plain versions (the tests' setting).

``mesh=`` (``launch.mesh.make_serve_mesh``) serves tensor-parallel, one
process a shard, as the JAX package's mesh engine does: every rank builds
the engine from the same whole tree and keeps its slice
(``launch.shardings``: q/k/v columns, the fused wqkv packed shard-major;
the KV page pools on their KVp axis; the rest replicated). Rank 0 runs the
sessions; its device entries (``init_pool``, ``prefill_commit``,
``decode_segment`` and the pool's release) send each call to the other
ranks first, which run ``distributed.serve_worker.run(engine)`` until rank
0's ``close()`` (distributed/serve_worker.py).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import PackedBool
from repro_torch.distributed import serve_worker, serving
from repro_torch.kernels import pack_bits
from repro_torch.launch.shardings import serve_param_specs, shard_tree
from repro_torch.models import (ModelConfig, block_roles, cache_init,
                                lm_decode_step, lm_decode_step_paged,
                                lm_prefill)

from .paged_cache import CachePool, commit_prefill, paged_pool_init
from .sampling import sample_tokens
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


def _pack_stacked(ws) -> PackedBool:
    """Bit-pack the int8 ±1 leaves ``ws`` (one leading shape, one K),
    concatenated along their last axis, along K, one stacked group slice
    at a time: the words equal packing the whole concatenated leaf, and no
    temporary grows past one slice."""
    lead, K = tuple(ws[0].shape[:-2]), ws[0].shape[-2]
    N = sum(w.shape[-1] for w in ws)
    bits = torch.empty(lead + (-(-K // 32), N), dtype=torch.int32,
                       device=ws[0].device)
    for idx in np.ndindex(*lead):
        w = ws[0][idx] if len(ws) == 1 \
            else torch.cat([x[idx] for x in ws], dim=-1)
        bits[idx] = pack_bits(w, axis=-2)
    return PackedBool(bits, K)


def _is_bool_leaf(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dtype == torch.int8 \
        and v.dim() >= 2


def _shard_major(ws, tp: int):
    """The column blocks of ``ws`` in the order [q_0|k_0|v_0|q_1|...]: shard
    s's slice of every leaf, shard after shard (views, no copy)."""
    if tp == 1:
        return list(ws)
    return [w[..., s * (w.shape[-1] // tp):(s + 1) * (w.shape[-1] // tp)]
            for s in range(tp) for w in ws]


def pack_weights(params, *, tp: int = 1, consume: bool = False):
    """Bit-pack every Boolean int8 projection leaf for serving.

    q/k/v (and FFN gate/up) projections sharing an input dim fuse into one
    packed leaf (``wqkv`` / ``wgu``, columns [q|k|v] and [g|u]), so a
    decode token makes one pass per block over activations and packed
    words; a bias keeps its projection apart (the qwens' q/k/v). A mamba
    block's in_x and in_z stay apart, as the JAX package keeps them. FP
    leaves (embed, head, norms, biases, routers, the SSM parameters),
    packed leaves and MoE expert tensors (stacked arrays, not ``{"w": ...}``
    projections) pass through untouched. Each leaf packs one stacked group
    slice at a time.

    ``consume=True`` hands the tree over: each int8 leaf leaves ``params``
    (its dict is emptied as the walk goes) once it is packed, so its memory
    frees as soon as nothing else holds it, and the int8 tree and the
    packed one never live whole side by side.

    ``tp > 1`` (a serve mesh's engine) lays the fused wqkv columns out
    SHARD-MAJOR, [q_0|k_0|v_0 | q_1|k_1|v_1 | ...], so that shard s's
    contiguous column slice is its own [q_s|k_s|v_s] block; wgu and every
    other leaf pack as at ``tp == 1`` (they stay replicated).
    """
    def take(node, key):
        return node.pop(key) if consume else node[key]

    def walk(node):
        out = {}
        fused = {}
        if {"wq", "wk", "wv"} <= node.keys() \
                and _fusable(node["wq"], node["wk"], node["wv"]):
            fused["wqkv"] = ("wq", "wk", "wv")
        if {"wg", "wu"} <= node.keys() and _fusable(node["wg"], node["wu"]):
            fused["wgu"] = ("wg", "wu")
        parts = {k for ks in fused.values() for k in ks}
        for k in list(node):
            if k in parts:
                continue
            v = node[k]
            if k == "w" and _is_bool_leaf(v):
                out[k] = _pack_stacked([take(node, k)])
            elif isinstance(v, dict):
                out[k] = walk(v)
                if consume and not v:
                    del node[k]
            else:
                out[k] = v
        for name, ks in fused.items():
            ws = [take(node, k)["w"] for k in ks]
            out[name] = {"w": _pack_stacked(
                _shard_major(ws, tp) if name == "wqkv" else ws)}
        return out

    return walk(params)


def _count_packed(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_packed(v) for v in tree.values())
    return int(isinstance(tree, PackedBool))


class ShardDisagreement(RuntimeError):
    """The ranks of a serve mesh emitted different tokens in one segment."""


class _Pool(dict):
    """A session's pool tree; under a mesh, ``pid`` names it to the other
    ranks."""
    pid = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int,
                 packed: bool = False, prefix_cache: bool = False,
                 device="cuda", mesh=None):
        """``params``: the model tree (``lm_init``, ``bridge.
        params_from_numpy`` or ``pack_weights``' output), moved to
        ``device``. ``packed=True`` packs the Boolean projections once,
        here, dropping each int8 leaf of the engine's copy of the tree as
        it is packed (a caller that holds no other reference to the leaves,
        or that packed them with ``pack_weights(consume=True)`` first,
        never holds both trees whole). ``prefix_cache`` is the sessions'
        default for the radix prefix index (serve/prefix_cache.py).

        ``mesh``: a 1-D ("model",) serve mesh (``launch.mesh.
        make_serve_mesh``), on every rank; the engine serves on the mesh's
        device (``device`` must name its type) and keeps this rank's slice
        of the whole tree it is given, packed shard-major first. The
        session API is unchanged on rank 0; greedy streams are token-
        identical to the unsharded engine's (each head's and each column's
        arithmetic is the unsharded one), and a mesh of one is bitwise
        identical to it. The prefix cache, the host swap tier and the
        contiguous ``generate`` paths (at more than one shard) are refused
        under a mesh, as in the JAX package."""
        self.mesh = mesh
        self.tp = 1
        if mesh is not None:
            if tuple(mesh.axis_names) != ("model",):
                raise ValueError(
                    f"ServeEngine mesh must be 1-D ('model',) — got axes "
                    f"{tuple(mesh.axis_names)}; build it with "
                    "launch.mesh.make_serve_mesh (data-parallel replica "
                    "routing is a scheduler concern, not a mesh axis)")
            self.tp = int(mesh.shape["model"])
            self._validate_tp(cfg)
            if prefix_cache:
                raise NotImplementedError(
                    "prefix_cache under a serve mesh is not implemented "
                    "(the radix index would need shard-symmetric CoW "
                    "forks; ROADMAP follow-up)")
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} but the serve mesh is "
                                 f"on {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.cfg = cfg
        # the config the model body runs with: head-local counts under TP
        self._serve_cfg = cfg.scaled(serve_tp=self.tp)
        self.max_len = max_len
        self.packed = packed
        self.prefix_cache = prefix_cache
        self._caches = CachePool()
        # prefix indexes parked by closed sessions with a swap tier (host-
        # resident, keyed by page size and host budget): the next session
        # of the same geometry adopts one
        self._prefix_store = {}
        self._next_pid = 0
        self._closed = False
        params = tree_to(params, self.device)
        if packed:
            params = pack_weights(params, tp=self.tp, consume=True)
            if _count_packed(params) == 0:
                raise ValueError(
                    "packed=True but no Boolean int8 projection leaves were "
                    "found to pack (FP baseline model?)")
        if mesh is not None:
            params = shard_tree(params, serve_param_specs(params), mesh.rank,
                                self.tp)
        self.params = params

    def _validate_tp(self, cfg: ModelConfig) -> None:
        """Shardability: every attention role must split its KV heads (and
        hence, group-major GQA, its q heads) evenly over the mesh."""
        tp = self.tp
        if all(r["mixer"] == "mamba" for r in block_roles(cfg)):
            return  # pure-SSM: state is lane-indexed and replicated
        hp, kvp = cfg.heads_padded(), cfg.kv_heads_padded()
        if kvp % tp or hp % tp:
            raise ValueError(
                f"serve mesh of {tp} shards cannot split heads evenly: "
                f"padded q heads {hp}, padded kv heads {kvp} (scale "
                f"n_kv_heads so tp divides it)")

    def _send(self, op: int, *parts) -> None:
        """Rank 0 under a mesh: send a device entry to the other ranks."""
        if self.mesh is not None:
            if self._closed:
                raise RuntimeError("the engine's serve mesh is closed")
            serve_worker.send(self.mesh, op, *parts)

    def close(self) -> None:
        """Rank 0 of a serve mesh: release the other ranks from
        ``serve_worker.run``. A no-op on one device and after the first
        call."""
        if self.mesh is not None and self.mesh.rank == 0 and not self._closed:
            serve_worker.send(self.mesh, serve_worker.STOP)
        self._closed = True

    def init_pool(self, n_pages: int, page_size: int, lanes: int):
        """A zeroed page pool (and lane-indexed SSM state) for one session
        on the engine's device: under a mesh, this rank's head-local slice
        of every attention leaf, the same pool allocated on every rank."""
        pool = self._pool_local(n_pages, page_size, lanes)
        if self.mesh is not None:
            pool.pid = self._next_pid
            self._next_pid += 1
            self._send(serve_worker.INIT, [pool.pid, n_pages, page_size,
                                           lanes])
        return pool

    def _pool_local(self, n_pages: int, page_size: int, lanes: int):
        return _Pool(paged_pool_init(self._serve_cfg, n_pages, page_size,
                                     self.device, lanes=lanes))

    def release_pool(self, pool) -> None:
        """A session is done with ``pool``: the other ranks of a mesh drop
        their slices of it (the caller drops its own reference)."""
        if getattr(pool, "pid", None) is not None and not self._closed:
            self._send(serve_worker.FREE, [pool.pid])

    def _role_ids(self, mamba: bool):
        """The "b{i}" keys of the mamba blocks (``mamba``) or the others."""
        return [f"b{i}" for i, r in enumerate(block_roles(self.cfg))
                if (r["mixer"] == "mamba") == mamba]

    def _inputs(self, tokens: torch.Tensor):
        """The prefill's inputs: the tokens, or with an embeddings frontend
        (the audio/vlm stub) their unscaled embedding-table rows, as the
        JAX package's engine feeds it."""
        if self.cfg.frontend == "embeddings":
            table = self.params["embed"]["table"]
            return {"embeddings": table[tokens.long()].to(self.cfg.dtype)}
        return {"tokens": tokens}

    def prefill_commit(self, pool, prompt: np.ndarray, length: int,
                       page_ids: np.ndarray, page_size: int, *,
                       offset: int = 0,
                       prefix_ids: Optional[np.ndarray] = None,
                       lane: int = 0, ssm_init=None, snapshots: bool = False):
        """Batch-1 prefill of a bucket-padded prompt with its true
        ``length``, then the masked scatter of its K/V rows into the pool
        pages ``page_ids`` (entries past the request's pages point at the
        garbage page) and of its mamba end state into lane ``lane``. With
        ``prefix_ids`` (the physical pages of the first ``offset`` cached
        tokens) the prompt is the uncached TAIL: it prefills at positions
        ``offset + i`` over the prefix rows read in place from ``pool``,
        each mamba recurrence resumed from ``ssm_init`` ({"b{i}": {"h",
        "conv"}}, the prefix-boundary state).

        Returns (the (1, 1, Vp) fp32 last-position logits, the mamba end
        state {"b{i}": {"h", "conv"}} with leaves (n_groups, 1, ...), the
        page-boundary snapshots {"b{i}": {"h", "conv"}} with leaves
        (n_groups, 1, n_boundaries, ...) when ``snapshots``, else {}): what
        a finish donates to the prefix index. Under a mesh every rank runs
        the cold prefill and commits its own KVp slice (the prefix paths
        are refused there)."""
        if self.mesh is not None:
            if prefix_ids is not None or ssm_init is not None or snapshots:
                raise NotImplementedError(
                    "tail prefills and snapshots serve the prefix cache, "
                    "which a serve mesh refuses")
            self._send(serve_worker.PREFILL,
                       [pool.pid, length, page_size, lane, prompt.shape[0],
                        page_ids.shape[0]], prompt, page_ids)
        return self._prefill_local(pool, prompt, length, page_ids, page_size,
                                   offset=offset, prefix_ids=prefix_ids,
                                   lane=lane, ssm_init=ssm_init,
                                   snapshots=snapshots)

    def _prefill_local(self, pool, prompt, length, page_ids, page_size, *,
                       offset=0, prefix_ids=None, lane=0, ssm_init=None,
                       snapshots=False):
        cfg = self._serve_cfg
        tokens = torch.from_numpy(prompt[None]).to(self.device)
        S = prompt.shape[0]
        scratch = cache_init(cfg, 1, S, self.device)
        kw = {}
        if prefix_ids is not None:
            kw = dict(offset=offset, prefix_len=offset, ssm_init=ssm_init,
                      prefix_pages={bi: pool[bi]
                                    for bi in self._role_ids(False)},
                      prefix_ids=torch.from_numpy(prefix_ids).to(self.device))
        boundaries = tuple(range(page_size, S + 1, page_size))
        if snapshots and boundaries and self._role_ids(True):
            kw["state_at"] = boundaries
        with serving(self.mesh):
            logits, pcache, *snaps = lm_prefill(
                cfg, self.params, self._inputs(tokens), cache=scratch,
                length=length, **kw)
        commit_prefill(cfg, pool, pcache["blocks"],
                       torch.from_numpy(page_ids), page_size, length=length,
                       lane=lane)
        end_ssm = {bi: pcache["blocks"][bi] for bi in self._role_ids(True)}
        return logits, end_ssm, (snaps[0] if snaps else {})

    def decode_step(self, cache, tokens):
        """One paged decode step over every lane (pool updated in place)."""
        return lm_decode_step_paged(self._serve_cfg, self.params, cache,
                                    tokens)

    def decode_segment(self, pool, block_table: np.ndarray, pos: np.ndarray,
                       cur: np.ndarray, temps: np.ndarray, keys: np.ndarray,
                       steps: np.ndarray, segment: int, sampled: bool):
        """``segment`` paged decode steps over every lane of ``pool`` (in
        place) from the session's host mirrors: block table (L, C), positions
        (L,), current tokens (L, 1) and, when ``sampled``, each lane's
        temperature, raw key and step. Each step samples the next token
        (greedy lanes the argmax, sampled ones from their own key at their
        own step). Returns the emitted tokens (segment, L) and the last
        tokens (L, 1), int32 numpy.

        Under a mesh the other ranks run the same segment; the logits are
        replicated after each step's head gathers, so every rank samples
        the same tokens, and one all-gather of the segment's tokens checks
        it: a disagreement raises ``ShardDisagreement`` here."""
        if self.mesh is not None:
            self._send(serve_worker.SEGMENT, *serve_worker.segment_operands(
                pool.pid, segment, sampled, block_table, pos, cur, temps,
                keys, steps))
        return self._segment_local(pool, block_table, pos, cur, temps, keys,
                                   steps, segment, sampled)

    def _segment_local(self, pool, block_table, pos, cur, temps, keys,
                       steps, segment, sampled):
        dev = self.device
        cache = {"blocks": pool,
                 "block_table": torch.from_numpy(block_table).to(dev),
                 "pos": torch.from_numpy(pos).to(dev)}
        tok = torch.from_numpy(cur).to(dev)
        if sampled:
            temps_t = torch.from_numpy(temps).to(dev)
            keys_t = torch.from_numpy(keys.astype(np.int64)).to(dev)
            steps_t = torch.from_numpy(steps).to(dev)
        toks = []
        with serving(self.mesh):
            for i in range(segment):
                logits, cache = self.decode_step(cache, tok)
                if sampled:
                    tok = sample_tokens(self.cfg, logits[:, -1], temps_t,
                                        keys_t, steps_t + (i + 1))
                else:
                    tok = sample_tokens(self.cfg, logits[:, -1])
                toks.append(tok[:, 0])
        out = torch.stack(toks)
        if self.mesh is not None and not self.mesh.agree(out) \
                and self.mesh.rank == 0:
            raise ShardDisagreement(
                f"the {self.tp} ranks of the serve mesh emitted different "
                "tokens in one segment")
        return out.cpu().numpy(), tok.cpu().numpy()

    # -- one fixed batch over a contiguous cache ------------------------------
    def _single_device(self, what: str) -> None:
        if self.tp > 1:
            raise NotImplementedError(
                f"{what}() uses the contiguous-cache path, which is not "
                "mesh-sharded — use session()/generate_batch() on a serve "
                "mesh (a mesh of one is fine)")

    def _generate(self, cache, prompts, n_tokens: int, temperature: float,
                  key):
        """Prefill ``prompts`` into ``cache``, then ``n_tokens`` decode
        steps, each sampling the next token (step 0 from the prefill
        logits)."""
        B, S = prompts.shape
        if S + n_tokens > self.max_len:
            raise ValueError(f"{S}+{n_tokens} tokens exceeds max_len="
                             f"{self.max_len}")
        tokens = torch.as_tensor(np.asarray(prompts, np.int32)).to(self.device)
        logits, cache = lm_prefill(self.cfg, self.params, self._inputs(tokens),
                                   cache=cache)
        tok = sample_tokens(self.cfg, logits[:, -1], temperature, key, 0)
        out = []
        for i in range(n_tokens):
            out.append(tok)
            logits, cache = lm_decode_step(self.cfg, self.params, cache, tok)
            tok = sample_tokens(self.cfg, logits[:, -1], temperature, key,
                                i + 1)
        return torch.cat(out, dim=1), cache

    def generate(self, prompts, n_tokens: int, temperature: float = 0.0,
                 key=None) -> torch.Tensor:
        """prompts: (B, S) int32 -> (B, n_tokens) int32 tokens on the
        engine's device: greedy, or (``temperature`` > 0 and a raw (2,)
        uint32 ``key``) drawn from the batch-level stream, step i folded
        into ``key``. The contiguous cache of batch size B is taken from
        the engine's pool before the call and put back after it."""
        self._single_device("generate")
        sampled = temperature > 0.0 and key is not None
        B = int(np.shape(prompts)[0])
        cache = self._caches.take(B)
        if cache is None:
            cache = cache_init(self.cfg, B, self.max_len, self.device)
        toks, cache = self._generate(cache, prompts, n_tokens,
                                     temperature if sampled else 0.0,
                                     key if sampled else None)
        self._caches.put(B, cache)
        return toks

    def generate_eager(self, prompts, n_tokens: int,
                       temperature: float = 0.0, key=None) -> torch.Tensor:
        """``generate`` on a fresh cache, sampling as ``sample_tokens``
        does with this temperature and key (greedy without a key or at
        temperature <= 0): the JAX package's per-token parity oracle."""
        self._single_device("generate_eager")
        cache = cache_init(self.cfg, int(np.shape(prompts)[0]), self.max_len,
                           self.device)
        return self._generate(cache, prompts, n_tokens, temperature, key)[0]

    def session(self, *, lanes: int = 4, page_size: int = 16,
                n_pages: Optional[int] = None, segment: int = 1, key=None,
                buckets: Optional[Sequence[int]] = None,
                prefix_cache: Optional[bool] = None,
                **robustness) -> ServeSession:
        """Open a streaming serve session (serve/session.py). ``key``: the
        session's raw (2,) uint32 key (``PRNGKey(0)`` by default);
        ``prefix_cache`` overrides the engine default; ``**robustness``
        passes the overload and fault knobs through (``max_pending``,
        ``tenant_page_quota``, ``tenant_lane_quota``, ``faults``,
        ``audit``, ``clock``, ``hit_first``, ``host_page_budget``; see
        ``ServeSession``). Under a mesh, only on rank 0."""
        use_pfx = self.prefix_cache if prefix_cache is None else prefix_cache
        if self.mesh is not None:
            if use_pfx:
                raise NotImplementedError(
                    "prefix_cache under a serve mesh is not implemented "
                    "(ROADMAP follow-up)")
            if self.mesh.rank != 0:
                raise RuntimeError("sessions run on rank 0 of a serve mesh; "
                                   "the other ranks run serve_worker.run")
        return ServeSession(self, lanes=lanes, page_size=page_size,
                            n_pages=n_pages, segment=segment, key=key,
                            buckets=buckets, prefix_cache=prefix_cache,
                            **robustness)

    def generate_batch(self, prompts: Sequence,
                       n_tokens: Union[int, Sequence[int]],
                       temperatures=None, key=None, *,
                       lanes: int = 4, page_size: int = 16,
                       n_pages: Optional[int] = None, segment: int = 1,
                       prefix_cache: Optional[bool] = None):
        """Continuous-batching generation: submit every request, run the
        session until idle, return a list of (n_tokens_i,) int32 arrays in
        request order. Greedy without ``key``; with it, each request with a
        temperature > 0 draws from ``key`` folded with its request id, at
        its own step (per-lane streams, independent of lane placement)."""
        n = len(prompts)
        n_tok = ([int(n_tokens)] * n if isinstance(n_tokens, int)
                 else [int(t) for t in n_tokens])
        temps = ([0.0] * n if temperatures is None
                 else [float(t) for t in temperatures])
        if len(n_tok) != n or len(temps) != n:
            raise ValueError(f"{n} prompts but {len(n_tok)} n_tokens / "
                             f"{len(temps)} temperatures")
        if key is None:
            temps = [0.0] * n
        with self.session(lanes=lanes, page_size=page_size, n_pages=n_pages,
                          segment=segment, key=key,
                          prefix_cache=prefix_cache) as sess:
            handles = [sess.submit(p, SamplingParams(max_tokens=nt,
                                                     temperature=t))
                       for p, nt, t in zip(prompts, n_tok, temps)]
            sess.run_until_idle()
            return [h.result() for h in handles]
