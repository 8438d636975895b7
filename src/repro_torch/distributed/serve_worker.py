"""The serve mesh's execution boundary: rank 0 drives, the other ranks follow.

Rank 0 runs the session, the scheduler, the clock, the fault injector and
any gateway: every admission, shed, preemption and deadline is decided
there, once, mesh-wide. The engine's device entries are the only calls
that cross ranks. On rank 0 each first broadcasts an op and its integer
operands over the mesh's gloo command group (``send``); the other ranks sit
in ``run``, which executes the same entry on their shard of the weights
and pools until rank 0's engine closes. The collectives inside an entry
(the head all-gathers before each ``wo``, the segment's token check) then
meet in the same order on every rank.

  =======  ================================================================
  op       operands (int64, in order)
  =======  ================================================================
  INIT     pid, n_pages, page_size, lanes — allocate pool ``pid``, this
           rank's head-local slice
  FREE     pid — drop pool ``pid``
  PREFILL  pid, length, page_size, lane, S, npp; the bucket-padded prompt
           (S); its page ids (npp) — prefill and commit into pool ``pid``
  SEGMENT  pid, segment, sampled, L, C; block table (L·C); positions (L);
           current tokens (L); when sampled: temperatures (L, fp32 bits),
           keys (2·L), steps (L) — ``segment`` decode steps over pool
           ``pid``, each rank sampling the same tokens from the replicated
           logits, then one all-gather of the emitted tokens that every
           rank checks
  STOP     (none) — leave ``run``
  =======  ================================================================

Pure host plumbing: the operands ride as one int64 CPU tensor a call.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

INIT, FREE, PREFILL, SEGMENT, STOP = range(1, 6)


def send(mesh, op: int, *parts) -> None:
    """Rank 0: broadcast ``op`` and its operands (integer arrays, in the
    table's order) to every other rank. A mesh of one sends nothing."""
    if mesh.size == 1:
        return
    payload = np.concatenate([np.asarray(p).astype(np.int64).ravel()
                              for p in parts]) if parts \
        else np.zeros((0,), np.int64)
    dist.broadcast(torch.tensor([op, payload.size], dtype=torch.int64), 0,
                   group=mesh.ctrl)
    if payload.size:
        dist.broadcast(torch.from_numpy(payload), 0, group=mesh.ctrl)


def segment_operands(pid, segment, sampled, bt, pos, cur, temps, keys,
                     steps):
    """SEGMENT's operands from the session's host mirrors."""
    parts = [[pid, segment, int(sampled), bt.shape[0], bt.shape[1]], bt, pos,
             cur]
    if sampled:
        parts += [np.asarray(temps, np.float32).view(np.int32), keys, steps]
    return parts


class _Operands:
    """Reads a received payload front to back."""

    def __init__(self, a: np.ndarray):
        self.a, self.i = a, 0

    def take(self, n: int, dtype=np.int32) -> np.ndarray:
        out = self.a[self.i:self.i + n].astype(dtype)
        self.i += n
        return out

    def ints(self, n: int):
        return [int(v) for v in self.take(n, np.int64)]


def _recv(mesh):
    head = torch.empty((2,), dtype=torch.int64)
    dist.broadcast(head, 0, group=mesh.ctrl)
    op, n = head.tolist()
    payload = torch.empty((n,), dtype=torch.int64)
    if n:
        dist.broadcast(payload, 0, group=mesh.ctrl)
    return op, _Operands(payload.numpy())


def run(engine) -> None:
    """A rank > 0's loop: execute rank 0's engine calls on this rank's
    shard until rank 0's engine closes (STOP). An exception ends the loop
    and the process with it; rank 0's next collective then raises when the
    mesh's timeout runs out."""
    mesh = engine.mesh
    if mesh is None or mesh.rank == 0:
        raise ValueError("serve_worker.run follows rank 0: it runs on the "
                         "other ranks of a serve mesh")
    pools = {}
    while True:
        op, r = _recv(mesh)
        if op == STOP:
            return
        if op == INIT:
            pid, n_pages, page_size, lanes = r.ints(4)
            pools[pid] = engine._pool_local(n_pages, page_size, lanes)
        elif op == FREE:
            pools.pop(r.ints(1)[0], None)
        elif op == PREFILL:
            pid, length, page_size, lane, S, npp = r.ints(6)
            engine._prefill_local(pools[pid], r.take(S), length, r.take(npp),
                                  page_size, lane=lane)
        elif op == SEGMENT:
            pid, segment, sampled, L, C = r.ints(5)
            bt = r.take(L * C).reshape(L, C)
            pos, cur = r.take(L), r.take(L).reshape(L, 1)
            temps = keys = steps = None
            if sampled:
                temps = r.take(L).view(np.float32)
                keys = r.take(2 * L, np.uint32).reshape(L, 2)
                steps = r.take(L)
            engine._segment_local(pools[pid], bt, pos, cur, temps, keys,
                                  steps, segment, bool(sampled))
        else:
            raise RuntimeError(f"serve_worker: unknown op {op}")
