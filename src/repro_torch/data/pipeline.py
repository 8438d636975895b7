"""Deterministic, resumable token pipeline: the port's own copy of the JAX
package's ``data/pipeline.py``. It is numpy only, so ``batch_at(step)`` is
bit-identical to the reference's.

Fault-tolerance contract: a pipeline is a pure function of (seed, step) —
after preemption/restart at step k, batch k is bit-identical, with no
iterator state to checkpoint beyond the step counter. On a single host it
yields global batches.

Two backends:
  SyntheticLM     — PRNG token stream with a learnable structure (Markov-ish
                    mixture so models can actually reduce loss).
  BinTokenDataset — memory-mapped flat .bin of token ids (uint16/uint32),
                    the standard packed-corpus format.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # tokens depend on a hash of the last `order`

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # structured stream: next token = hash(prev tokens) + noise
        toks = np.zeros((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S))
        rand_tok = rng.integers(0, V, (B, S))
        for t in range(1, S + 1):
            det = (toks[:, t - 1] * 31 + (toks[:, t - 2] if t >= 2 else 0)
                   * 17 + 7) % V
            toks[:, t] = np.where(noise[:, t - 1] < 0.8, det,
                                  rand_tok[:, t - 1])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class BinTokenDataset:
    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n = len(self._data) - (self.seq_len + 1)
        if self._n <= 0:
            raise ValueError(f"{self.path}: too short for seq_len")

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, self._n, self.global_batch)
        rows = np.stack([np.asarray(self._data[s:s + self.seq_len + 1])
                         for s in starts]).astype(np.int32)
        rows = np.clip(rows, 0, self.vocab_size - 1)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_pipeline(cfg, seq_len: int, global_batch: int,
                  path: Optional[str] = None, seed: int = 0):
    if path:
        return BinTokenDataset(path, cfg.vocab_size, seq_len, global_batch,
                               seed=seed)
    return SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed)
