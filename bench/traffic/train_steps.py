"""Training steps: each step a batch of ``batch`` rows of ``seq`` tokens
(and their next-token labels), token ids uniform over the vocabulary,
drawn on the card from (seed, step): every row of every step differs,
and every seed gets the same amount of work."""
from __future__ import annotations

import hashlib


class Traffic:
    def __init__(self, params: dict, seed: int, vocab: int):
        self.p = params
        self.seed = int(seed)
        self.vocab = vocab
        self.tokens_per_step = int(params["batch"]) * int(params["seq"])

    def batch(self, step: int, device):
        import torch
        h = hashlib.sha256(f"{self.seed}/batch/{step}".encode()).digest()
        g = torch.Generator(device=device)
        g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
        ids = torch.randint(0, self.vocab, (int(self.p["batch"]),
                                            int(self.p["seq"]) + 1),
                            generator=g, device=device, dtype=torch.int32)
        return {"tokens": ids[:, :-1].contiguous(),
                "labels": ids[:, 1:].contiguous()}
