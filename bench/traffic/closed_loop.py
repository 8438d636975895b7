"""Closed loop: ``clients`` clients, each sending its next request as
soon as its last one completes, greedy. Prompt and output lengths are
spread over the mix's ranges at evenly spaced quantiles, evenly or, where
the mix sets ``prompt_spread`` / ``output_spread`` to ``"log"``,
log-uniformly (a heavy tail: the median is the geometric mean of the
range's ends).

Every seed asks the same work of the card: the sizes, their pairing and
their order come from the mix's own ``size_seed``; the seed draws the
token ids and which client holds which of the first requests (the lanes
are alike). Set-up fills every lane as a loop that has run for a while
holds them: the requests under way are length-biased (a long request is
under way for longer), so each lane's first request has a budget drawn
from the output lengths weighted by length, of which a fraction, spread
evenly, is still to come; one decode segment more warms the decode
shapes."""
from __future__ import annotations

import time

import numpy as np

from bench.traffic import shuffled, tokens


def spread(lo: int, hi: int, q: np.ndarray, kind: str) -> np.ndarray:
    """Lengths at quantiles ``q`` of the range [lo, hi], uniform
    (``"even"``) or log-uniform (``"log"``)."""
    if kind == "log":
        v = np.exp(np.log(lo) + (np.log(hi) - np.log(lo)) * q)
    elif kind == "even":
        v = lo + (hi - lo) * q
    else:
        raise ValueError(f"unknown spread {kind!r}")
    return np.clip(np.round(v), lo, hi).astype(int)


def biased(lo: int, hi: int, q: np.ndarray, kind: str) -> np.ndarray:
    """Lengths at quantiles ``q`` of the length-biased form of ``spread``'s
    distribution (density times length): log-uniform becomes uniform,
    uniform becomes a density rising linearly."""
    if kind == "log":
        return spread(lo, hi, q, "even")
    if kind == "even":
        v = np.sqrt(lo * lo + (hi * hi - lo * lo) * q)
        return np.clip(np.round(v), lo, hi).astype(int)
    raise ValueError(f"unknown spread {kind!r}")


class Traffic:
    def __init__(self, params: dict, seed: int, vocab: int):
        self.p = params
        self.seed = seed
        self.vocab = vocab
        c = int(params["clients"])
        lo, hi = params["prompt_len"]
        olo, ohi = params["output_len"]
        # one block of ``clients`` requests, stratified over both ranges
        # and paired by the mix's own size_seed; every later block holds
        # these same sizes, in an order drawn from size_seed too
        mid = (np.arange(c) + 0.5) / c
        size_seed = int(params["size_seed"])
        rng = np.random.default_rng(size_seed)
        prompts = spread(lo, hi, mid, params.get("prompt_spread", "even"))
        outs = spread(olo, ohi, mid, params.get("output_spread", "even"))
        self.block = np.stack([prompts, outs[rng.permutation(c)]], 1)
        self.size_seed = size_seed
        # the requests under way when the window would find the loop:
        # length-biased budgets, each with a fraction still to come
        under = biased(olo, ohi, mid, params.get("output_spread", "even"))
        frac = shuffled(mid, size_seed, 2)
        firsts = np.maximum(1, np.ceil(frac * shuffled(under, size_seed, 1)))
        self.fill = np.stack([shuffled(prompts, size_seed, 0),
                              firsts.astype(int)], 1)
        self.first_frac = frac
        self.first_of = shuffled(np.arange(c), seed, 2)
        self.next = 0

    def request(self, client: int, first: bool = False):
        """(rid, prompt, max_tokens) of the next request of ``client``."""
        rid = self.next
        self.next += 1
        c = len(self.block)
        if first:
            S, out = (int(v) for v in self.fill[self.first_of[client]])
        else:
            order = shuffled(np.arange(c), self.size_seed, 3 + rid // c)
            S, out = (int(v) for v in self.block[order[rid % c]])
        return rid, tokens(self.seed, rid, S, self.vocab), out

    # ---- driving -----------------------------------------------------------
    def setup(self, run, served) -> None:
        for c in range(int(self.p["clients"])):
            served.submit(c, *self.request(c, first=True))
        with run.span("setup.fill"):
            while served.pending():
                self._step(run, served)
        with run.span("setup.warm_decode"):
            self._step(run, served)

    def _step(self, run, served) -> bool:
        """One ``step()``; whether it decoded (rather than admitted)."""
        done = served.step(run)
        for rec in done:
            served.submit(rec.client, *self.request(rec.client))
        return served.decoded

    def window(self, run, served) -> None:
        """From the end of set-up's decode segment to the end of the
        first decode segment after ``run.seconds``: the window spans
        whole rounds of admission and decode. A round admits its
        completions' next requests (seconds of prefill, a token each) and
        then decodes a segment (a token a lane a step), so a window cut
        inside a round would read high or low by which of the two the
        clock stopped in."""
        t0 = run.window_open()
        while True:
            decoded = self._step(run, served)
            run.tick()
            t = time.perf_counter()
            if t - t0 >= run.seconds and decoded:
                break
        run.window_close(t)
