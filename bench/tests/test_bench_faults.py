"""``correct`` comes out false when the timed path is broken underneath:
the harness runs a cell at a CPU test size, without its look for a card,
with one fault planted in the port, once for each fault the cell can
have (one card: no exchange between chips to leave out)."""
import pytest
import torch

from bench.harness import local_run
from bench.tests.small import cell

torch.set_num_threads(2)


def _alter_token(monkeypatch):
    """A token altered where it is produced: every sampled token + 1."""
    import repro_torch.serve.engine as E
    import repro_torch.serve.session as S
    for mod in (E, S):
        orig = mod.sample_tokens

        def wrong(cfg, logits, *a, _orig=orig, **k):
            return (_orig(cfg, logits, *a, **k) + 1) % cfg.vocab_size
        monkeypatch.setattr(mod, "sample_tokens", wrong)


def _frozen_pool(monkeypatch):
    """A decode step that returns its state unchanged: the pages it
    writes are a copy, the pool stays as it was."""
    import repro_torch.serve.engine as E
    orig = E.lm_decode_step_paged

    def frozen(cfg, params, cache, tokens):
        blocks = {b: {k: v.clone() for k, v in leaves.items()}
                  for b, leaves in cache["blocks"].items()}
        return orig(cfg, params, dict(cache, blocks=blocks), tokens)
    monkeypatch.setattr(E, "lm_decode_step_paged", frozen)


def _half_prompt(monkeypatch):
    """Half of the batch left out: the prefill sees the first half of
    each prompt, the rest replaced by its first token (a prefill's batch
    is the prompt's rows)."""
    import repro_torch.serve.engine as E
    orig = E.lm_prefill

    def half(cfg, params, batch, *a, **k):
        t = batch["tokens"].clone()
        n = t.shape[1] // 2
        t[:, n:] = t[:, :1]
        return orig(cfg, params, dict(batch, tokens=t), *a, **k)
    monkeypatch.setattr(E, "lm_prefill", half)


def _no_update(monkeypatch):
    """A step that returns its state unchanged: the optimizer moves
    nothing."""
    import repro_torch.core.optimizer as O
    orig = O.hybrid_optimizer

    def frozen(*a, **k):
        opt = orig(*a, **k)
        return O.Optimizer(opt.init, lambda g, s, p, **kw: (p, s))
    monkeypatch.setattr(O, "hybrid_optimizer", frozen)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    import repro_torch.train as T
    orig = T.make_train_step

    def half(cfg, opt, microbatches=1, **k):
        step = orig(cfg, opt, microbatches, **k)

        def run(params, state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, state, {k: v[:n] for k, v in batch.items()})
        return run
    monkeypatch.setattr(T, "make_train_step", half)


CASES = [("qwen14b-decode-long", _alter_token),
         ("qwen14b-decode-long", _frozen_pool),
         ("qwen14b-decode-long", _half_prompt),
         ("falcon7b-train-2k", _no_update),
         ("falcon7b-train-2k", _half_batch)]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in CASES])
def test_fault_makes_correct_false(name, fault, monkeypatch):
    fault(monkeypatch)
    c, cfg = cell(name)
    run, out = local_run(name, c, cfg, seed=2**31 + 202, seconds=1.5)
    assert out["correct"] is False, out["checks"]
