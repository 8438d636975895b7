"""The references themselves, held to the port's plain CPU path at smoke
widths in fp32, where both compute the same function up to the order of
fp32 sums: the dense decoder's logits (``lm_forward``) and the Mamba
model's first training step (``make_train_step`` with the hybrid
optimizer) - its loss, each leaf's gradient as the optimizer holds it
and each leaf's change."""

import pytest
import torch

from bench import weights
from bench.harness import BENCH, load_json
from bench.reference.lm import served_logits
from bench.reference.numerics import Numerics
from bench.reference.train import follow
from bench.systems.serve import model_config
from bench.systems.train import program_grad_norms

torch.set_num_threads(2)


def _dense(act_boolean):
    m = dict(load_json(BENCH / "configs" / "qwen2.5-14b.json")["model"])
    m.update(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=256, vocab_size=512, dtype="float32",
             act_boolean=act_boolean)
    return m


def _mamba():
    m = dict(load_json(BENCH / "configs" / "falcon-mamba-7b-d16.json")
             ["model"])
    m.update(n_layers=2, d_model=64, d_inner=128, dt_rank=8, ssm_state=4,
             vocab_size=256, dtype="float32", remat=False)
    return m


@pytest.mark.parametrize("act_boolean", [False, True])
def test_dense_logits_match_the_port(act_boolean):
    from repro_torch.models import lm_forward
    model = _dense(act_boolean)
    seed = 2**31 + 3
    tokens = torch.randint(0, 512, (1, 40), generator=torch.Generator()
                           .manual_seed(1))
    with torch.no_grad():
        port, _ = lm_forward(model_config(model),
                             weights.program_params(model, seed, "cpu"),
                             {"tokens": tokens.int()})
    ref = served_logits(model, seed, [tokens[0]], [0], Numerics("float32"),
                        "cpu")[0]
    err = (port[0, :, :512] - ref).abs().max()
    assert err <= 1e-4 * ref.abs().max(), float(err)


def test_mamba_logits_match_the_port():
    from repro_torch.models import lm_forward
    model = _mamba()
    seed = 2**31 + 4
    tokens = torch.randint(0, 256, (1, 24), generator=torch.Generator()
                           .manual_seed(2))
    with torch.no_grad():
        port, _ = lm_forward(model_config(model),
                             weights.program_params(model, seed, "cpu"),
                             {"tokens": tokens.int()})
    ref = served_logits(model, seed, [tokens[0]], [0], Numerics("float32"),
                        "cpu")[0]
    err = (port[0] - ref).abs().max()
    assert err <= 1e-4 * ref.abs().max(), float(err)


def test_mamba_training_step_matches_the_port():
    from repro_torch.core.optimizer import hybrid_optimizer
    from repro_torch.train import make_train_step
    from bench.reference.train import change_norms, flat
    from bench.traffic.train_steps import Traffic
    model = _mamba()
    seed, eta, lr = 2**31 + 5, 1e3, 1e-3
    batch = Traffic({"batch": 4, "seq": 16}, seed, 256).batch(0, "cpu")
    params = weights.program_params(model, seed, "cpu")
    opt = hybrid_optimizer(eta=eta, fp_lr=lr)
    state = opt.init(params)
    step = make_train_step(model_config(model), opt, microbatches=2)
    params, state, m = step(params, state, batch)
    grads = program_grad_norms(state, eta)
    st = flat(params)
    changes = change_norms(model, seed,
                           lambda k, l: st[k] if l < 0 else st[k][l], "cpu")
    ref = follow(model, seed, [batch], eta, lr, 2, "cpu", Numerics("float32"))
    assert abs(float(m["loss"]) - ref["losses"][0]) <= 1e-5
    assert grads.keys() == ref["grads"].keys()
    # a Boolean leaf's gradient is read from its bf16 accumulator: a vote
    # on the edge of a bf16 rounding moves it by an ulp (2^-8) on one side
    for k in grads:
        assert abs(grads[k] - ref["grads"][k]) <= 2**-9 * ref["grads"][k], k
        assert abs(changes[k] - ref["changes"][k]) <= \
            1e-3 * max(ref["changes"][k], 1e-6), k
    assert any(v > 0 for k, v in changes.items() if k.endswith(".w")
               and k.startswith("blocks")), "no weight flipped"
