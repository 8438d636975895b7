"""Quickstart: train a native-Boolean MLP with Boolean logic only.

The paper's core loop on the port: Boolean weights (int8 ±1), the counting
neuron forward (Eq 1), the vote-aggregated backward (Eqs 5-8, every vote
through ``kernels/boolean_bwd.py::boolean_weight_bwd``) and the flip-rule
optimizer (Alg 1) — no FP latent weights anywhere. The same model, data,
optimizers and 60 full-batch epochs as the JAX package's
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Weights and data are drawn on the CPU from seeded ``torch.Generator``s
(seeds 0, 1 and 7, as the JAX example's keys) and then moved to the
device, so a card run and a CPU run start from the same draw. ``--device``
defaults to ``cuda`` and raises on a host without a card.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (boolean_activation, boolean_dense,
                              random_boolean)
from repro_torch.core.optimizer import adam, boolean_optimizer, tree_leaves
from repro_torch.serve import resolve_device

EPOCHS, N_ROWS = 60, 4096


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def init(gen: torch.Generator, d_in: int = 64, d_hidden: int = 256,
         n_cls: int = 4):
    return {
        "w1": random_boolean((d_in, d_hidden), gen),      # Boolean (int8 ±1)
        "w2": random_boolean((d_hidden, n_cls), gen),     # Boolean
        "out_scale": torch.ones((n_cls,), dtype=torch.float32),  # FP
    }


def teacher_task(x_gen: torch.Generator, w_gen: torch.Generator,
                 n: int = N_ROWS, d_in: int = 64, n_cls: int = 4):
    """Random ±1 rows labelled by a Boolean linear teacher: (xs fp32, ys)."""
    xs = random_boolean((n, d_in), x_gen).to(torch.float32)
    w_true = random_boolean((d_in, n_cls), w_gen).to(torch.float32)
    return xs, torch.argmax(xs @ w_true, dim=-1)


def forward(params_f, x):
    h = boolean_dense(x, params_f["w1"], None)            # counting neuron
    h = boolean_activation(h, 0.0, x.shape[-1])           # threshold ±1
    logits = boolean_dense(h, params_f["w2"], None)
    return logits * params_f["out_scale"]


def loss_fn(params_f, x, y):
    logp = torch.log_softmax(forward(params_f, x).to(torch.float32), dim=-1)
    return -torch.mean(torch.take_along_dim(logp, y[:, None], dim=1))


def float_view(bool_params, fp_params):
    """The tree ``forward`` reads: the int8 leaves as fp32 ±1 views."""
    return {**{k: v.to(torch.float32) for k, v in bool_params.items()},
            **fp_params}


def accuracy(bool_params, fp_params, xs, ys) -> float:
    with torch.no_grad():
        pred = torch.argmax(forward(float_view(bool_params, fp_params), xs), -1)
    return float((pred == ys).to(torch.float32).mean())


def split(params):
    """(int8 leaves, FP leaves)."""
    return ({k: v for k, v in params.items() if v.dtype == torch.int8},
            {k: v for k, v in params.items() if v.dtype != torch.int8})


def make_step(bool_opt, fp_opt):
    """-> ``step(bool_params, fp_params, bstate, fstate, x, y) ->
    (bstate, fstate, loss)``: the votes of the int8 leaves' float views to
    the flip rule, the FP grads to Adam; the params change in place."""
    def step(bool_params, fp_params, bstate, fstate, x, y):
        views = {k: v.to(torch.float32).requires_grad_()
                 for k, v in bool_params.items()}
        fps = {k: v.detach().requires_grad_() for k, v in fp_params.items()}
        loss = loss_fn({**views, **fps}, x, y)
        names = list(views) + list(fps)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [views[k] for k in views] + [fps[k] for k in fps])))
        _, bstate = bool_opt.update({k: grads[k] for k in views}, bstate,
                                    bool_params)
        _, fstate = fp_opt.update({k: grads[k] for k in fps}, fstate,
                                  fp_params)
        return bstate, fstate, loss.detach()
    return step


def train(params, xs, ys, epochs: int = EPOCHS, log=print):
    """The example's loop from ``params`` (int8 and FP leaves, on the
    data's device; changed in place) -> (bool_params, fp_params, bstate,
    [(epoch, loss, acc, flips) every 5 epochs])."""
    bool_opt, fp_opt = boolean_optimizer(eta=8.0), adam(1e-2)
    bool_params, fp_params = split(params)
    bstate, fstate = bool_opt.init(bool_params), fp_opt.init(fp_params)
    step = make_step(bool_opt, fp_opt)
    history = []
    for epoch in range(epochs):
        bstate, fstate, loss = step(bool_params, fp_params, bstate, fstate,
                                    xs, ys)
        if epoch % 5 == 0:
            acc = accuracy(bool_params, fp_params, xs, ys)
            flips = sum(float(f) for f in tree_leaves(bstate.flips))
            history.append((epoch, float(loss), acc, flips))
            if log:
                log(f"epoch {epoch:2d} loss {float(loss):.4f} "
                    f"acc {acc:.3f} flips {flips:.0f}")
    return bool_params, fp_params, bstate, history


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = {k: v.to(dev) for k, v in init(_gen(0)).items()}
    xs, ys = (t.to(dev) for t in teacher_task(_gen(1), _gen(7)))
    bool_params, fp_params, _, _ = train(params, xs, ys)
    acc = accuracy(bool_params, fp_params, xs, ys)
    w1 = bool_params["w1"]
    print(f"final acc {acc:.3f} — weights are int8 ±1 throughout: "
          f"{w1.dtype}, values {set(torch.unique(w1).tolist())}")
    assert acc > 0.8
    return acc


if __name__ == "__main__":
    main()
