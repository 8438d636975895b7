"""The paper's training step in plain PyTorch, on the benchmark's Mamba
model (``reference.lm``): the loss over the padded vocabulary, gradients
through the Boolean projections' backward (``lm._BoolLinear``), summed
over the microbatches in fp32 and averaged, then the flip rule on the
Boolean leaves (Eqs. 9-11: m ← β·m + η·q; flip where m·w ≥ 1, m reset
there, β = 1 − flips / size, per stacked leaf; accumulators stored in
bf16) and Adam on the FP leaves (bias-corrected, lr, β1 0.9, β2 0.999,
ε 1e-8). Each block is recomputed in the backward (checkpointed), so
one block's activations are held at a time.

``follow`` runs the first steps from the seed's weights and returns what
``correct`` compares: each step's loss, each leaf's first gradient as
the optimizer holds it after one step, each leaf's change after the last
step."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from bench import weights
from bench.reference.lm import embed, head, mamba_block, rmsnorm
from bench.reference.numerics import Numerics, setup_matmuls
from bench.yardstick.work import Sizes

B1, B2, EPS = 0.9, 0.999, 1e-8


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, name + "."))
        elif v is not None:
            out[name] = v
    return out


def unflat(leaves: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, v in leaves.items():
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def grad_norms(accum: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
               eta: float) -> Dict[str, float]:
    """Each leaf's gradient as the optimizer holds it after its first
    step: a Boolean leaf's accumulator over η (0 where it flipped), an FP
    leaf's first moment over (1 − β1)."""
    out = {}
    for name, m in accum.items():
        out[name] = float(torch.linalg.vector_norm(m.float()) / eta)
    for name, m in mu.items():
        out[name] = float(torch.linalg.vector_norm(m.float()) / (1 - B1))
    return out


def _sq(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float())) ** 2


def change_norms(model: dict, seed: int, leaf, device) -> Dict[str, float]:
    """‖p − p₀‖ of every leaf, p₀ remade from the seed; ``leaf(name,
    layer)`` gives the leaf's current value (a layer's slice, or the
    global leaf for layer -1)."""
    s = Sizes.of(model)
    out: Dict[str, float] = {}
    for name, p0 in flat(weights.global_weights(model, seed, device)).items():
        out[name] = _sq(leaf(name, -1).float() - p0.float())
    for layer in range(s.n_layers):
        for name, p0 in flat(weights.layer_weights(model, seed, layer,
                                                   device)).items():
            key = "blocks.b0." + name
            out[key] = out.get(key, 0.0) + _sq(leaf(key, layer).float()
                                              - p0.float())
    return {k: v ** 0.5 for k, v in out.items()}


class RefTrainer:
    """The reference's own parameters and optimizer state: Boolean leaves
    int8 per layer, FP leaves in their stated types (bf16 embedding and
    head, fp32 the rest), Adam's moments fp32, accumulators bf16."""

    def __init__(self, model: dict, seed: int, eta: float, lr: float,
                 microbatches: int, device, num: Numerics):
        setup_matmuls()
        self.model, self.s = model, Sizes.of(model)
        self.eta, self.lr, self.micro, self.num = eta, lr, microbatches, num
        self.glob = flat(weights.global_weights(model, seed, device))
        self.layers = [flat(weights.layer_weights(model, seed, l, device))
                       for l in range(self.s.n_layers)]
        self.accum = [{k: torch.zeros(v.shape, dtype=torch.bfloat16,
                                      device=device)
                       for k, v in lw.items() if v.dtype == torch.int8}
                      for lw in self.layers]
        self.beta = {k: 1.0 for k in self.accum[0]}
        self.mu = {("g", k): torch.zeros_like(v, dtype=torch.float32)
                   for k, v in self.glob.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.mu.items()}
        for l, lw in enumerate(self.layers):
            for k, v in lw.items():
                if v.dtype != torch.int8:
                    self.mu[(l, k)] = torch.zeros_like(v, dtype=torch.float32)
                    self.nu[(l, k)] = torch.zeros_like(v, dtype=torch.float32)
        self.t = 0

    # ---- one step ----------------------------------------------------------
    def _views(self):
        g = {k: v.detach().clone().requires_grad_(True)
             for k, v in self.glob.items()}
        ls = [{k: (v.to(torch.bfloat16) if v.dtype == torch.int8 else
                   v.detach().clone()).requires_grad_(True)
               for k, v in lw.items()} for lw in self.layers]
        return g, ls

    def _loss(self, g, ls, tokens, labels):
        num, s = self.num, self.s
        x = embed(num, g["embed.table"], tokens, s.d_model)
        for lw in ls:
            tree = unflat(lw)
            x = torch.utils.checkpoint.checkpoint(
                lambda x_, t=tree: mamba_block(num, s, t, x_), x,
                use_reentrant=False)
        h = rmsnorm(num, x, g["final_norm.scale"])
        logits = head(num, h, g["head.w"])[..., :s.vocab_size]
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long())

    def step(self, batch) -> float:
        g, ls = self._views()
        leaves = list(g.values()) + [v for lw in ls for v in lw.values()]
        n = batch["tokens"].shape[0] // self.micro
        acc, loss = None, 0.0
        for i in range(self.micro):
            lo = self._loss(g, ls, batch["tokens"][i * n:(i + 1) * n],
                            batch["labels"][i * n:(i + 1) * n])
            grads = torch.autograd.grad(lo, leaves)
            if acc is None:
                acc = [gi.to(torch.float32, copy=True) for gi in grads]
            else:
                for a, gi in zip(acc, grads):
                    a.add_(gi.to(torch.float32))
            loss += float(lo.detach())
            del grads, lo
        for a in acc:
            a.div_(self.micro)
        del leaves, g, ls
        self._update(acc)
        return loss / self.micro

    @torch.no_grad()
    def _update(self, acc: List[torch.Tensor]) -> None:
        it = iter(acc)
        gg = {k: next(it) for k in self.glob}
        lg = [{k: next(it) for k in lw} for lw in self.layers]
        self.t += 1
        stepf = torch.tensor(float(self.t))
        bc1 = 1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32), stepf)
        lr = torch.tensor(self.lr, dtype=torch.float32)

        def adam(key, p, grad):
            mu, nu = self.mu[key], self.nu[key]
            dev = p.device
            mu.copy_(B1 * mu + (1 - B1) * grad)
            nu.copy_(B2 * nu + (1 - B2) * grad * grad)
            upd = lr.to(dev) * (mu / bc1.to(dev)) \
                / (torch.sqrt(nu / bc2.to(dev)) + EPS)
            p.copy_(p.to(torch.float32) - upd)

        for k, p in self.glob.items():
            adam(("g", k), p, gg[k])
        eta = torch.tensor(self.eta, dtype=torch.float32)
        flips = {k: 0 for k in self.beta}
        for l, lw in enumerate(self.layers):
            for k, p in lw.items():
                if p.dtype != torch.int8:
                    adam((l, k), p, lg[l][k])
                    continue
                m = self.accum[l][k]
                m32 = self.beta[k] * m.to(torch.float32) \
                    + eta.to(p.device) * lg[l][k]
                flip = (m32 * p.to(torch.float32)) >= 1.0
                p.copy_(torch.where(flip, -p, p))
                m.copy_(m32.masked_fill_(flip, 0.0))
                flips[k] += int(flip.sum())
        for k in self.beta:
            size = sum(lw[k].numel() for lw in self.layers)
            self.beta[k] = float(torch.tensor(1.0, dtype=torch.float32)
                                 - torch.tensor(float(flips[k]),
                                                dtype=torch.float32) / size)

    # ---- readings ----------------------------------------------------------
    def grad_norms(self) -> Dict[str, float]:
        accum: Dict[str, List] = {}
        for lm in self.accum:
            for k, m in lm.items():
                accum.setdefault(k, []).append(m)
        out = {"blocks.b0." + k: (sum(_sq(m) for m in ms) ** 0.5) / self.eta
               for k, ms in accum.items()}
        for k in self.glob:
            out[k] = float(torch.linalg.vector_norm(self.mu[("g", k)])) \
                / (1 - B1)
        sq: Dict[str, float] = {}
        for (l, k), mu in self.mu.items():
            if l != "g":
                sq["blocks.b0." + k] = sq.get("blocks.b0." + k, 0.0) + _sq(mu)
        out.update({k: v ** 0.5 / (1 - B1) for k, v in sq.items()})
        return out

    def leaf(self, name: str, layer: int):
        if layer < 0:
            return self.glob[name]
        return self.layers[layer][name[len("blocks.b0."):]]


def follow(model: dict, seed: int, batches, eta: float, lr: float,
           microbatches: int, device, num: Numerics) -> dict:
    """The reference's first ``len(batches)`` steps from the seed."""
    tr = RefTrainer(model, seed, eta, lr, microbatches, device, num)
    losses, first = [], None
    for i, b in enumerate(batches):
        losses.append(tr.step(b))
        if i == 0:
            first = tr.grad_norms()
    changes = change_norms(model, seed, tr.leaf, device)
    return {"losses": losses, "grads": first, "changes": changes}
