"""Paper §4.3 adaptability scenario on the port: train Boolean VGG on task A,
then fine-tune the SAME native-Boolean weights on task B (the on-device
training story, Table 6 REF C→F/H), beside task B from scratch.

Synthetic CIFAR-like tasks (class-conditional blob images, made from a
seed) stand in for CIFAR10/100; the mechanism (flip-rule optimisation of
int8 Boolean weights from a Boolean init, Adam on the FP leaves) is the
paper's, as in the JAX package's ``examples/finetune_boolean_cnn.py``.

    PYTHONPATH=src python -m repro_torch.examples.finetune_boolean_cnn \
        [--device cpu]

``--device`` defaults to ``cuda`` and raises on a host without a card.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.bold_vgg_small import SMOKE as VGG_SMOKE
from repro_torch.core.optimizer import (adam, boolean_optimizer,
                                        is_boolean_leaf, tree_map)
from repro_torch.vision import vgg_init, vgg_loss


def synthetic_task(gen: torch.Generator, n: int, hw: int, n_classes: int,
                   shift: float = 0.0):
    """Class-conditional Gaussian-blob images (n, hw, hw, 3) in [-3, 3] and
    their labels, on ``gen``'s device."""
    dev = gen.device
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    centers = torch.randn((n_classes, 3), generator=gen, device=dev) + shift
    imgs = centers[labels][:, None, None, :] \
        + 0.4 * torch.randn((n, hw, hw, 3), generator=gen, device=dev)
    return imgs.clamp(-3, 3), labels


def split_params(params):
    """(Boolean tree, FP tree): int8 leaves, and the rest; None elsewhere."""
    return (tree_map(lambda p: p if is_boolean_leaf(p) else None, params),
            tree_map(lambda p: None if is_boolean_leaf(p) else p, params))


def merge(a, b):
    """One tree from two complementary ones (a leaf is None in one of them)."""
    if isinstance(a, dict):
        return {k: merge(a[k], b[k]) for k in a}
    return b if a is None else a


def train_step(cfg, bopt, fopt, bool_t, fp_t, bstate, fstate, x, y):
    """One step in place: the loss on the float ±1 views of the Boolean
    leaves, their votes to the flip rule, the FP grads to Adam. Returns
    (loss, acc, votes)."""
    views = tree_map(lambda p: p.to(torch.float32).requires_grad_(), bool_t)
    fps = tree_map(lambda p: p.detach().requires_grad_(), fp_t)
    loss, acc = vgg_loss(merge(views, fps), cfg, x, y)
    loss.backward()
    votes = tree_map(lambda v: v.grad, views)
    bopt.update(votes, bstate, bool_t)
    fopt.update(tree_map(lambda p: p.grad, fps), fstate, fp_t)
    return loss.detach(), acc, votes


def train(params, cfg, xs, ys, steps, eta, fp_lr, tag, batch: int = 64):
    bopt, fopt = boolean_optimizer(eta), adam(fp_lr)
    bool_t, fp_t = split_params(params)
    bstate, fstate = bopt.init(bool_t), fopt.init(fp_t)
    n = xs.shape[0]
    for s in range(steps):
        i = (s * batch) % (n - batch)
        loss, acc, _ = train_step(cfg, bopt, fopt, bool_t, fp_t, bstate,
                                  fstate, xs[i:i + batch], ys[i:i + batch])
        if s % 20 == 0:
            print(f"[{tag}] step {s:3d} loss {float(loss):.3f} "
                  f"acc {float(acc):.3f}")
    return merge(bool_t, fp_t), float(acc)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch.cuda.is_available()"
                           " is False; pass --device cpu to run on the CPU")
    dev = torch.device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cfg = VGG_SMOKE
    xa, ya = synthetic_task(gen(1), 2048, cfg.input_hw, cfg.n_classes)
    xb, yb = synthetic_task(gen(2), 2048, cfg.input_hw, cfg.n_classes,
                            shift=1.5)
    params = vgg_init(cfg, gen(0))
    params_a, acc_a = train(params, cfg, xa, ya, 100, eta=6.0, fp_lr=2e-3,
                            tag="task-A scratch")
    # fine-tune the trained Boolean weights on task B (REF F scenario)
    _, acc_ab = train(params_a, cfg, xb, yb, 60, eta=3.0, fp_lr=1e-3,
                      tag="task-B finetune")
    # control: task B from a random init with the same budget
    _, acc_b = train(vgg_init(cfg, gen(9)), cfg, xb, yb, 60, eta=6.0,
                     fp_lr=2e-3, tag="task-B scratch")
    print(f"\ntask-A acc {acc_a:.3f} | task-B finetuned {acc_ab:.3f} "
          f"vs scratch {acc_b:.3f}")
    print("Boolean fine-tuning from a trained Boolean init works natively "
          "(paper Table 6).")


if __name__ == "__main__":
    main()
