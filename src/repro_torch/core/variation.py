"""Boolean variation calculus (paper §3.2, Appendix A) on the ±1 embedding.

The paper's Prop A.2 establishes the isomorphism ({T,F}, xnor) ≅ ({±1}, ×)
under e(T) = +1, e(F) = -1, e(0) = 0. Boolean tensors are ±1-valued (int8
storage, any float view), ``xnor`` is an elementwise product, ``xor`` its
negation, and the Boolean neuron's counting of TRUEs is a plain sum.

The variation operators below act on {-1, 0, +1} tensors (three-valued
logic M = B ∪ {0}, Def 3.1) and state the truth tables and the variation
definitions verbatim; the hot path never calls them. They are the JAX
package's ``core/variation.py`` as plain functions on tensors, with the
same dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

# Canonical logic constants in the embedded domain.
TRUE = 1
FALSE = -1
ZERO = 0  # the third value of M (Def 3.1)

BOOL_DTYPE = torch.int8  # storage dtype for Boolean weights


# ---------------------------------------------------------------------------
# Embedded-domain connectives (hot path) — Prop A.3.
# ---------------------------------------------------------------------------
def xnor(a, b):
    """xnor in the embedded domain: elementwise product (Prop A.3 (1)-(2)).
    For a ∈ L, x ∈ N the mixed-type xnor (Def 3.5) is ``e(a) * x``."""
    return a * b


def xor(a, b):
    """xor = ¬xnor (Prop A.3 (5))."""
    return -(a * b)


def neg(a):
    """Logic negation: ¬T = F, ¬F = T, ¬0 = 0 — arithmetic negation."""
    return -a


# ---------------------------------------------------------------------------
# Type conversion (Def A.1).
# ---------------------------------------------------------------------------
def _sign(x):
    """Sign, a zero keeping its own sign bit (-0.0 stays -0.0), as XLA's."""
    x = torch.as_tensor(x)
    if x.is_floating_point():
        return torch.where(x == 0, x, torch.sign(x))
    return torch.sign(x)


def project(x):
    """p: N → L. Sign with p(0) = 0 (Def A.1 Eq 13)."""
    return _sign(x)


def embed(a, dtype=torch.float32):
    """e: L → N. Identity on {-1, 0, 1} with a numeric dtype (Def A.1 Eq 14)."""
    return torch.as_tensor(a).to(dtype)


def magnitude(x):
    """|x| (Def 3.4): logic values have magnitude 1 (or 0)."""
    return torch.abs(torch.as_tensor(x))


# ---------------------------------------------------------------------------
# Variation operators (Defs 3.7, 3.8, 3.10, 3.12).
# ---------------------------------------------------------------------------
def delta(a, b):
    """δ(a→b) for logic values (Def 3.7): T if b > a, 0 if b = a, F if b < a;
    with F < T as -1 < +1, sign(b - a)."""
    return _sign(b - a)


def variation_bool(f, x):
    """f'(x) for f: B→B at Boolean x (Def 3.8): xnor(δ(x→¬x), δf(x→¬x)).
    ``f`` acts elementwise on ±1 tensors."""
    nx = neg(x)
    return xnor(delta(x, nx), delta(f(x), f(nx)))


def variation_bool_num(f, x):
    """f'(x) for f: B→N (Prop A.5): xnor(δ(x→¬x), f(¬x) − f(x)), the
    variation in the numeric codomain keeping its magnitude."""
    nx = neg(x)
    return xnor(delta(x, nx), f(nx) - f(x))


def variation_int(f, x):
    """f'(x) for f: Z→D (Def 3.10): δf(x → x+1) = f(x+1) - f(x)."""
    return f(x + 1) - f(x)


def partial_variation(f, x, i):
    """Partial variation of f: B^n→D with respect to coordinate ``i`` (Def
    3.12): xnor(δ(x_i→¬x_i), δ(f(x)→f(x_¬i)))."""
    x = torch.as_tensor(x)
    xi = x[..., i]
    x_flip = x.clone()
    x_flip[..., i] = neg(xi)
    return xnor(delta(xi, neg(xi)), delta(f(x), f(x_flip)))


# ---------------------------------------------------------------------------
# Aggregation (Eqs 7-8): #T − #F of a variation tensor, a plain sum.
# ---------------------------------------------------------------------------
def aggregate(q, axis):
    """Σ 1(q=T)|q| − Σ 1(q=F)|q| — in the embedding, sum(q, axis); integer
    and bool votes count in int32, as the JAX package's sum does."""
    q = torch.as_tensor(q)
    if q.is_floating_point():
        return torch.sum(q, dim=axis)
    return torch.sum(q, dim=axis, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Boolean tensor helpers.
# ---------------------------------------------------------------------------
def booleanize(x, dtype=BOOL_DTYPE):
    """Project a numeric tensor to ±1 (0 maps to +1, so results stay
    Boolean)."""
    x = torch.as_tensor(x)
    return torch.where(x >= 0, 1, -1).to(dtype)


def random_boolean(shape, generator: torch.Generator, device=None,
                   dtype=BOOL_DTYPE) -> torch.Tensor:
    """iid uniform ±1 Boolean tensor (paper's randint init, Alg 4), drawn
    from ``generator`` on its device unless ``device`` says otherwise."""
    device = generator.device if device is None else device
    x = torch.randint(0, 2, tuple(shape), generator=generator, device=device,
                      dtype=dtype)
    return x.mul_(2).sub_(1)


def is_boolean(x) -> bool:
    """Host-side check that an array or tensor is strictly ±1-valued."""
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return bool(np.all((arr == 1) | (arr == -1)))
