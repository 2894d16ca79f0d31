"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro.optim.adamw``).

Moment states are f32 regardless of (possibly bf16) param dtype; the update
math runs in f32 and casts back — the standard mixed-precision recipe.  The
state mirrors the parameters by name: ``{"mu": {name: f32}, "nu": {name:
f32}, "count": int32}``, keyed by an ``LM``'s ``named_parameters()`` (or a
plain ``{name: tensor}`` dict's keys).

Not ``torch.optim.AdamW``: that one puts eps and the decay elsewhere
(``p *= 1 - lr*wd`` first), so its answers differ.  This is the
reference's formula in its op order, one tensor at a time, updating the
parameters and the moments in place.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.ops import sqrt32


def _named(params) -> dict:
    """``{name: tensor}`` of an ``nn.Module`` or a plain dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _sqrt(x):
    """IEEE float32 square root, as the reference's: the card's ``sqrt``
    is correctly rounded, the CPU's vectorized one is not (``sqrt32``)."""
    return torch.sqrt(x) if x.is_cuda else sqrt32(x)


def adamw_init(params):
    """Zero f32 moments for every parameter and a zero int32 count, on
    the parameters' device."""
    named = _named(params)
    dev = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}

    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: dict):
    """sqrt of the sum of every gradient's f32 sum of squares, the tensors
    in dict order (the reference sums its stacked leaves in pytree
    order, so the two agree to float32 rounding, not bitwise)."""
    total = sum(torch.sum(g.float() ** 2) for g in grads.values())
    return _sqrt(total)


def _clip_scale(gnorm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= ``max_norm`` as f32, the norm)."""
    grads = _named(grads)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    grad_norm=None,
):
    """One AdamW step.  ``params`` (an ``nn.Module`` or ``{name: tensor}``)
    and ``state``'s moments and count are updated in place; ``grads`` is
    ``{name: tensor}``.  Returns (params, state, {"grad_norm": ...}).
    ``grad_norm``, when given, is the global norm to clip by in place of
    ``grads``' own: a sharded step updates one position's slices of the
    tensors at a time, clipped by the whole gradient's norm.

    The clipped f32 gradient of each tensor is formed just before its
    update, so no f32 copy of every gradient is held at once."""
    named = _named(params)
    grads = _named(grads)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, max_grad_norm)
    count = state["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    mus, nus = state["mu"], state["nu"]
    for name, p in named.items():
        g32 = grads[name].float() * scale
        mu = b1 * mus[name] + (1 - b1) * g32
        nu = b2 * nus[name] + (1 - b2) * g32 * g32
        step = (mu / c1) / (_sqrt(nu / c2) + eps)
        p32 = p.float()
        p32 = p32 - lr * (step + weight_decay * p32)
        p.copy_(p32)
        mus[name], nus[name] = mu, nu
    state["count"] = count
    return params, state, {"grad_norm": gnorm}
