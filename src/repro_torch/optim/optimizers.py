"""Optimizers over trees of tensors (counterpart of
``repro/optim/optimizers.py``), the reference's arithmetic step for step
rather than ``torch.optim``: a step returns new trees and leaves its
inputs as they are.

AdamW is the default for both network weights and HGQ bitwidths; the
surrogate bitwidth gradients (Alg. 1) are already commensurate with the
weight gradients.

``adamw_update(..., in_place=True)`` is the counterpart of the reference
Trainer's ``donate_argnums``: the same operations in the same order (the
same bits, whatever the params' dtype), each result written over its
input, so a step holds one copy of the parameters and moments and a
leaf-sized temporary or two, not a second copy of all three.
``clip_by_global_norm_`` clips a list of gradient leaves entry by entry,
so a caller that hands the raw leaves over holds one copy of them.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: Any
    nu: Any


def _step_zero(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=_step_zero(params), mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, in_place: bool = False
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step: new trees, or with ``in_place`` the params' and
    the state's moment leaves updated where they lie (and returned)."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        dp = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            dp = dp + weight_decay * p.to(torch.float32)
        return (p - lr * dp.to(p.dtype)).to(p.dtype), m, v

    def upd_(g, m, v, p):
        """``upd``'s operations in its order, written over m, v and p."""
        g = g.to(torch.float32)
        m.mul_(b1).add_(g * (1 - b1))
        t = g * (1 - b2)
        v.mul_(b2).add_(t.mul_(g))
        del t
        dp = m / bc1
        dp.div_(torch.div(v, bc2).sqrt_().add_(eps))
        if weight_decay:
            dp.add_(p.to(torch.float32) * weight_decay)
        p.sub_(lr * dp.to(p.dtype))
        return p, m, v

    out = [(upd_ if in_place else upd)(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
        tree_leaves(params))]
    return (tree_unflatten(params, [o[0] for o in out]),
            AdamWState(step=step,
                       mu=tree_unflatten(params, [o[1] for o in out]),
                       nu=tree_unflatten(params, [o[2] for o in out])))


class LionState(NamedTuple):
    step: torch.Tensor
    mu: Any


def lion_init(params) -> LionState:
    return LionState(step=_step_zero(params),
                     mu=tree_map(lambda p: torch.zeros_like(
                         p, dtype=torch.float32), params))


def lion_update(grads, state: LionState, params, *, lr, b1: float = 0.9,
                b2: float = 0.99, weight_decay: float = 0.0):
    """Lion: sign momentum, half AdamW's optimizer state."""
    step = state.step + 1

    def upd(g, m, p):
        g = g.to(torch.float32)
        u = torch.sign(b1 * m + (1 - b1) * g)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        return (p - lr * u.to(p.dtype)).to(p.dtype), b2 * m + (1 - b2) * g

    out = [upd(g, m, p) for g, m, p in zip(
        tree_leaves(grads), tree_leaves(state.mu), tree_leaves(params))]
    return (tree_unflatten(params, [o[0] for o in out]),
            LionState(step=step,
                      mu=tree_unflatten(params, [o[1] for o in out])))


def sgd_update(grads, params, *, lr):
    return tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    leaves = tree_leaves(grads)
    gn = clip_by_global_norm_(leaves, max_norm)
    return tree_unflatten(grads, leaves), gn


def clip_by_global_norm_(leaves: List[torch.Tensor], max_norm: float):
    """``clip_by_global_norm`` over a list of gradient leaves: each entry
    replaced by its scaled copy one at a time, so where the caller holds
    no other reference the old one goes before the next is made (two
    leaves may be one tensor: each entry is scaled from the unscaled
    tensor).  Returns the norm."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for i, g in enumerate(leaves):
        leaves[i] = g * scale.to(g.dtype)
    return gn
