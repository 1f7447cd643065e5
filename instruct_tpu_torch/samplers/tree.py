"""Positions of the gradient samplers as trees of tensors.

A position is one tensor or a tuple of tensors (``MarginalParams`` is a
``NamedTuple``), every leaf with a leading batch axis B: the chains (HMC,
NUTS), the ELBO samples (SVI) or the particles (SMC).  The JAX package
maps over such pytrees with ``jax.tree``; these helpers are that, for the
two shapes the samplers meet, plus the batched ``value_and_grad``.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch

# Evaluations of the samplers' target, counted where they happen:
# "grad_evals" (value and gradient, one a batch) and "evals" (value only,
# SMC).  Reset by the caller; read by chip_smoke.py.
counts: collections.Counter = collections.Counter()


def leaves(tree) -> list:
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def rebuild(like, new_leaves):
    if isinstance(like, torch.Tensor):
        return new_leaves[0]
    if hasattr(like, "_fields"):
        return type(like)(*new_leaves)
    return tuple(new_leaves)


def tmap(fn: Callable, *trees):
    return rebuild(trees[0], [fn(*xs) for xs in zip(*map(leaves, trees))])


def rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``mask`` [B] shaped to broadcast against ``x`` [B, ...]."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def where(mask: torch.Tensor, a, b):
    """Row-wise select of two trees (or tensors [B, ...])."""
    return tmap(lambda x, y: torch.where(rows(mask, x), x, y), a, b)


def dot(a, b) -> torch.Tensor:
    """Per-row inner product [B] summed over the leaves in order (JAX's
    ``sum(jnp.vdot(x, y) for ...)``)."""
    total = 0
    for x, y in zip(leaves(a), leaves(b)):
        xy = x * y
        total = total + (xy if xy.dim() == 1 else xy.flatten(1).sum(1))
    return total


def value_and_grad(fn: Callable) -> Callable:
    """``fn`` maps a position to its values f32[B]; the returned function
    gives (values, gradient tree).  The rows are independent, so the
    gradient of ``fn(x).sum()`` holds each row's own gradient."""
    def vg(position):
        xs = [x.detach().requires_grad_(True) for x in leaves(position)]
        with torch.enable_grad():
            value = fn(rebuild(position, xs))
            grads = torch.autograd.grad(value.sum(), xs, allow_unused=True)
        counts["grad_evals"] += 1
        return value.detach(), rebuild(position, [
            torch.zeros_like(x) if g is None else g
            for x, g in zip(xs, grads)])
    return vg
