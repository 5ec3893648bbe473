"""Adam with fp32 moments and global-norm clipping.

Counterpart of ``repro/optim/adam.py`` for ``state_bits=32`` (what
``tinyllama-1.1b`` and every config under 2e11 parameters uses) and no
weight decay (``repro``'s recipes set none). An
(init_fn, update_fn) pair over any tree of tensors (nested dicts, lists and
tuples), the update in ``repro``'s order and precisions: fp32 moments, the
bias corrections as fp32 powers of the fp32 step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    state_bits: int = 32
    grad_clip_norm: float | None = None

    def __post_init__(self):
        if self.state_bits != 32:
            raise NotImplementedError(
                "8-bit Adam moments (state_bits=8) are ported with ROADMAP "
                "queue 1 item 3 (training engine)")


class AdamState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts/lists/tuples, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def adam(cfg: AdamConfig):
    def init_fn(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        dev = tree_leaves(params)[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), z,
                         tree_map(torch.zeros_like, z))

    def update_fn(grads, state: AdamState, params):
        step = state.step + 1
        if cfg.grad_clip_norm is not None:
            gn = torch.sqrt(sum(torch.sum(torch.square(g))
                                for g in tree_leaves(grads)) + 1e-12)
            scale = torch.clamp_max(cfg.grad_clip_norm / gn, 1.0)
            grads = tree_map(lambda g: g * scale, grads)
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.full_like(t, cfg.b1), t)
        bc2 = 1.0 - torch.pow(torch.full_like(t, cfg.b2), t)

        def leaf(g, m, v, p):
            g = g.to(torch.float32)
            m = cfg.b1 * m + (1.0 - cfg.b1) * g
            v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            return (-cfg.lr * upd).to(p.dtype), m, v

        # the moments and params leaf by leaf in grads' order
        ms, vs, ps = (tree_leaves(tree_map(lambda _, x: x, grads, t))
                      for t in (state.m, state.v, params))
        outs = [leaf(*x) for x in zip(tree_leaves(grads), ms, vs, ps)]
        updates, new_m, new_v = (tree_unflatten(grads, [o[i] for o in outs])
                                 for i in range(3))
        return updates, AdamState(step, new_m, new_v)

    return init_fn, update_fn


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
