"""Optimizers with path-regex parameter groups (port of
:mod:`repro.optim.optimizers`).

API, as the reference's::

    opt = make_optimizer(OptimizerConfig(...), schedule)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params, step)

Trees are nested dicts of tensors.  A leaf's path is its keys joined by
``/`` (``layers/attn/wo/sell/a``), the string the reference's
``tree_paths`` gives the same leaf, so the reference's group regexes
(e.g. ``SELL_GROUPS`` of the launchers) match the same leaves.  Leaves are
visited in sorted-key order, as JAX flattens dicts.  Groups are
``(regex, overrides)`` pairs, first match wins; overrides are
``lr_mult`` and ``weight_decay``.

Unlike the reference, ``update`` writes the new moments INTO the state's
tensors (``copy_``), and the train step adds the returned updates to the
parameters in place under ``torch.no_grad()``: one copy of each tree
lives on the card.  The arithmetic is the reference's, in fp32.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Tree utilities (nested dicts of tensors).
# ---------------------------------------------------------------------------

def tree_flatten(tree, prefix: str = "") -> Tuple[List[str], list]:
    """(paths, leaves) in sorted-key order (JAX's dict order)."""
    paths, leaves = [], []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        val = tree[key]
        if isinstance(val, dict):
            p, l = tree_flatten(val, path)
            paths += p
            leaves += l
        else:
            paths.append(path)
            leaves.append(val)
    return paths, leaves


def tree_unflatten(paths: List[str], leaves: list) -> dict:
    """Nested dict from ``tree_flatten``'s (paths, leaves)."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def tree_map(fn: Callable, tree, *rest) -> dict:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); returns a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = "") -> dict:
    """Same-structure tree of ``a/b/c`` path strings."""
    return {k: tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
            if isinstance(v, dict) else (f"{prefix}/{k}" if prefix
                                         else str(k))
            for k, v in tree.items()}


def global_norm(tree, reduce: Optional[Callable] = None) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted order) of each leaf's fp32 sum
    of squares.  ``reduce(paths, sums) -> sums`` completes each leaf's
    sum over the ranks that hold the rest of it (a tree of this rank's
    blocks: ``dist.sharding.Placement.norm``)."""
    paths, leaves = tree_flatten(tree)
    sums = [torch.sum(torch.square(t.float())) for t in leaves]
    if reduce is not None:
        sums = reduce(paths, sums)
    return torch.sqrt(sum(sums))


# ---------------------------------------------------------------------------
# Config.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"              # adamw | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    momentum: float = 0.9            # sgd
    weight_decay: float = 0.1
    grad_clip: float = 1.0           # global-norm clip; 0 = off
    # (regex, {"lr_mult": float, "weight_decay": float}) — first match wins
    groups: Tuple[Tuple[str, dict], ...] = ()
    # keep first/second moments in bfloat16
    compact_state: bool = False


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _group_maps(cfg: OptimizerConfig, params):
    compiled = [(re.compile(rx), ov) for rx, ov in cfg.groups]

    def resolve(path, key, default):
        for rx, ov in compiled:
            if rx.search(path):
                return ov.get(key, default)
        return default

    paths = tree_paths(params)
    lr_mults = tree_map(lambda p: resolve(p, "lr_mult", 1.0), paths)
    wds = tree_map(lambda p: resolve(p, "weight_decay", cfg.weight_decay),
                   paths)
    return lr_mults, wds


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


#: elements of a leaf the AdamW update computes at a time, so that its
#: elementwise temporaries stay this size and not the leaf's (one rank's
#: block of a stacked DeepSeek-67B projection is 6.4 GB on four ranks);
#: the arithmetic is elementwise, so the values do not depend on it
UPDATE_CHUNK = 1 << 26


def _chunks(t: torch.Tensor) -> list:
    """Slices of ``t``'s leading dim of at most ``UPDATE_CHUNK`` elements
    each (one slice of all of it for a small or 0-d leaf)."""
    if t.dim() == 0 or t.numel() <= UPDATE_CHUNK:
        return [slice(None)]
    rows = max(1, UPDATE_CHUNK // (t.numel() // t.shape[0]))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def _clipped(cfg: OptimizerConfig, grads, norm: Callable):
    gf = tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        gn = norm(gf)
        scale = torch.clamp_max(cfg.grad_clip / (gn + 1e-9), 1.0)
        gf = tree_map(lambda g: g * scale, gf)
    return gf


# ---------------------------------------------------------------------------
# AdamW.
# ---------------------------------------------------------------------------

def adamw(cfg: OptimizerConfig, schedule: Callable) -> Optimizer:
    state_dtype = torch.bfloat16 if cfg.compact_state else torch.float32

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step: int,
               norm: Callable = global_norm):
        """(updates, state); the moments are written into ``state``.
        ``norm`` gives the clip its global norm of the grads (mesh-wide
        for a placed tree: every rank must clip by the same scale)."""
        lr = _f32(schedule(step))
        lr_mults, wds = _group_maps(cfg, params)
        gf = _clipped(cfg, grads, norm)
        t = _f32(step) + 1.0
        bc1 = 1.0 - _f32(cfg.b1) ** t
        bc2 = 1.0 - _f32(cfg.b2) ** t

        def part(m, v, g, p, mult, wd):
            m.copy_((cfg.b1 * m.float() + (1 - cfg.b1) * g).to(state_dtype))
            v.copy_((cfg.b2 * v.float()
                     + (1 - cfg.b2) * torch.square(g)).to(state_dtype))
            mhat = m.float() / bc1
            vhat = v.float() / bc2
            u = mhat / (torch.sqrt(vhat) + cfg.eps)
            u = u + wd * p.float()
            return ((-lr * mult) * u).to(p.dtype)

        def upd(m, v, g, p, mult, wd):
            parts = _chunks(p)
            if len(parts) == 1:
                return part(m, v, g, p, mult, wd)
            out = torch.empty_like(p)
            for sl in parts:
                out[sl] = part(m[sl], v[sl], g[sl], p[sl], mult, wd)
            return out

        with torch.no_grad():
            updates = tree_map(upd, state["m"], state["v"], gf, params,
                               lr_mults, wds)
        return updates, state

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# SGD + momentum (the paper's CaffeNet optimizer).
# ---------------------------------------------------------------------------

def sgd_momentum(cfg: OptimizerConfig, schedule: Callable) -> Optimizer:
    def init(params):
        return {"mom": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    def update(grads, state, params, step: int,
               norm: Callable = global_norm):
        """(updates, state); the momentum is written into ``state``.
        Caffe-style: mom = mu*mom + lr_eff*(g + wd*p); p -= mom.  ``norm``
        as in AdamW's."""
        lr = _f32(schedule(step))
        lr_mults, wds = _group_maps(cfg, params)
        gf = _clipped(cfg, grads, norm)

        def upd(mom, g, p, mult, wd):
            g = g + wd * p.float()
            mom.copy_(cfg.momentum * mom + (lr * mult) * g)
            return (-mom).to(p.dtype)

        with torch.no_grad():
            updates = tree_map(upd, state["mom"], gf, params, lr_mults, wds)
        return updates, state

    return Optimizer(init=init, update=update)


def make_optimizer(cfg: OptimizerConfig, schedule: Callable) -> Optimizer:
    if cfg.kind == "adamw":
        return adamw(cfg, schedule)
    if cfg.kind == "sgd":
        return sgd_momentum(cfg, schedule)
    raise ValueError(cfg.kind)
