"""Weights from ``--seed``, made on the device and handed alike to the
program and to the reference.

The shapes are the program's parameter tree (its ``init`` traced on the
``meta`` device, which allocates nothing); every value is the
benchmark's own draw.  Each leaf (a whole stack of layers or experts)
is one ``randn`` call from a generator of its own, seeded from the run's
seed and the leaf's path, so any leaf can be made again alone: the
reference remakes the weights after the window instead of keeping a
copy.  The distributions are the model's own initialisation:

* ``sell/a``, ``sell/d`` (ACDC diagonals): ``1 + sell_init_std N(0, 1)``
  (the paper's identity plus noise);
* a norm's ``scale``: zeros (the norms multiply by ``1 + scale``);
* ``embed/table`` and the router: ``N(0, 1) / sqrt(d_model)``;
* any other matrix ``w`` (n_in, n_out): ``N(0, 1) / sqrt(n_in)``.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

Shapes = Dict[str, Tuple[int, ...]]


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit generator seed for leaf ``path`` of run ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def make_leaf(path: str, shape: Tuple[int, ...], seed: int, cfg: dict,
              device) -> torch.Tensor:
    """Leaf ``path`` of run ``seed``, fp32 on ``device``."""
    if path.endswith("scale") or path.endswith("sell/bias"):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    if path.endswith("sell/a") or path.endswith("sell/d"):
        return t.mul_(cfg["sell_init_std"]).add_(1.0)
    if path == "embed/table" or path.endswith("router/w"):
        return t.mul_(cfg["d_model"] ** -0.5)
    if path.endswith("/w"):
        return t.mul_(shape[-2] ** -0.5)
    raise ValueError(f"no initialisation for leaf {path!r}")


def make(shapes: Shapes, seed: int, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``shapes`` (a flat ``{path: shape}``)."""
    return {path: make_leaf(path, shape, seed, cfg, device)
            for path, shape in shapes.items()}


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """A nested dict as ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat: Dict[str, object]) -> dict:
    """The inverse of :func:`flatten`."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
