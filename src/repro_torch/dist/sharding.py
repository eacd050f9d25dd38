"""Logical-axis sharding rules for the model zoo (port of
:mod:`repro.dist.sharding`).

One small engine resolves every placement decision:

    spec_for(mesh, shape, logical) -> spec

A spec is a tuple with one entry a dimension: ``None`` (replicated), a
mesh axis name, or a tuple of names (the dimension split over several
axes, major first) — the reference's ``PartitionSpec``.  A mesh is a
``{axis: size}`` mapping or a ``torch.distributed.DeviceMesh``.

``logical`` names the TRAILING dims of ``shape`` (leading extra dims — the
stacked-layer axis — are never sharded: every device runs every layer).
Each logical axis maps to an ordered tuple of mesh axes (``RULES``);
resolution applies three safeguards, in order:

* **presence** — rule axes missing from the mesh are dropped (the same
  rules serve the pod-less 2-axis host mesh and the 3-axis multi-pod mesh);
* **uniqueness** — a mesh axis is claimed at most once per array, first
  claim (leftmost logical dim) wins: expert weights claim "model" before
  the ffn dim can, and a sequence dim only takes "data" when the batch dim
  could not (batch=1 long-context decode);
* **divisibility** — the dim must divide evenly over the claimed axes,
  otherwise the dim falls back to replicated.

On top of the engine, :func:`param_specs` walks a model/optimizer state
tree and assigns logical axes by parameter role (path pattern), as the
reference does.  :func:`placements` turns a spec into DTensor placements
for one ``DeviceMesh``.  The train launcher reads :func:`data_specs` to
decide whether a batch's rows split over "data"; placing parameters at
rest by :func:`param_specs` waits for the next slice (ROADMAP.md), so
parameters stay replicated on every data rank.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.optim.optimizers import tree_map, tree_paths

# logical axis -> ordered mesh-axis candidates
RULES = {
    "batch": ("pod", "data"),
    "seq": ("pod", "data"),
    "vocab": ("model",),
    "embed": ("data",),
    "ffn": ("model",),
    "heads": ("model",),
    "expert": ("model",),
    "sell": ("data",),
}

Spec = Tuple[Optional[object], ...]


def _axis_sizes(mesh) -> dict:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(mesh, shape: Sequence[int],
             logical: Sequence[Optional[str]]) -> Spec:
    """Resolve the spec of ``shape`` under ``mesh``.

    ``logical`` covers the trailing ``len(logical)`` dims; leading dims are
    unsharded (stacked-layer convention).
    """
    sizes = _axis_sizes(mesh)
    lead = len(shape) - len(logical)
    if lead < 0:
        raise ValueError(f"logical {logical} longer than shape {shape}")
    assignment: list = [None] * len(shape)
    claimed: set = set()
    for i, name in enumerate(logical):
        if name is None:
            continue
        cand = tuple(a for a in RULES.get(name, ())
                     if a in sizes and a not in claimed)
        if not cand:
            continue
        total = math.prod(sizes[a] for a in cand)
        if total <= 0 or shape[lead + i] % total != 0:
            continue  # divisibility fallback: replicate this dim
        assignment[lead + i] = cand[0] if len(cand) == 1 else cand
        claimed.update(cand)
    return tuple(assignment)


# ---------------------------------------------------------------------------
# Role resolution: state-tree path -> logical axes.
# ---------------------------------------------------------------------------

# projections whose weight is (in, out) with OUT being the model dim
_IN_PROJ = {"wq", "wk", "wv", "wg", "wu", "in_proj", "router"}
# projections whose weight is (in, out) with IN being the model dim
_OUT_PROJ = {"wo", "wd", "out_proj"}


def logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Trailing logical axes for one parameter leaf (by role pattern).

    Works on raw param trees and on optimizer-state trees (the "opt/m/..."
    prefix leaves the role suffix intact, so moments inherit their
    parameter's placement).
    """
    segs = path.split("/")
    name = segs[-1]
    parent = segs[-2] if len(segs) > 1 else ""
    if name == "table" and parent == "embed":
        return ("vocab", "embed")
    if "sell" in segs:
        # O(N) structured params: ZeRO-3 shard the feature dim over "data",
        # replicate the stacked (L, K) leading dims.
        return ("sell",) if ndim >= 1 else ()
    if ndim < 2:
        return ()  # scalars, norms, biases, conv taps: replicated
    if name in ("w", "u", "v") or parent in _IN_PROJ | _OUT_PROJ:
        expert = ("expert",) if "experts" in segs else ()
        if parent in _OUT_PROJ:
            trail = ("heads", "embed") if parent == "wo" else ("ffn", "embed")
        elif parent in ("wq", "wk", "wv"):
            trail = ("embed", "heads")
        else:
            trail = ("embed", "ffn")
        return expert + trail
    return ()


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(tree: dict, mesh) -> dict:
    """Same-structure tree of specs for a param/state tree (tensors on any
    device, ``meta`` too; a Python int leaf is a scalar)."""
    def one(leaf, path):
        shape = _shape(leaf)
        return spec_for(mesh, shape, logical_axes_for(path, len(shape)))
    return tree_map(one, tree, tree_paths(tree))


# ---------------------------------------------------------------------------
# Batch and cache placement.
# ---------------------------------------------------------------------------

def data_specs(mesh, batch: dict) -> dict:
    """Batch leaves shard dim 0 over ("pod", "data"); the rest is local.
    A leaf may be a tensor or a shape tuple."""
    def one(leaf):
        shape = leaf if isinstance(leaf, tuple) else _shape(leaf)
        return spec_for(mesh, shape, ("batch",) + (None,) * (len(shape) - 1))
    return tree_map(one, batch)


_KV_NAMES = {"k", "v", "xk", "xv", "attn_k", "attn_v"}


def cache_specs(cache: dict, mesh) -> dict:
    """Decode-cache placement: batch over "data", heads over "model".

    KV caches are (L, B, S, H, Dh); when the batch dim cannot shard
    (batch=1 long-context) the sequence dim takes the data shards instead
    — that falls out of the first-claim-wins engine, no special case.
    SSM states are (L, B, H, P, N) and conv windows (L, B, W-1, C).
    """
    def one(leaf, path):
        name = path.split("/")[-1]
        shape = _shape(leaf)
        nd = len(shape)
        if name in _KV_NAMES and nd == 5:
            logical = (None, "batch", "seq", "heads", None)
        elif name == "ssm" and nd == 5:
            logical = (None, "batch", "heads", None, None)
        else:
            logical = ((None, "batch") + (None,) * max(nd - 2, 0))[:nd]
        return spec_for(mesh, shape, logical)
    return tree_map(one, cache, tree_paths(cache))


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one
    a mesh dimension, ``Shard(d)`` where tensor dim ``d`` claims that
    axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                owner[axis] = dim
    return [Shard(owner[a]) if a in owner else Replicate()
            for a in mesh.mesh_dim_names]
