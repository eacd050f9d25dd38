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
decide whether a batch's rows split over "data".

The runtime half places a train state at rest by :func:`param_specs` on a
``("data", "model")`` or ``("pod", "data", "model")`` ``DeviceMesh``, as
the reference's jit places it by ``param_shardings``: ZeRO-3 over "data"
(features, SELL diagonals) and shards over "model" (heads, ffn, vocab,
experts); no parameter splits over "pod".  Each rank keeps its
block of every parameter and moment (:func:`local_shard`,
:func:`place_state`); the model gathers a leaf where it is used
(:func:`gather`, differentiable), one stacked layer at a time
(:class:`PlacedStack`, read by ``models.transformer.layer_params``).  The
gather's backward differs by axis: over "data" the ranks hold different
rows, so the gradient is reduce-scattered (summed) and divided by the
data size; over "model" the ranks of one data row compute the same loss,
so the gradient is sliced, never summed.

Tensor-parallel compute (:class:`TensorSplit`, the placed train,
prefill and decode steps of every family: the decoders, ssm, hybrid and
the encoder-decoder): a leaf the model computes on its "model" block (heads,
KV heads, the encoder's and the cross-attention's heads, ffn columns,
experts, SSM heads' ``out_proj`` rows, vocabulary) is gathered over the
row axes only and keeps that block (the model-local view,
``Placement.view(params, split)``); its gather's backward reduce-scatters
over the row axes and never slices over "model".  The activations move
instead, by two differentiable collectives over "model":
:meth:`TensorSplit.copy` (forward identity, backward all-reduce) before a
projection whose output columns split, :meth:`TensorSplit.reduce`
(forward all-reduce, backward identity) after one whose input rows split.
"""

from __future__ import annotations

import math
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import (global_norm, tree_flatten,
                                          tree_map, tree_paths)

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
        shape = _shape(leaf)
        return spec_for(mesh, shape,
                        cache_logical(path.split("/")[-1], len(shape)))
    return tree_map(one, cache, tree_paths(cache))


def cache_logical(name: str, nd: int) -> Tuple[Optional[str], ...]:
    """The logical axes of an ``nd``-dim cache leaf ``name``
    (:func:`cache_specs`' rule)."""
    if name in _KV_NAMES and nd == 5:
        return (None, "batch", "seq", "heads", None)
    if name == "ssm" and nd == 5:
        return (None, "batch", "heads", None, None)
    return ((None, "batch") + (None,) * max(nd - 2, 0))[:nd]


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


# ---------------------------------------------------------------------------
# Placement at rest: this rank's blocks and the gathers.
# ---------------------------------------------------------------------------

#: the mesh axes a batch's rows split over: a gradient is summed over these
ROW_AXES = RULES["batch"]


def row_axes(mesh) -> tuple:
    """The row axes of ``mesh`` (``ROW_AXES`` it has), major first."""
    return tuple(a for a in ROW_AXES if a in _axis_sizes(mesh))


def rows_spec(mesh, batch: int) -> Spec:
    """The spec of a ``(batch,)`` vector of a batch's rows
    (:func:`data_specs`' rule): split over the row axes when they divide
    it, else replicated."""
    return spec_for(mesh, (batch,), ("batch",))


#: top-level subtrees of stacked layers (leading L axis), gathered one
#: layer at a time; every other subtree is gathered once a step
STACKED = ("layers", "encoder", "decoder")


def _axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _padded(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def shard_slices(shape: Sequence[int], spec: Spec, sizes: Mapping,
                 coord: Mapping) -> tuple:
    """The block (one slice a dim) that the device at mesh coordinate
    ``coord`` ({axis: index}) holds of a ``shape`` leaf placed by
    ``spec``: a dim split over axes (a0, a1), major first, is cut into
    ``sizes[a0] * sizes[a1]`` equal blocks and the device holds block
    ``coord[a0] * sizes[a1] + coord[a1]``, as the reference's
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives it."""
    out = []
    for dim, entry in zip(shape, _padded(spec, len(shape))):
        n, idx = 1, 0
        for axis in _axes(entry):
            n *= sizes[axis]
            idx = idx * sizes[axis] + coord[axis]
        size = dim // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` leaf."""
    sizes = _axis_sizes(mesh)
    return tuple(d // math.prod(sizes[a] for a in _axes(e))
                 for d, e in zip(shape, _padded(spec, len(shape))))


def _stacked(path: str) -> bool:
    """Whether state leaf ``path`` (``params/...``, ``opt/<moment>/...``)
    belongs to a stacked-layer subtree."""
    segs = path.split("/")
    return segs[2 if segs[0] == "opt" else 1] in STACKED


def _coord(mesh) -> dict:
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def local_shard(full, spec: Spec, mesh):
    """This rank's block of ``full`` (a view; an int leaf as it is)."""
    if not isinstance(full, torch.Tensor):
        return full
    return full[shard_slices(full.shape, spec, _axis_sizes(mesh),
                             _coord(mesh))]


def _all_gather(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's block (minor axis of a dim first)."""
    x = local
    for dim, entry in enumerate(_padded(spec, local.dim())):
        for axis in reversed(_axes(entry)):
            group = mesh.get_group(axis)
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim)
    return x


def _grad_block(grad: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The gradient of this rank's block from the full leaf's gradient:
    over a row axis reduce-scattered (summed) and divided by its size
    (the mean), over any other axis sliced (every rank of it computed the
    same gradient)."""
    sizes = _axis_sizes(mesh)
    ranks = 1
    for dim, entry in enumerate(_padded(spec, grad.dim())):
        for axis in _axes(entry):
            chunks = torch.split(grad, grad.shape[dim] // sizes[axis], dim)
            if axis in ROW_AXES:
                out = torch.empty_like(chunks[0],
                                       memory_format=torch.contiguous_format)
                dist.reduce_scatter(out, [c.contiguous() for c in chunks],
                                    group=mesh.get_group(axis))
                grad, ranks = out, ranks * sizes[axis]
            else:
                grad = chunks[mesh.get_local_rank(axis)]
    return grad / ranks if ranks > 1 else grad


class _Gather(torch.autograd.Function):
    """``_all_gather`` forward, ``_grad_block`` backward."""

    @staticmethod
    def forward(ctx, local, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _all_gather(local, spec, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _grad_block(grad, ctx.spec, ctx.mesh), None, None


def gather(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf of ``local`` blocks placed by ``spec``,
    differentiable: its backward gives this rank's block of the mean
    gradient over the row axes the leaf is split over (the train step
    sums it over the other row axes)."""
    return _Gather.apply(local, tuple(spec), mesh)


def without(spec: Spec, axis: str) -> Spec:
    """``spec`` with mesh axis ``axis`` taken out of every entry (a dim
    it split stays at its block size when gathered by the rest)."""
    def one(entry):
        kept = tuple(a for a in _axes(entry) if a != axis)
        return kept[0] if len(kept) == 1 else (kept or None)
    return tuple(one(e) for e in spec)


def _all_reduce(x: torch.Tensor, mesh, axes: tuple,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` over each mesh axis of ``axes`` (a copy)."""
    x = x.contiguous().clone()
    for axis in axes:
        dist.all_reduce(x, op=op, group=mesh.get_group(axis))
    return x


class _Copy(torch.autograd.Function):
    """Forward identity, backward the gradient summed over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    """Forward the sum over ``axes``, backward identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class PlacedStack:
    """A stacked-layer subtree at rest: this rank's blocks of every
    ``(L, ...)`` leaf beside their specs (the leading axis never split).
    :meth:`layer` gathers layer ``i``."""

    def __init__(self, local: dict, specs: dict, mesh):
        self.local, self.specs, self.mesh = local, specs, mesh

    def layer(self, i: int) -> dict:
        return tree_map(lambda t, s: gather(t[i], s[1:], self.mesh),
                        self.local, self.specs)


class Placement:
    """Where each leaf of a train state lives at rest on ``mesh`` (a
    ``DeviceMesh`` over ("data", "model") or ("pod", "data", "model")):
    the specs of
    :func:`param_specs` over the FULL state ``like`` (shapes only: a
    ``meta`` tree does), by state path (``params/...``, ``opt/m/...``).
    A ``grad_error`` subtree is left out: each rank keeps its own row."""

    def __init__(self, like: dict, mesh):
        like = {k: v for k, v in like.items() if k != "grad_error"}
        self.mesh = mesh
        self.sizes = _axis_sizes(mesh)
        paths, specs = tree_flatten(param_specs(like, mesh))
        self.specs = dict(zip(paths, specs))
        self.shapes = {p: _shape(leaf)
                       for p, leaf in zip(*tree_flatten(like))}

    def axes(self, path: str) -> set:
        """The mesh axes (of any size) leaf ``path`` is split over."""
        return {a for e in self.specs[path] for a in _axes(e)}

    def _by_path(self, fn, tree, prefix: str):
        return tree_map(lambda leaf, p: fn(leaf, f"{prefix}/{p}"), tree,
                        tree_paths(tree))

    def place(self, tree: dict, prefix: str) -> dict:
        """This rank's blocks of the full ``tree`` at ``prefix`` (``params``,
        ``opt``), each copied out; the tree's full leaves are dropped one
        by one as their blocks are made, so the peak is the full tree plus
        the blocks."""
        for key in list(tree):
            path = f"{prefix}/{key}"
            if isinstance(tree[key], dict):
                tree[key] = self.place(tree[key], path)
            else:
                tree[key] = local_shard(tree[key], self.specs[path],
                                        self.mesh).clone(
                    memory_format=torch.contiguous_format)
        return tree

    def local(self, tree: dict, prefix: str = "params") -> dict:
        """Views of this rank's blocks of a full tree."""
        return self._by_path(
            lambda t, p: local_shard(t, self.specs[p], self.mesh), tree,
            prefix)

    def view(self, params: dict, split: Optional["TensorSplit"] = None
             ) -> dict:
        """The model's view of this rank's blocks ``params``: stacked
        subtrees as :class:`PlacedStack` (a layer gathered where the
        model slices it), every other leaf gathered now (differentiable).
        With ``split`` (the model-local view) a leaf that ``split.keeps``
        is gathered over its other axes only and keeps its "model"
        block."""
        def spec_of(path: str) -> Spec:
            spec = self.specs[path]
            if split is not None and split.keeps(path, spec):
                return without(spec, "model")
            return spec

        out = {}
        for key, sub in params.items():
            specs = self._by_path(lambda _, p: spec_of(p), sub,
                                  f"params/{key}")
            if key in STACKED:
                out[key] = PlacedStack(sub, specs, self.mesh)
            else:
                out[key] = tree_map(lambda t, s: gather(t, s, self.mesh),
                                    sub, specs)
        return out

    def gathered(self, tree: dict, prefix: str = "params") -> dict:
        """The full tree of this rank's blocks (no autograd), gathered
        leaf by leaf on every rank."""
        with torch.no_grad():
            return self._by_path(
                lambda t, p: _all_gather(t, self.specs[p], self.mesh), tree,
                prefix)

    def to_host(self, tree: dict, prefix: str, keep: bool) -> Optional[dict]:
        """The full tree on the host where ``keep`` (else None): gathered
        one leaf at a time, a stacked leaf one layer at a time, so a card
        holds one layer of one leaf beyond its blocks.  Every rank calls
        it."""
        def one(t, path):
            spec = self.specs[path]
            if not _stacked(path):
                full = _all_gather(t, spec, self.mesh)
                return full.cpu() if keep else None
            host = (torch.empty(self.shapes[path], dtype=t.dtype)
                    if keep else None)
            for i in range(t.shape[0]):
                full = _all_gather(t[i], spec[1:], self.mesh)
                if keep:
                    host[i].copy_(full)
            return host

        with torch.no_grad():
            return self._by_path(one, tree, prefix)

    def reduce_sums(self, prefix: str) -> Callable:
        """``reduce(paths, sums) -> sums`` for
        :func:`repro_torch.optim.optimizers.global_norm`: each leaf's
        partial sum over this rank's block completed over the axes the
        leaf is split over (a replicated leaf counts once)."""
        def reduce(paths: List[str], sums: list) -> list:
            sums = list(sums)
            by_axes: dict = {}
            for i, path in enumerate(paths):
                axes = tuple(a for a in self.mesh.mesh_dim_names
                             if a in self.axes(f"{prefix}/{path}"))
                if axes:
                    by_axes.setdefault(axes, []).append(i)
            for axes, idx in by_axes.items():
                vec = torch.stack([sums[i] for i in idx])
                for axis in axes:
                    dist.all_reduce(vec, group=self.mesh.get_group(axis))
                for i, v in zip(idx, vec.unbind()):
                    sums[i] = v
            return sums
        return reduce

    def norm(self, prefix: str = "params") -> Callable:
        """The mesh-wide global norm of a tree of this rank's blocks (each
        element counted once), for the clip and the step's metrics."""
        reduce = self.reduce_sums(prefix)
        return lambda tree: global_norm(tree, reduce)

    def shard_array(self, path: str, arr):
        """This rank's block of a full host array of state leaf ``path``
        (its spec from the array's own shape: a checkpoint saved at any
        mesh restores onto this one)."""
        spec = spec_for(self.mesh, arr.shape,
                        logical_axes_for(path, arr.ndim))
        return arr[shard_slices(arr.shape, spec, self.sizes,
                                _coord(self.mesh))]

    def nbytes(self, state: dict, full: bool = False) -> int:
        """Bytes of the tensor leaves of ``state`` (keys ``params``,
        ``opt``: this rank's blocks), or of their full leaves."""
        paths, leaves = tree_flatten(state)
        return sum((math.prod(self.shapes[p]) if full else t.numel())
                   * t.element_size() for p, t in zip(paths, leaves)
                   if isinstance(t, torch.Tensor))


def place_state(state: dict, mesh) -> dict:
    """``state`` (full leaves) placed at rest: this rank's blocks of the
    params and of the optimizer moments (each moment takes its
    parameter's spec through its ``opt/m/...`` path); ``step`` and a
    ``grad_error`` row as they are.  The full leaves are dropped from
    ``state``'s own dicts as their blocks are made."""
    placement = Placement(state, mesh)
    out = dict(state)
    out["params"] = placement.place(state["params"], "params")
    out["opt"] = placement.place(state["opt"], "opt")
    return out


def place_params(params: dict, mesh) -> dict:
    """``params`` (full leaves) placed at rest by :func:`param_specs`:
    this rank's blocks, each copied out as its full leaf is dropped."""
    return Placement({"params": params}, mesh).place(params, "params")


# ---------------------------------------------------------------------------
# A decode cache at rest.
# ---------------------------------------------------------------------------

def shape_only(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` that holds one element
    (a broadcast view): read for its shape and dtype only, it adds
    nothing to what the dry run's ``LiveBytes`` counts."""
    return torch.empty((), dtype=dtype, device="meta").expand(tuple(shape))


class CacheSplitError(ValueError):
    """A decode asked of a placed cache with a leaf split where no step
    reads it: every dim of a leaf may split only as :func:`cache_specs`
    splits it (the batch over the row axes the step's rows split over, a
    K/V leaf's sequence over row axes, K/V or SSM heads over "model").
    ``leaf`` and ``spec`` name the first other leaf."""

    def __init__(self, leaf: str, spec: Spec):
        self.leaf, self.spec = leaf, tuple(spec)
        super().__init__(
            f"cache leaf {leaf!r} is placed {self.spec}: a placed decode "
            f"reads a leaf split over the row axes on its batch or "
            f"sequence dim and over \"model\" on its heads dim only")


def _placed_logical(name: str, nd: int) -> Tuple[Optional[str], ...]:
    """:func:`cache_logical`, but a per-slot vector (B,) (the port's own
    ``xlen``: the reference has no such leaf, and :func:`cache_specs`'
    generic rule reads its one dim as a layer axis) goes with its rows."""
    return ("batch",) if nd == 1 else cache_logical(name, nd)


class CachePlacement:
    """Where each leaf of a decode cache lives at rest on ``mesh``: the
    specs of :func:`cache_specs` over the FULL cache ``like`` (shapes
    only: a ``meta`` tree does), by leaf name; a per-slot vector (B,)
    splits with the rows (:func:`_placed_logical`)."""

    def __init__(self, like: dict, mesh):
        self.mesh = mesh
        self.sizes = _axis_sizes(mesh)
        self.shapes = {k: _shape(v) for k, v in like.items()}
        self.dtypes = {k: v.dtype for k, v in like.items()}
        self.specs = {k: spec_for(mesh, shape,
                                  _placed_logical(k, len(shape)))
                      for k, shape in self.shapes.items()}

    def place(self, cache: dict) -> "PlacedCache":
        """This rank's blocks of the full ``cache``, each copied out."""
        return PlacedCache({k: local_shard(t, self.specs[k], self.mesh)
                            .clone(memory_format=torch.contiguous_format)
                            for k, t in cache.items()}, self)

    def _split_axes(self, name: str) -> list:
        """(logical axis, mesh axes of size > 1) of each dim of leaf
        ``name``."""
        logical = _placed_logical(name, len(self.shapes[name]))
        return [(lg, tuple(a for a in _axes(e) if self.sizes[a] > 1))
                for lg, e in zip(logical, _padded(self.specs[name],
                                                  len(logical)))]

    def rows_only(self, name: str) -> bool:
        """Whether leaf ``name`` splits over row axes on its batch dim
        only (its block is the full leaf on this rank's rows; an axis of
        size 1 splits nothing)."""
        return all(not axes or (lg == "batch" and set(axes) <= set(ROW_AXES))
                   for lg, axes in self._split_axes(name))

    def split(self) -> "DecodeSplit":
        """What a decode reads of this rank's blocks (raises
        :class:`CacheSplitError` for a placement no step reads)."""
        return DecodeSplit(self)

    def rows_shapes(self) -> dict:
        """Every leaf as a ``meta`` tensor at its full size on this
        rank's rows: what a prefill that reads no leaf's values takes
        (its shapes and dtypes only)."""
        out = {}
        for k, shape in self.shapes.items():
            shape = list(shape)
            b = _placed_logical(k, len(shape)).index("batch")
            shape[b] = local_shape(shape, self.specs[k], self.mesh)[b]
            out[k] = shape_only(shape, self.dtypes[k])
        return out

    def rows_view(self, blocks: dict, reads=()) -> dict:
        """What a prefill reads of a placed cache: each leaf at its full
        size on this rank's rows, a leaf of ``reads`` (read by value
        through a :class:`DecodeSplit`) as this rank's block; any other
        leaf split beyond the rows stands as a ``meta`` tensor of that
        size (only its shape and dtype are read)."""
        out = {}
        for k, t in blocks.items():
            if self.rows_only(k) or k in reads:
                out[k] = t
            else:
                shape = list(self.shapes[k])
                b = _placed_logical(k, len(shape)).index("batch")
                shape[b] = t.shape[b]
                out[k] = torch.empty(shape, dtype=t.dtype, device="meta")
        return out

    def cutter(self) -> "LayerCut":
        return LayerCut(self)


class Blocks:
    """A dim split in ``n`` blocks over the mesh ``axes`` (of size > 1,
    major first): this rank holds block ``index``, and :meth:`gather`
    stacks a tensor of every block's rank (the ranks that share this
    rank's coordinates on every other axis) in block order."""

    def __init__(self, mesh, axes: tuple):
        sizes, coord = _axis_sizes(mesh), _coord(mesh)
        self.mesh, self.axes = mesh, tuple(axes)
        self.n, self.index = 1, 0
        for a in self.axes:
            self.n *= sizes[a]
            self.index = self.index * sizes[a] + coord[a]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _all_gather(x[None], (self.axes,), self.mesh)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every block's rank, differentiable: the
        backward hands this rank the whole gradient of the sum, so each
        rank's gradient is its own blocks' share and the ranks' gradients
        add up to the whole batch's."""
        if not self.axes:
            return x
        return _Reduce.apply(x, self.mesh, self.axes)


class Rows(Blocks):
    """A placed train step's batch split over the row axes (of size > 1),
    with ``count``: the divisor of a loss's numerator, the whole step's
    count of unmasked label positions over every row and micro-batch
    (at least 1) divided by the number of micro-batches.  A loss is then
    its numerator summed over the rows (:meth:`Blocks.sum`) over
    ``count``, the reference's masked mean over the whole batch, and the
    mean over micro-batches the step takes is the masked mean over all
    of them."""

    def __init__(self, mesh, count: torch.Tensor):
        sizes = _axis_sizes(mesh)
        super().__init__(mesh, tuple(a for a in ROW_AXES
                                     if sizes.get(a, 1) > 1))
        self.count = count


class TensorSplit:
    """Tensor-parallel compute over "model" for the placed train,
    prefill and decode steps of every family (the decoders, ssm, hybrid
    and the encoder-decoder), as the reference's jit computes them on
    ``param_specs``' blocks: query heads, KV heads, ffn columns, experts,
    SSM heads and the vocabulary on this rank's "model" block.  A placed
    decode's heads are the block its cache holds
    (:class:`DecodeSplit`): ``cache_specs`` splits KV heads over "model"
    where they divide it, as :attr:`kv_heads` does, and SSM heads where
    they divide it, as :attr:`ssm_split` does; the models check that the
    two blocks agree.

    :meth:`keeps` says which leaves the model-local view
    (``Placement.view(params, split)``) keeps as their block, by path:
    ``wq`` / ``wo`` where the heads divide "model"; ``wk`` / ``wv`` where
    the KV heads do too (else they are gathered whole and each rank
    projects every KV head and keeps those its query heads read); the
    same for the encoder-decoder's ``encoder/attn``, ``decoder/attn`` and
    ``decoder/cross`` (the cross K/V then on the rank's KV heads, the
    block ``cache_specs`` gives the cache's ``xk`` / ``xv``); a dense
    ``wg`` / ``wu`` / ``wd``; an expert stack split on its expert dim;
    a mamba layer's dense ``out_proj`` where the SSM heads divide "model"
    (its rows are ``d_inner`` in head order, so its block is this rank's
    heads'); the embedding table.  Every other leaf is gathered whole (the
    router: its softmax is over all experts; a mamba ``in_proj``, whose
    "model" block of ``[z | x | B | C | dt]`` columns does not line up
    with heads; Zamba2's shared ``in_proj``, whose output is the residual
    stream; SELL projections are never split over "model").  The model
    reads which block it holds from the leaf's shape; :meth:`block` gives
    its slice, :meth:`ssm_block` its SSM heads.  On a "model" axis of
    size 1 the collectives are identities."""

    def __init__(self, mesh, cfg):
        sizes = _axis_sizes(mesh)
        self.mesh, self.n = mesh, sizes.get("model", 1)
        self.index = mesh.get_local_rank("model") if self.n > 1 else 0
        self.axes = ("model",) if self.n > 1 else ()
        self.heads = cfg.n_heads % self.n == 0
        self.kv_heads = self.heads and cfg.n_kv_heads % self.n == 0
        self.vocab = cfg.vocab_size
        # SSM heads split as cache_specs splits the ssm leaf's heads
        self.ssm_heads = (cfg.d_inner_ // cfg.ssm_head_dim
                          if cfg.family in ("ssm", "hybrid") else 0)
        self.ssm_split = self.ssm_heads > 0 and self.ssm_heads % self.n == 0

    def keeps(self, path: str, spec: Spec) -> bool:
        """Whether the model computes leaf ``path`` (placed by ``spec``)
        on its "model" block."""
        if not any("model" in _axes(e) for e in spec):
            return False
        segs = path.split("/")
        parent = segs[-2] if len(segs) > 1 else ""
        if "sell" in segs:
            return False
        if parent in ("wq", "wo"):
            return self.heads
        if parent == "out_proj":
            return self.ssm_split
        if parent in ("wk", "wv"):
            return self.kv_heads
        if parent in ("wg", "wu", "wd"):
            return "experts" not in segs or "model" in _axes(spec[-3])
        return segs[-1] == "table" and segs[-2] == "embed"

    def ssm_block(self) -> Optional[slice]:
        """This rank's SSM heads (a slice), or None where a mamba layer
        computes every head (no split, or heads that do not divide
        "model": the reference's divisibility fallback)."""
        if not self.axes or not self.ssm_split:
            return None
        return self.block(self.ssm_heads, self.ssm_heads // self.n)

    def block(self, full: int, local: int) -> slice:
        """The slice of a dim of ``full`` entries this rank holds when it
        holds ``local`` of them (all of them, or its "model" block)."""
        if local == full:
            return slice(0, full)
        if local * self.n != full:
            raise ValueError(f"a block of {local} of {full} does not split "
                             f"{full} over {self.n} model ranks")
        return slice(self.index * local, (self.index + 1) * local)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is; its gradient summed over "model" (the input of
        a projection whose output columns this rank computes a block
        of)."""
        return _Copy.apply(x, self.mesh, self.axes) if self.axes else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (this rank's partial sum) summed over "model"; its
        gradient as it is."""
        return _Reduce.apply(x, self.mesh, self.axes) if self.axes else x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` (this rank's block along ``dim``) gathered over "model"
        in block order, differentiable (its backward slices this rank's
        block: every model rank computes the same gradient of it)."""
        if not self.axes:
            return x
        dim = dim % x.dim()
        return gather(x, (None,) * dim + ("model",), self.mesh)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over "model" (no gradient)."""
        if not self.axes:
            return x
        return _all_reduce(x.detach(), self.mesh, self.axes,
                           dist.ReduceOp.MAX)


class LeafSplit:
    """This rank's block of one cache leaf beyond its rows, as the models
    read it: ``heads`` the leaf's heads it holds (a slice, None for all)
    and ``seq`` the key positions it holds (a slice, None for all).
    :meth:`gather_heads` and :meth:`gather_blocks` are the collectives a
    model completes a head-parallel or sequence-parallel step with."""

    def __init__(self, mesh, heads: Optional[slice], seq: Optional[slice],
                 seq_axes: tuple):
        self.mesh, self.heads, self.seq = mesh, heads, seq
        self._seq_blocks = Blocks(mesh, seq_axes)

    def gather_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` computed on this rank's heads, gathered over "model"
        along ``dim`` in head order (as it is without a head split)."""
        if self.heads is None:
            return x
        return _all_gather(x, (None,) * dim + ("model",), self.mesh)

    def gather_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every rank holding a block of this rank's heads and
        rows, stacked on a new leading dim in sequence order."""
        return self._seq_blocks.gather(x)


class DecodeSplit:
    """Where a decode reads each leaf of a placed cache
    (:meth:`CachePlacement.split`): :meth:`leaf` gives a leaf's
    :class:`LeafSplit`, or None where the leaf splits over the rows on
    its batch dim only (the models then read it as an unplaced cache).
    Every leaf must split as :func:`cache_specs` splits it: its batch
    over the row axes the step's rows split over (:func:`rows_spec`), a
    K/V sequence over row axes, K/V or SSM heads over "model"; any other
    split raises :class:`CacheSplitError`.  ``rows`` is the step's batch
    split over the row axes (:class:`Blocks`; None when every rank holds
    every row): a layer that mixes the batch's tokens (the MoE's capacity
    queues) completes its step over them."""

    def __init__(self, placement: CachePlacement):
        mesh, sizes = placement.mesh, placement.sizes
        coord = _coord(mesh)
        self.leaves: dict = {}
        self.rows = None
        for name, shape in placement.shapes.items():
            dims = placement._split_axes(name)
            batch = shape[[lg for lg, _ in dims].index("batch")]
            rows = tuple(a for a in _axes(rows_spec(mesh, batch)[0])
                         if sizes[a] > 1)
            if rows:
                self.rows = Blocks(mesh, rows)
            allowed = {"batch": rows, "seq": tuple(ROW_AXES),
                       "heads": ("model",)}
            for lg, axes in dims:
                if axes and (lg not in allowed
                             or not set(axes) <= set(allowed[lg])
                             or (lg == "batch" and axes != rows)):
                    raise CacheSplitError(name, placement.specs[name])
            if placement.rows_only(name):
                self.leaves[name] = None
                continue
            index = shard_slices(shape, placement.specs[name], sizes, coord)
            got = {lg: (index[d], axes) for d, (lg, axes) in enumerate(dims)
                   if axes and lg in ("heads", "seq")}
            heads, _ = got.get("heads", (None, ()))
            seq, seq_axes = got.get("seq", (None, ()))
            self.leaves[name] = LeafSplit(mesh, heads, seq, seq_axes)

    def leaf(self, name: str) -> Optional[LeafSplit]:
        return self.leaves[name]


class LayerCut:
    """``cut(name, layer)``: this rank's block of one layer's new cache
    leaf ``layer`` (computed on this rank's rows, so its batch dim is
    already local), copied out so the full layer can be freed; the spec
    is :func:`cache_specs`' for the stacked leaf of the placement's depth
    and global batch and ``layer``'s other dims (a prefill may bring more
    cross frames than the cache held).  ``heads_local``: ``layer``
    already holds this rank's "model" block of its heads (K/V projected
    on their block, :class:`TensorSplit`), which must be the block the
    placement gives it.  ``shapes`` records each stacked leaf's full
    shape."""

    def __init__(self, placement: CachePlacement):
        self.placement = placement
        self.shapes: dict = {}

    def __call__(self, name: str, layer: torch.Tensor,
                 heads_local: bool = False) -> torch.Tensor:
        pl = self.placement
        depth, batch = pl.shapes[name][:2]
        full = [depth, batch] + list(layer.shape[1:])
        logical = _placed_logical(name, len(full))
        if heads_local:
            full[logical.index("heads")] *= pl.sizes.get("model", 1)
        full = tuple(full)
        self.shapes[name] = full
        spec = spec_for(pl.mesh, full, logical)
        coord = _coord(pl.mesh)
        index = list(shard_slices(full, spec, pl.sizes, coord)[2:])
        if heads_local:
            h = logical.index("heads")
            if "model" not in _axes(spec[h]) and pl.sizes.get("model", 1) > 1:
                raise ValueError(f"cache leaf {name!r} is placed {spec}: "
                                 f"its heads do not split over \"model\" as "
                                 f"the K/V heads computed here do")
            index[h - 2] = slice(0, layer.shape[h - 1])
        if all(s.start == 0 and s.stop == n
               for s, n in zip(index, layer.shape[1:])):
            return layer
        return layer[(slice(None),) + tuple(index)].clone(
            memory_format=torch.contiguous_format)

    def placement_after(self, cache: dict) -> CachePlacement:
        """The placement of a prefill's new cache: the leaves this cut
        made at their recorded full shapes, the others as before."""
        like = {k: shape_only(self.shapes.get(k, self.placement.shapes[k]),
                              cache[k].dtype) for k in cache}
        return CachePlacement(like, self.placement.mesh)


class PlacedCache(dict):
    """A decode cache at rest: this rank's blocks of every leaf, by name,
    beside their :class:`CachePlacement` (``placement``)."""

    def __init__(self, blocks: dict, placement: CachePlacement):
        super().__init__(blocks)
        self.placement = placement


def place_cache(cache: dict, mesh) -> PlacedCache:
    """``cache`` (full leaves) placed at rest by :func:`cache_specs`."""
    return CachePlacement(cache, mesh).place(cache)
