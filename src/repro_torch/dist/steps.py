"""Train and serve step builders (port of :mod:`repro.dist.steps`): the
train state and train step with gradient accumulation and data-parallel
gradient sums (plain, or int8 with error feedback), prefill (dense and
paged), the decode step with on-device sampling, the speculative verify
step, and the dense slot insert.

PyTorch runs eagerly, so a "step" is a plain closure over (model, cfg,
opt); there is nothing to compile.  Parameters, optimizer moments and
caches are updated in place.

Train state layout (the reference's, so checkpoints and
:mod:`repro_torch.bridge` carry it between the packages)::

    {"params": <model params>, "opt": <optimizer state>, "step": int,
     "grad_error": <per-rank int8 residuals, with compression only>}

The reference keeps ``grad_error`` as one fp32 leaf ``(dp, *param.shape)``
a parameter, row r being data rank r's residual; that is the layout of
checkpoints and of the bridge.  In memory a rank of the port holds only
its own row, ``(1, *param.shape)``.

On a mesh (``init_state(..., mesh=)``, ``make_train_step(..., mesh=)``)
the params and moments are placed at rest by
:func:`repro_torch.dist.sharding.param_specs`: a rank holds its block of
each, the model gathers a stacked layer where it slices it, and AdamW
updates the blocks in place (:mod:`repro_torch.dist.sharding`).  The
serving steps take a mesh too (``make_prefill_step(..., mesh=)``,
``make_serve_step(..., mesh=)``): params placed the same way, read
without autograd through the model-local view (each rank computing its
"model" blocks), and a decode cache placed at rest by
:func:`~repro_torch.dist.sharding.cache_specs`
(:class:`~repro_torch.dist.sharding.PlacedCache`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import DEFAULT_DEVICE
from repro_torch.dist import compression
from repro_torch.dist import sharding
from repro_torch.models import attention as attn_mod
from repro_torch.optim.optimizers import (global_norm, tree_flatten,
                                          tree_map, tree_unflatten)
from repro_torch.serving import sampler as sampler_mod


def init_state(model, cfg, opt, gen: torch.Generator,
               device=DEFAULT_DEVICE, compress_dp: int = 0,
               mesh=None) -> dict:
    """Train state: random params from ``gen``, zero moments, step 0.

    ``compress_dp > 0`` adds a ``grad_error`` tree of fp32 zeros
    ``(compress_dp, *param.shape)``: the int8 residuals of that many data
    ranks (a rank training in memory takes ``compress_dp=1``, its row).

    ``mesh`` places the state at rest: the full masters are drawn as
    without it (the same generator sequence, so the same values), this
    rank keeps its block of each and drops the full leaf as it goes, and
    the moments are made at block size.  The peak is the full masters
    plus the blocks.
    """
    params = model.init(gen, cfg, device)
    error_like = params
    if mesh is not None:
        error_like = tree_map(lambda p: p.to("meta"), params)
        params = sharding.Placement({"params": params}, mesh).place(
            params, "params")
    state = {"params": params, "opt": opt.init(params), "step": 0}
    if compress_dp > 0:
        state["grad_error"] = tree_map(
            lambda p: torch.zeros((compress_dp,) + tuple(p.shape),
                                  dtype=torch.float32, device=device),
            error_like)
    return state


def abstract_state(model, cfg, opt, compress_dp: int = 0,
                   mesh=None) -> dict:
    """:func:`init_state`'s tree on the ``meta`` device: every shape and
    dtype, no storage (one rank's blocks under ``mesh``).  The parameters
    are drawn on ``meta`` from a CPU generator, which draws nothing
    there."""
    return init_state(model, cfg, opt, torch.Generator().manual_seed(0),
                      "meta", compress_dp, mesh)


def loss_and_grads(model, cfg, params: dict, batch: dict,
                   view: Optional[Callable] = None, scale: float = 1.0,
                   **kw):
    """(loss, grads) of ``model.loss_fn`` at ``params``: grads a tree
    shaped like ``params`` (zeros for an unused leaf).  ``view(params)``,
    when given, is what the model reads (a placed tree's gathers:
    :meth:`repro_torch.dist.sharding.Placement.view`); ``kw`` goes to the
    loss (a placed step's ``rows`` and ``tp``); the grads are those of
    ``scale`` times the loss."""
    paths, leaves = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss_fn(params if view is None else view(params),
                             batch, cfg, **kw)
        grads = torch.autograd.grad(loss * scale if scale != 1 else loss,
                                    leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(paths, grads)


def tensor_split(cfg, mesh) -> sharding.TensorSplit:
    """The placed train, prefill and decode steps' tensor-parallel
    compute on ``mesh`` (:class:`~repro_torch.dist.sharding.TensorSplit`):
    every family computes on its "model" blocks."""
    return sharding.TensorSplit(mesh, cfg)


def make_train_step(model, cfg, opt, accum_steps: int = 1,
                    group: Optional[dist.ProcessGroup] = None,
                    compress: bool = False, mesh=None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` with metrics ``{loss,
    grad_norm, update_norm}`` (fp32 scalars).

    ``group`` is the data-parallel process group: every rank passes its
    own rows of the global batch, the gradients are summed over the group
    and divided by its size, and the loss is the group's mean of the
    ranks' masked means, as in the reference's data-parallel
    (``shard_map``) step.  ``compress`` sums them with
    :func:`repro_torch.dist.compression.compressed_all_reduce_tree`
    (int8 quantization with error feedback; with no group, over this
    process alone); the state must then carry this rank's ``grad_error``
    row (``init_state(..., compress_dp=1)``).

    ``mesh`` (a ``DeviceMesh`` over ``("data", "model")`` or ``("pod",
    "data", "model")``; every rank passes its rows of the global batch
    split over the row axes, ``sharding.data_specs``) takes a state
    placed at rest (``init_state(..., mesh=mesh)``) and computes the
    reference's step jitted on the whole batch: the loss is the whole
    batch's masked mean (the ranks' numerators summed over the whole
    step's count of unmasked labels, :class:`~repro_torch.dist.sharding.Rows`)
    and an MoE layer's queues and aux loss are the whole batch's; each
    rank's gradient is its rows' share, summed over the row axes.  The
    model gathers what it reads
    (:meth:`~repro_torch.dist.sharding.Placement.view`) through the
    model-local view, each rank computing its "model" blocks
    (:class:`~repro_torch.dist.sharding.TensorSplit`).  A leaf split over
    a row axis gets this rank's block of its gradient from its gather's
    backward (reduce-scattered); over each other row axis the step
    all-reduces it.  The clip and the metrics take the mesh-wide norm.  With ``compress`` (a model axis of
    1 and no pod axis above 1 only: the reference compresses over one
    data axis) the step gathers the whole tree, sums the full gradients
    by the int8 path over "data" unchanged, updates this rank's blocks
    and drops the gathered copy, as the reference's ``shard_map`` with
    replicated params does (its loss the ranks' mean, as ``group``'s).

    The parameters and moments of ``state`` are updated IN PLACE (the
    returned state holds the same tensors).  ``accum_steps > 1`` splits
    the global batch into equal micro-batches run one after another
    (live memory: one micro-batch's activations) and returns the mean
    loss and mean grads, summed in fp32 as the reference sums them (on a
    mesh the cross-entropy's numerators and counts sum over the
    micro-batches too).
    The gradients of the SELL projections come from the ACDC ops'
    ``autograd.Function``s (:mod:`repro_torch.kernels.ops`).
    """
    placement = tp = None
    row_groups = {} if group is None else {"data": group}
    if mesh is not None:
        sizes = sharding._axis_sizes(mesh)
        if compress and sizes.get("model", 1) > 1:
            raise ValueError("--compress-grads supports data-parallel "
                             "meshes only (model axis must be 1)")
        if compress and sizes.get("pod", 1) > 1:
            raise ValueError("--compress-grads sums over one data axis; "
                             "a pod axis above 1 is not supported")
        placement = sharding.Placement(abstract_state(model, cfg, opt),
                                       mesh)
        group = mesh.get_group("data")
        row_groups = {a: mesh.get_group(a)
                      for a in sharding.row_axes(mesh)}
        tp = None if compress else tensor_split(cfg, mesh)
    placed = placement is not None and not compress
    view = ((lambda p: placement.view(p, tp)) if placed else None)

    def rows_of(batch) -> Optional[sharding.Rows]:
        """A placed step's rows and its count (see ``Rows``)."""
        if not placed:
            return None
        count = (batch["labels"] >= 0).sum().to(torch.float32)
        for g in row_groups.values():
            dist.all_reduce(count, group=g)
        return sharding.Rows(mesh, torch.clamp_min(count, 1.0)
                             / accum_steps)

    def grads_of(params, batch):
        rows = rows_of(batch)
        kw, scale = {}, 1.0
        if rows is not None:
            kw["rows"], scale = rows, float(rows.n)
            if tp is not None:      # None with --compress-grads
                kw["tp"] = tp
        if accum_steps <= 1:
            return loss_and_grads(model, cfg, params, batch, view, scale,
                                  **kw)
        b = batch["tokens"].shape[0]
        if b % accum_steps:
            raise ValueError(
                f"global batch {b} not divisible by accum {accum_steps}")
        mb = b // accum_steps
        loss = grads = None
        for i in range(accum_steps):
            micro = {k: t[i * mb:(i + 1) * mb] for k, t in batch.items()}
            l, g = loss_and_grads(model, cfg, params, micro, view, scale,
                                  **kw)
            g = tree_map(lambda t: t.float(), g)
            loss = l if loss is None else loss + l
            grads = g if grads is None else tree_map(torch.add, grads, g)
        inv = 1.0 / accum_steps
        return loss * inv, tree_map(lambda t: t * inv, grads)

    dsize = 1 if group is None else dist.get_world_size(group)

    def summed_here(path: str) -> tuple:
        """The row axes leaf ``path``'s gradient is summed over by the
        step (not by its gather's backward), in mesh order.  A leaf on
        its "model" block is never summed over "model": the rank
        computed that block's gradient itself."""
        if view is None:
            return tuple(row_groups)
        split = placement.axes(f"params/{path}")
        return tuple(a for a in row_groups if a not in split)

    def row_size(axes) -> int:
        n = 1
        for a in axes:
            n *= dist.get_world_size(row_groups[a])
        return n

    def summed(loss, grads, error):
        """(mean loss, mean grads, new error rows) over the group (the
        gradients of a placed step: the ranks' shares, each scaled by the
        number of row ranks, so the mean is their sum; its loss is the
        whole batch's already)."""
        new_error = None
        if compress:
            rows = tree_flatten(error)[1]
            if any(e.shape[0] != 1 for e in rows):
                raise ValueError("grad_error must hold this rank's row "
                                 "only: (1, *param.shape) a leaf")
            grads, new_err = compression.compressed_all_reduce_tree(
                grads, tree_map(lambda e: e[0], error), group)
            grads = tree_map(lambda g: g / dsize, grads)
            new_error = tree_map(lambda e: e[None], new_err)
        elif row_groups:
            paths, leaves = tree_flatten(grads)
            out = []
            for path, g in zip(paths, leaves):
                g, axes = g.contiguous(), summed_here(path)
                for axis in axes:
                    dist.all_reduce(g, group=row_groups[axis])
                out.append(g / row_size(axes) if axes else g)
            grads = tree_unflatten(paths, out)
        if row_groups and not placed:
            loss = loss.float().clone()
            for axis in row_groups:
                dist.all_reduce(loss, group=row_groups[axis])
            loss = loss / row_size(row_groups)
        return loss, grads, new_error

    def step(state, batch):
        params = state["params"]
        if placement is not None and compress:
            full = placement.gathered(params)
            loss, grads = grads_of(full, batch)
            del full
        else:
            loss, grads = grads_of(params, batch)
        loss, grads, new_error = summed(loss, grads,
                                        state.get("grad_error"))
        norm = update_norm = global_norm
        if placement is not None:
            norm = update_norm = placement.norm()
            if compress:    # full grads, equal on every rank
                full_norm = global_norm(grads)
                grads = placement.local(grads)
                norm = lambda _: full_norm  # noqa: E731
        updates, new_opt = opt.update(grads, state["opt"], params,
                                      state["step"], norm=norm)
        with torch.no_grad():
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
        metrics = {"loss": loss.float(), "grad_norm": norm(grads),
                   "update_norm": update_norm(updates)}
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        if new_error is not None:
            new_state["grad_error"] = new_error
        return new_state, metrics

    return step

def _last_logits(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp_min(lengths.long() - 1, 0)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx]


def gather_vocab(logits: torch.Tensor,
                 tp: sharding.TensorSplit) -> torch.Tensor:
    """Logits (..., V) from this rank's block of the vocabulary (a
    placed prefill's ``full_logits``), gathered over "model"
    (no autograd); whole logits as they are."""
    if logits.shape[-1] == tp.vocab:
        return logits
    return sharding._all_gather(logits, (None,) * (logits.dim() - 1)
                                + ("model",), tp.mesh)


def _serving_placement(model, cfg, mesh) -> sharding.Placement:
    """Where the params live at rest on ``mesh`` (a serving step's)."""
    like = model.init(torch.Generator().manual_seed(0), cfg, "meta")
    return sharding.Placement({"params": like}, mesh)


def _placed_cache(cache) -> sharding.PlacedCache:
    if not isinstance(cache, sharding.PlacedCache):
        raise TypeError("a placed serving step takes a cache placed at "
                        "rest (sharding.place_cache / CachePlacement.place)")
    return cache


#: cache leaves a family's prefill reads by value when no frontend
#: embeddings come (the cross K/V it attends over)
_PREFILL_READS = {"encdec": ("xk", "xv")}


def make_prefill_step(model, cfg, full_logits: bool = False,
                      paged: bool = False, mesh=None) -> Callable:
    """``step(params, cache, tokens, lengths[, frontend_embeds]) ->
    (logits, new_cache)``.

    Runs the model over right-padded prompts and returns the logits at
    each row's last real token (B, V), or with ``full_logits`` all of
    them (B, S, V), plus a new dense cache shaped like ``cache``: K/V for
    attention, SSM and conv state for the recurrent families, both for
    the hybrid.

    ``mesh`` places the step as the reference's dry run places its
    prefill: ``params`` are this rank's blocks by ``param_specs``
    (``sharding.place_params``), read through
    :meth:`~repro_torch.dist.sharding.Placement.view` without autograd;
    ``cache`` is a :class:`~repro_torch.dist.sharding.PlacedCache`, or,
    where the family reads no value of it (every prefill but an
    encoder-decoder's without frames), its
    :class:`~repro_torch.dist.sharding.CachePlacement` alone: the new
    cache is built from the shapes, as the reference's prefill drops its
    unread input; ``tokens`` and ``frontend_embeds`` are this rank's rows
    (``data_specs``) and ``lengths`` every row's (B,), replicated.  Each
    layer's new K/V or state is cut to this rank's blocks as it is made
    (at most one layer's full leaf beyond the blocks); the new cache is a
    ``PlacedCache``.  Every family computes on its "model" blocks
    (:class:`~repro_torch.dist.sharding.TensorSplit`: heads, cross
    heads, ffn, experts, SSM heads, vocabulary): the last logits are this
    rank's rows with the vocabulary blocks of the last position gathered
    over "model" (B, V), and with ``full_logits`` this rank's rows and
    block of the vocabulary (B, S, V / model) where it splits, for the
    caller to gather (:func:`gather_vocab`).  An encoder-decoder's
    prefill with frames projects each layer's cross K/V on this rank's
    KV heads, the block the cache holds; without frames it reads the
    cache's cross K/V as this rank's block of it, split over heads or
    frames as the cache is, and feeds its heads' queries from it; an
    MoE layer queues the whole batch's tokens
    (:class:`~repro_torch.dist.sharding.DecodeSplit`).

    ``paged=True`` builds the paged admission step instead:
    ``step(params, cache, template, tokens, lengths, phys_blocks[, slot,
    frontend_embeds]) -> (last_logits, cache)`` runs the batch-1 prefill
    into a slab shaped like ``template``, scatters each ``*_pages`` leaf's
    slab IN PLACE into its pool through ``phys_blocks`` (the slot's table
    row, unmapped entries already routed to the trash page) and writes
    every batch-indexed leaf (zamba2's SSM/conv state, encdec's cross K/V
    and frame count) into row ``slot`` (:func:`write_slot`).
    """
    if model.prefill is None:
        raise ValueError(f"family {cfg.family!r} has no prefill path")

    def logits_out(logits, lengths):
        return logits if full_logits else _last_logits(logits, lengths)

    if mesh is not None:
        if paged:
            raise ValueError("a placed paged prefill is not supported: "
                             "the page pool is not placed")
        placement = _serving_placement(model, cfg, mesh)
        tp = tensor_split(cfg, mesh)

        def placed_step(params, cache, tokens, lengths,
                        frontend_embeds=None):
            reads = (_PREFILL_READS.get(cfg.family, ())
                     if frontend_embeds is None else ())
            if isinstance(cache, sharding.CachePlacement) and not reads:
                cp, like = cache, cache.rows_shapes()
            else:
                cache = _placed_cache(cache)
                cp = cache.placement
                like = (cp.rows_view(cache, reads) if reads
                        else cp.rows_shapes())
            if lengths is None:
                raise ValueError("a placed prefill takes every row's "
                                 "length (B,)")
            here = sharding.local_shard(
                lengths, sharding.rows_spec(mesh, lengths.shape[0]), mesh)
            if tokens.shape[0] != here.shape[0]:
                raise ValueError(f"tokens hold {tokens.shape[0]} rows; this "
                                 f"rank's are {here.shape[0]} of "
                                 f"{lengths.shape[0]}")
            cut = cp.cutter()
            with torch.no_grad():
                logits, new = model.prefill(
                    placement.view(params, tp), like, tokens, cfg, here,
                    frontend_embeds, cut=cut, split=cp.split(), tp=tp)
                if not full_logits:
                    logits = gather_vocab(_last_logits(logits, here), tp)
            return logits, sharding.PlacedCache(new, cut.placement_after(new))

        return placed_step

    if paged:
        if model.init_cache_paged is None:
            raise ValueError(f"family {cfg.family!r} has no paged cache")

        def paged_step(params, cache, template, tokens, lengths,
                       phys_blocks, slot: Optional[int] = None,
                       frontend_embeds=None):
            logits, slot_cache = model.prefill(params, template, tokens,
                                               cfg, lengths, frontend_embeds)
            for key, leaf in cache.items():
                if key.endswith("_pages"):
                    attn_mod.scatter_prefill_pages(
                        leaf, slot_cache[key[:-len("_pages")]], phys_blocks)
                elif slot is None:
                    raise ValueError(f"cache leaf {key!r} is batch-indexed: "
                                     f"the paged prefill needs its slot")
                else:
                    write_slot(leaf, slot_cache[key], slot)
            return _last_logits(logits, lengths), cache

        return paged_step

    def step(params, cache, tokens, lengths, frontend_embeds=None):
        logits, new_cache = model.prefill(params, cache, tokens, cfg,
                                          lengths, frontend_embeds)
        return logits_out(logits, lengths), new_cache

    return step


def make_placed_decode(model, cfg, mesh) -> Callable:
    """``decode(params, cache, tokens, position) -> (logits, blocks)``:
    one placed decode step's logits, before any sample.  ``params`` are
    this rank's blocks by ``param_specs``, read through the model-local
    view (:meth:`~repro_torch.dist.sharding.Placement.view` with the
    step's :class:`~repro_torch.dist.sharding.TensorSplit`) without
    autograd; ``cache`` a :class:`~repro_torch.dist.sharding.PlacedCache`,
    updated in place; ``tokens`` and ``position`` every row's (B,),
    replicated.  Each rank decodes its rows on its block of the cache
    (:class:`~repro_torch.dist.sharding.DecodeSplit`) and its "model"
    blocks of the weights; ``logits`` are this rank's rows (B / rows, V)
    with the vocabulary gathered over "model" (:func:`gather_vocab`),
    ``blocks`` its new cache blocks (a dict)."""
    placement = _serving_placement(model, cfg, mesh)
    tp = tensor_split(cfg, mesh)

    def decode(params, cache, tokens, position):
        cache = _placed_cache(cache)
        spec = sharding.rows_spec(mesh, tokens.shape[0])
        with torch.no_grad():
            logits, new = model.decode_step(
                placement.view(params, tp), cache,
                sharding.local_shard(tokens, spec, mesh),
                sharding.local_shard(position, spec, mesh), cfg,
                split=cache.placement.split(), tp=tp)
            return gather_vocab(logits, tp), new

    return decode


def make_serve_step(model, cfg, sample: str = "greedy",
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 0.0, paged: bool = False,
                    mesh=None) -> Callable:
    """``step(params, cache, tokens, position, generator) -> (next,
    cache)``, or with ``paged=True`` ``step(params, cache, tokens,
    position, block_tables, generator)``: one decode step and a sample.

    ``mesh`` places it as the reference's dry run places its decode:
    ``params`` this rank's blocks (read without autograd), ``cache`` a
    :class:`~repro_torch.dist.sharding.PlacedCache` placed by
    :func:`~repro_torch.dist.sharding.cache_specs`, ``tokens`` and
    ``position`` every row's, replicated.  Each rank decodes its rows on
    its block of the cache
    (:class:`~repro_torch.dist.sharding.DecodeSplit`: its K/V and SSM
    heads where they split over "model", its block of a sequence split
    over the row axes, the blocks' softmax terms combined over them) and
    computes on its "model" blocks of the weights, as the reference's
    jit computes on ``param_specs``' blocks
    (:class:`~repro_torch.dist.sharding.TensorSplit`: query and KV heads,
    ffn columns, experts, SSM heads, the vocabulary; ``wo``'s, ``wd``'s
    and ``out_proj``'s rows complete a layer over "model"); the logits'
    vocabulary blocks are gathered before the sample
    (:func:`make_placed_decode`), and the next tokens are gathered to
    every row's.  A placement that no step reads raises
    :class:`~repro_torch.dist.sharding.CacheSplitError`, naming the
    leaf.  A sampled (``temp``) placed step draws a row's token once, on
    the first rank of its "model" group from that rank's ``generator``,
    and gives it to the others, so every block of the row writes the
    same token's K/V."""
    if sample not in ("greedy", "temp"):
        raise ValueError(f"unknown sampler {sample!r}")

    def _sample(logits, generator: Optional[torch.Generator]):
        return sampler_mod.sample(logits, method=sample,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, generator=generator)

    if mesh is not None:
        if paged:
            raise ValueError("a placed paged decode is not supported: the "
                             "page pool is not placed")
        decode = make_placed_decode(model, cfg, mesh)
        one_draw = (sample == "temp"
                    and sharding._axis_sizes(mesh).get("model", 1) > 1)

        def placed_step(params, cache, tokens, position, generator=None):
            logits, new = decode(params, cache, tokens, position)
            nxt = _sample(logits, generator)
            if one_draw:    # the first model rank's draw, everywhere
                nxt = sharding._all_gather(nxt[None], ("model",), mesh)[0]
            nxt = sharding._all_gather(
                nxt, sharding.rows_spec(mesh, tokens.shape[0]), mesh)
            return nxt, sharding.PlacedCache(new, cache.placement)

        return placed_step

    if paged:
        if model.decode_step_paged is None:
            raise ValueError(
                f"family {cfg.family!r} has no paged decode path")

        def paged_step(params, cache, tokens, position, block_tables,
                       generator=None):
            logits, cache = model.decode_step_paged(
                params, cache, tokens, position, block_tables, cfg)
            return _sample(logits, generator), cache

        return paged_step

    def step(params, cache, tokens, position, generator=None):
        logits, cache = model.decode_step(params, cache, tokens, position,
                                          cfg)
        return _sample(logits, generator), cache

    return step


def make_verify_step(model, cfg, sample: str = "greedy",
                     temperature: float = 1.0, top_k: int = 0,
                     top_p: float = 0.0, paged: bool = False,
                     park: Optional[int] = None) -> Callable:
    """The speculative verify step: append k+1 tokens a slot, score them,
    accept, commit.

    ``step(params, cache, tokens (B, k+1), drafts (B, k), draft_logits
    (B, k, V) | None, position (B,)[, block_tables], generator) ->
    (accepted (B,), out_tokens (B, k+1), cache)``

    ``tokens`` is ``[pending, d_1 .. d_k]`` a row; the model's
    ``verify_step`` scores every position against the cache (set-written
    in place), acceptance is exact match (greedy) or rejection sampling
    (temp, :mod:`repro_torch.spec.verify`, drawing from ``generator``),
    and ``out_tokens[:, :n+1]`` is the committed stream (accepted drafts
    plus the correction or bonus token at index n).  KV rows past the
    accepted frontier stay written and are rewound by position; the
    recurrent leaves of the ssm and hybrid families are re-selected at
    each row's accepted length from the verify's snapshots, and ``park``
    is the engine's parked-row sentinel (rows at or beyond it, free or
    stalled, commit 0 tokens).
    ``paged=True`` verifies through the paged-attention kernel at
    T = k + 1.
    """
    from repro_torch.spec import verify as verify_mod

    if sample not in ("greedy", "temp"):
        raise ValueError(f"unknown sampler {sample!r}")
    vfn = model.verify_step_paged if paged else model.verify_step
    if vfn is None:
        raise ValueError(
            f"family {cfg.family!r} has no "
            f"{'paged ' if paged else ''}speculative verify path")

    def _accept_commit(logits, states, cache, drafts, draft_logits,
                       position, generator):
        if sample == "greedy":
            n, nxt = verify_mod.greedy_accept(logits, drafts)
        else:
            n, nxt = verify_mod.rejection_accept(
                generator, logits, draft_logits, drafts,
                temperature=temperature, top_k=top_k, top_p=top_p)
        out = verify_mod.committed_tokens(drafts, n, nxt)
        if states is not None:
            advancing = (position < park) if park is not None else True
            n_adv = torch.where(advancing, n + 1, torch.zeros_like(n))
            cache = verify_mod.commit_states(cache, states, n_adv)
        return n, out, cache

    if paged:
        def paged_step(params, cache, tokens, drafts, draft_logits,
                       position, block_tables, generator=None):
            logits, cache, states = vfn(params, cache, tokens, position,
                                        block_tables, cfg)
            return _accept_commit(logits, states, cache, drafts,
                                  draft_logits, position, generator)

        return paged_step

    def step(params, cache, tokens, drafts, draft_logits, position,
             generator=None):
        logits, cache, states = vfn(params, cache, tokens, position, cfg)
        return _accept_commit(logits, states, cache, drafts, draft_logits,
                              position, generator)

    return step


def write_slot(leaf: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """Write the batch-1 cache leaf ``new`` into batch row ``slot`` of
    ``leaf`` IN PLACE: a layer-stacked leaf (L, B, ...) at ``[:, slot]``,
    a per-slot vector (B,) (encdec's frame count ``xlen``) at ``[slot]``.
    A leaf shorter than the slot on an axis (encdec's cross K/V holding a
    request's F frames in a slot sized for more) fills the leading
    entries, as the reference's ``dynamic_update_slice`` does."""
    if leaf.dim() == 1:
        leaf[slot] = new[0]
        return
    src = new[:, 0]
    dst = leaf[:, slot]
    dst[tuple(slice(0, n) for n in src.shape)] = src.to(leaf.dtype)


def make_insert_step() -> Callable:
    """``insert(cache, slot_cache, slot)``: write a batch-1 slot cache
    into batch row ``slot`` of the decode cache, in place
    (:func:`write_slot` a leaf)."""

    def insert(cache, slot_cache, slot: int):
        for key, leaf in cache.items():
            write_slot(leaf, slot_cache[key], slot)
        return cache

    return insert
