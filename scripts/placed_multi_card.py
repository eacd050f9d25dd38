"""Train full-width configs with the state placed at rest across the
cards of one host, one process a card, and report each rank's memory and
step time.

    torchrun --standalone --nproc-per-node 4 scripts/placed_multi_card.py \\
        --train qwen3_1_7b:2:3 --train deepseek_67b:1:3 \\
        --out chiprun_out/placed_multi_card.json

Each ``--train ARCH:MODEL_PARALLEL:STEPS[:OPTION...]`` builds the train
launcher's pieces (``launch.train.build``: ``--sell acdc --sell-method
pallas``, batch 4 x 128 split over "data", the (data, model) mesh of the
world size and MODEL_PARALLEL) and trains STEPS steps from seed 0 with no
checkpoint; an OPTION is a compute dtype that overrides the config's
(``float32``, ``bfloat16``), a SELL kind (``dense``: plain projections,
which split over "model"; ``acdc``) or a sequence length (an integer,
e.g. 256: Mamba2's and Zamba2's SSD chunk).  Per rank: the bytes of its
params and moments at rest (and the full state's), the peak memory of
the placed init and of the steps
(``torch.cuda.max_memory_allocated``), the losses and the s/step of the
steps after the first.  ``--replicated ARCH`` also trains that config
with its whole state on every rank, data-parallel over the same mesh's
"data" group and rows (what placement changes), and, where that group
holds more than one rank, on rank 0 alone over the whole global batch
(the other ranks wait), for the losses to compare: the placed losses
within ``POD_LOSS_RTOL`` of the data-parallel ones (every family at
MODEL_PARALLEL > 1 computes on its "model" blocks: tensor-parallel;
Seamless-M4T's rows bring SEQ / 4 stub frames each, as the train
launcher gives them).  Rank 0 prints a line a run and writes every rank's
numbers, with the card's name and power limit, to ``--out``.

``--train`` runs come first, then ``--serve``, ``--serve-long`` and
``--pod-train``.  ``--serve ARCH[:MODEL_PARALLEL[:dense]]`` serves ARCH
placed at (data = world / MODEL_PARALLEL, model = MODEL_PARALLEL; 1 by
default; ``acdc`` on ``pallas``, or ``dense`` projections, which split
over "model" where ``acdc``'s SELL ones run whole): a ``full_logits``
prefill of 4 prompts (64 positions, ragged; an encoder-decoder's with
``SERVE_FRAMES`` stub frames each) and 8 greedy decode steps through
``make_prefill_step(mesh=)`` /
``make_serve_step(mesh=)`` on a cache placed by ``cache_specs`` (K/V or
SSM heads over "model" where they divide it: head-parallel decode; every
rank computing its "model" blocks of the weights: tensor-parallel), in
fp32 and in bf16 compute, beside the same steps unplaced on rank 0
alone (the ``full_logits`` prefill's logits at every real position held
too, beside one card's prefill of each row alone).  ``--serve-long ARCH:MODEL_PARALLEL`` serves one row the same
way on an 8192-position cache (its sequence split over "data"): a
4090-token prompt, then 12 decode steps through position 4101, across
the blocks' boundary at 4096 for two data ranks.  The placed decode
step after the streams is counted by the dry run's ``Collectives``
(``step_collectives``).  Held: the fp32 logits
of every row, at the prefill's last token and at one more decode step
after the streams, within ``SERVE_FP32_ATOL`` of one card's; the streams
(both dtypes) equal or departing first at a near-tie (the two tokens'
one-card fp32 logits apart by no more than the two sides' largest logit
difference at the prefill; what follows a near-tie is reported, not
held).  Controls beside the decode step's: one card's step taken again
on each row alone (its sums in another order) and, for Mamba2, the
whole decode on one card with each layer's recurrence in MODEL_PARALLEL
head blocks (the placed steps' sums without their collectives).  ``--pod-train
ARCH:STEPS`` trains ARCH with its state placed at (pod 2, data world/2,
model 1), the rows split over ("pod", "data") as (world, 1) splits them,
beside the same steps at (world, 1): losses within ``POD_LOSS_RTOL``.
Each placed run is set beside the dry run's reckoning of the same cell
at the same mesh, traced on meta tensors in a subprocess with its own
fake group (``launch/dryrun.py --reckon``; ``acdc`` on ``auto``: the
kernel wrappers have no meta implementation) and held by
``dryrun.compare``: the pod run's first step's collectives and argument
bytes, counted on rank 0 by the dry run's ``Collectives`` (the
FLOP counter is left off: it runs the decompositions of ops it has no
formula for, which moves the step's numbers); for serving, the
same prefill cell at (world, 1) (prompts as long as its cache, as the
dry run's cells are), or the same decode cell (4 rows, an 80-position
cache, bf16) where MODEL_PARALLEL > 1 (``acdc`` runs only), built by
``build_cell`` on the cards and measured there by
``dryrun.measure_on_device``: FLOPs,
collectives, argument and output bytes, and the peak above the
arguments within ``dryrun.PEAK_REL`` of
``torch.cuda.max_memory_allocated``'s.  ``--cell
ARCH:KIND:SEQ:BATCH:MESH[:DTYPE]`` (after the rest) builds that dry-run
cell on the cards the same way and holds it against its reckoning: a
train cell's step or a prefill cell's at any mesh of the world.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist import steps as steps_mod  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim.optimizers import tree_map  # noqa: E402

#: the device the ranks train on (a rehearsal on the CPU sets "cpu")
DEVICE = "cuda"
#: placed fp32 logits against one card's (PERF.md §2, stated before the
#: first four-card run)
SERVE_FP32_ATOL = 1e-4
#: pod-placed losses against (world, 1) data parallelism, relative
POD_LOSS_RTOL = 1e-4
#: the serving cells: rows, prompt positions, cache length, decode steps
SERVE_ROWS, SERVE_LEN, SERVE_CACHE, SERVE_STEPS = 4, 64, 80, 8
#: an encoder-decoder's stub frames a served row (the serve launcher's)
SERVE_FRAMES = 16
#: the long row: prompt positions, cache length, decode steps
LONG_LEN, LONG_CACHE, LONG_STEPS = 4090, 8192, 12


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def launcher_args(arch: str, model_parallel: int, steps: int,
                  sell: str = "acdc", seq_len: int = 128):
    return train.parse_args([
        "--arch", arch, "--sell", sell, "--sell-method", "pallas",
        "--global-batch", "4", "--seq-len", str(seq_len), "--steps",
        str(steps), "--model-parallel", str(model_parallel), "--device",
        DEVICE])


def train_spec(spec: str) -> dict:
    """``ARCH:MODEL_PARALLEL:STEPS[:OPTION...]`` -> :func:`placed_run`'s
    keywords (see the module's docstring)."""
    arch, mp, n, *opts = spec.split(":")
    out = dict(arch=arch, model_parallel=int(mp), steps=int(n))
    for opt in opts:
        if opt.isdigit():
            out["seq_len"] = int(opt)
        elif opt in ("float32", "bfloat16"):
            out["dtype"] = opt
        else:
            out["sell"] = opt
    return out


def train_steps(step_fn, state, batch_at, n: int) -> tuple:
    """(state, losses, seconds a step) of n synchronised steps."""
    losses, secs = [], []
    for s in range(n):
        batch = {k: t.to(DEVICE) for k, t in batch_at(s).items()}
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    return state, losses, secs


def placed_run(arch: str, model_parallel: int, steps: int,
               dtype: str = "", sell: str = "acdc",
               seq_len: int = 128) -> tuple:
    """(this rank's numbers, (cfg, model, opt, the batch source));
    ``dtype`` overrides the compute dtype."""
    args = launcher_args(arch, model_parallel, steps, sell, seq_len)
    cfg, model, opt, step_fn, pipeline = train.build(args)
    dp = pipeline.dp
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        step_fn = steps_mod.make_train_step(model, cfg, opt, mesh=dp.mesh)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = steps_mod.init_state(model, cfg, opt, gen, DEVICE, mesh=dp.mesh)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    at_rest = {k: state[k] for k in ("params", "opt")}
    out = dict(rank=dist.get_rank(),
               coord=[dp.mesh.get_local_rank(a) for a in ("data", "model")],
               mesh=list(dp.mesh.shape),
               rest_bytes=dp.placement.nbytes(at_rest),
               full_bytes=dp.placement.nbytes(at_rest, full=True),
               allocated_at_rest=torch.cuda.memory_allocated(),
               init_peak=init_peak)
    del at_rest
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs = train_steps(step_fn, state, pipeline.batch_at,
                                      steps)
    out.update(step_peak=torch.cuda.max_memory_allocated(), losses=losses,
               s_per_step=sum(secs[1:]) / max(len(secs) - 1, 1),
               step_s=secs)
    del state
    torch.cuda.empty_cache()
    return out, (cfg, model, opt, pipeline)


def replicated_run(pieces, steps: int, group=None) -> dict:
    """The whole state: data-parallel over ``group`` on this rank's rows,
    or (no group) this process alone on the whole global batch."""
    cfg, model, opt, pipeline = pieces
    step_fn = steps_mod.make_train_step(model, cfg, opt, group=group)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = steps_mod.init_state(model, cfg, opt, gen, DEVICE)
    state, losses, secs = train_steps(
        step_fn, state, pipeline.batch_at if group is not None
        else pipeline.source.batch_at, steps)
    out = dict(losses=losses,
               s_per_step=sum(secs[1:]) / max(len(secs) - 1, 1),
               peak=torch.cuda.max_memory_allocated())
    del state
    torch.cuda.empty_cache()
    return out


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def serve_spec(arch: str, world: int, model_parallel: int = 1) -> str:
    """The dry run's cell of a ``--serve`` run: its bf16 prefill at
    (world, 1), prompts as long as their cache (as the dry run's are);
    with a model axis, its bf16 decode at (world / model, model)."""
    if model_parallel == 1:
        return f"{arch}:prefill:{SERVE_LEN}:{SERVE_ROWS}:{world}x1:bfloat16"
    return (f"{arch}:decode:{SERVE_CACHE}:{SERVE_ROWS}:"
            f"{world // model_parallel}x{model_parallel}:bfloat16")


def pod_spec(arch: str, world: int) -> str:
    """The dry run's cell of a ``--pod-train`` run's step."""
    return f"{arch}:train:128:4:2x{world // 2}x1"


def card_record(spec: str) -> dict:
    """The dry run's cell ``spec`` built by ``build_cell`` on the cards
    (``acdc`` on ``auto``) and measured there by the dry run's counters
    (:func:`repro_torch.launch.dryrun.measure_on_device`).  Every rank
    calls it."""
    arch, cell, shape, overrides = dryrun.parse_reckon(spec)
    fn, args = dryrun.build_cell(arch, cell, dryrun.mesh_of(shape, DEVICE),
                                 sell="acdc", cfg_overrides=overrides,
                                 device=DEVICE)
    rec = dryrun.measure_on_device(fn, args)
    del fn, args
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return rec


def _decode_logits(model, cfg, params, cache, tok, pos, mesh=None,
                   coll=None):
    """One more decode step's logits (every row's), fed ``tok`` at
    ``pos``: unplaced, or the logits ``make_serve_step(mesh=)`` samples
    from (``steps.make_placed_decode``: each rank's rows on its block of
    the cache and its "model" blocks of the weights; counted by ``coll``,
    a ``dryrun.Collectives``, when given), gathered to every row's."""
    with torch.no_grad():
        if mesh is None:
            return model.decode_step(params, cache, tok, pos, cfg)[0]
        decode = steps_mod.make_placed_decode(model, cfg, mesh)
        with coll if coll is not None else contextlib.nullcontext():
            logits, _ = decode(params, cache, tok, pos)
        spec = sharding.rows_spec(mesh, tok.shape[0])
        return sharding._all_gather(logits.float().contiguous(), spec, mesh)


def _ssm_blocks_step(cfg, params, cache, tok, n_blocks: int):
    """Mamba2's decode step (``models.mamba2.decode_step``) on one card,
    each layer's recurrence run on ``n_blocks`` contiguous head blocks of
    the state one after another, their outputs and states joined in head
    order: the head-blocked recurrence of a placed step at model =
    ``n_blocks``, without its collectives (and with the gated norm and
    ``out_proj`` whole).  Updates ``cache`` in place; returns the logits."""
    from repro_torch.models import mamba2
    from repro_torch.models.common import embed_lookup, rms_norm, unembed
    from repro_torch.models.transformer import layer_params
    size = cfg.d_inner_ // cfg.ssm_head_dim // n_blocks
    x = embed_lookup(params["embed"], tok[:, None], cfg.compute_dtype)
    with torch.no_grad():
        for i in range(cfg.n_layers):
            layer = layer_params(params["layers"], i)
            h = rms_norm(x, layer["norm"]["scale"], cfg.norm_eps)
            z, xbc, dt = mamba2._split_proj(layer["mixer"], h, cfg)
            ys, states = [], []
            for j in range(n_blocks):
                hs = slice(j * size, (j + 1) * size)
                y, ssm, conv = mamba2._recur(
                    layer["mixer"], xbc, dt,
                    cache["ssm"][i][:, hs].contiguous(), cache["conv"][i],
                    cfg, heads=hs)
                ys.append(y.reshape(*y.shape[:2], size, cfg.ssm_head_dim))
                states.append(ssm)
            cache["ssm"][i] = torch.cat(states, dim=1)
            cache["conv"][i] = conv
            y = torch.cat(ys, dim=2).flatten(2)
            x = x + mamba2._gate_out(layer["mixer"], y, z, cfg)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return unembed(params["embed"], x)[:, 0]


def serve_run(arch: str, dtype: str, model_parallel: int = 1,
              long: bool = False, sell: str = "acdc") -> dict:
    """Placed serving at (world / model_parallel, model_parallel) and, on
    rank 0, the unplaced steps; rank 0 gets the comparison."""
    cfg = registry.get_config(arch)
    if sell == "acdc":
        cfg = registry.with_sell(cfg, "acdc", method="pallas")
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = get_model(cfg)
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = dryrun.mesh_of((world // model_parallel, model_parallel), DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                        DEVICE)
    gen = torch.Generator().manual_seed(1)
    if long:
        b, plen, cache_len, n_steps = 1, LONG_LEN, LONG_CACHE, LONG_STEPS
        lengths = torch.tensor([plen], dtype=torch.int32, device=DEVICE)
    else:
        b, plen, cache_len, n_steps = (SERVE_ROWS, SERVE_LEN, SERVE_CACHE,
                                       SERVE_STEPS)
        lengths = torch.tensor([64, 50, 64, 37][:b], dtype=torch.int32,
                               device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                           dtype=torch.int32).to(DEVICE)
    frames = (torch.randn(b, SERVE_FRAMES, cfg.d_model, generator=gen)
              .to(DEVICE) if cfg.frontend == "audio" else None)

    def frames_of(rows):
        return None if frames is None else frames[rows]

    def steps_of(m):
        return (steps_mod.make_prefill_step(model, cfg, full_logits=True,
                                            mesh=m),
                steps_mod.make_serve_step(model, cfg, mesh=m))

    def decode(serve, p, cache, first):
        pos, tok, stream, secs = lengths.clone(), first, [first], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            tok, cache = serve(p, cache, tok, pos)
            _sync()
            secs.append(time.perf_counter() - t0)
            pos = pos + 1
            stream.append(tok)
        return torch.stack(stream, 1).cpu(), secs, cache, tok, pos

    prefill, serve = steps_of(mesh)
    placed_p = sharding.place_params(tree_map(torch.clone, params), mesh)
    cache = sharding.place_cache(model.init_cache(cfg, b, cache_len,
                                                  device=DEVICE), mesh)
    spec = sharding.rows_spec(mesh, b)
    rows = sharding.local_shard(torch.arange(b), spec, mesh)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.perf_counter()
    logits, cache = prefill(placed_p, cache, tokens[rows.to(DEVICE)],
                            lengths, frames_of(rows.to(DEVICE)))
    _sync()
    prefill_s = time.perf_counter() - t0
    # a tensor-parallel prefill's full logits are this rank's block of
    # the vocabulary
    logits = steps_mod.gather_vocab(logits,
                                    steps_mod.tensor_split(cfg, mesh))
    last = logits[torch.arange(len(rows)), lengths[rows.to(DEVICE)].long()
                  - 1].float()
    full_last = sharding._all_gather(last.contiguous(), spec, mesh)
    full_logits = (None if long else sharding._all_gather(
        logits.float().contiguous(), tuple(spec) + (None, None), mesh))
    first = full_last.argmax(-1)
    del logits
    streams, secs, cache, tok, pos = decode(serve, placed_p, cache, first)
    coll = dryrun.Collectives()
    step_logits = _decode_logits(model, cfg, placed_p, cache, tok, pos,
                                 mesh, coll)
    out = dict(mesh=list(mesh.shape), rows=rows.tolist(),
               specs={k: list(v) for k, v in cache.placement.specs.items()},
               prefill_s=prefill_s,
               decode_s=sum(secs[1:]) / max(len(secs) - 1, 1),
               peak=(torch.cuda.max_memory_allocated()
                     if DEVICE == "cuda" else 0),
               streams=streams.tolist(), step_collectives=coll.record())
    del placed_p, cache
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        prefill, serve = steps_of(None)
        cache = model.init_cache(cfg, b, cache_len, device=DEVICE)
        with torch.no_grad():
            one_logits, cache = prefill(params, cache, tokens, lengths,
                                        frames)
            one_last = one_logits[torch.arange(b), lengths.long()
                                  - 1].float()
            one_full = None if long else one_logits.float()
            del one_logits
            if one_full is not None:
                # control: one card's prefill of each row alone (its sums
                # in another order), at every real position
                out["prefill_rows_alone_max_abs"] = max(
                    float((prefill(params, model.init_cache(
                        cfg, 1, cache_len, device=DEVICE),
                        tokens[r:r + 1], lengths[r:r + 1],
                        frames_of(slice(r, r + 1)))[0][0, :n]
                        .float() - one_full[r, :n]).abs().max())
                    for r, n in enumerate(lengths.tolist()))
            blocks = None
            if cfg.family == "ssm" and model_parallel > 1:
                # control: the whole decode in head blocks on one card
                ctl = {k: v.clone() for k, v in cache.items()}
                tok, ctl_stream = one_last.argmax(-1), []
                for _ in range(n_steps + 1):
                    ctl_stream.append(tok)
                    blocks = _ssm_blocks_step(cfg, params, ctl, tok,
                                              model_parallel).float()
                    tok = blocks.argmax(-1)
                ctl_stream = torch.stack(ctl_stream, 1).cpu().tolist()
                del ctl
            one_streams, one_secs, cache, one_tok, one_pos = decode(
                serve, params, cache, one_last.argmax(-1))
            alone = [{k: (v[r:r + 1] if v.dim() == 1 else v[:, r:r + 1])
                      .clone() for k, v in cache.items()} for r in range(b)]
            one_step = _decode_logits(model, cfg, params, cache, one_tok,
                                      one_pos).float()
            # control: the same step on each row alone (one card's sums
            # in another order)
            one_rows = torch.cat([_decode_logits(
                model, cfg, params, c, one_tok[r:r + 1],
                one_pos[r:r + 1]).float() for r, c in enumerate(alone)])
            del alone
        out["one_card"] = dict(streams=one_streams.tolist(),
                               decode_s=sum(one_secs[1:])
                               / max(len(one_secs) - 1, 1))
        diff = (full_last - one_last).abs()
        out["last_logits_max_abs"] = float(diff.max())
        if full_logits is not None:     # every real position's
            real = (torch.arange(plen, device=DEVICE)[None, :]
                    < lengths[:, None])
            gap = (full_logits - one_full).abs().amax(-1) * real
            worst = int(gap.argmax())
            out["full_logits_max_abs"] = float(gap.max())
            out["full_logits_worst"] = [worst // plen, worst % plen]
        same = streams.tolist() == one_streams.tolist()
        out["step_logits_max_abs"] = (float((step_logits - one_step).abs()
                                            .max()) if same else None)
        out["rows_alone_max_abs"] = float((one_rows - one_step).abs().max())
        if blocks is not None:      # Mamba2: the placed steps' sums
            out["head_blocks"] = dict(
                streams_equal=ctl_stream == streams.tolist(),
                vs_one_card=float((blocks - one_step).abs().max()),
                vs_placed=(float((blocks - step_logits).abs().max())
                           if same else None))
        if dtype == "float32":
            out["logits_ok"] = bool(
                diff.max() <= SERVE_FP32_ATOL
                and out.get("full_logits_max_abs", 0.0) <= SERVE_FP32_ATOL
                and (not same or out["step_logits_max_abs"]
                     <= SERVE_FP32_ATOL))
        out["streams_held"] = hold_streams(
            model, cfg, params, tokens, lengths, streams, one_streams,
            float(diff.max()), frames)
        del cache
    del params
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def hold_streams(model, cfg, params, tokens, lengths, placed, one,
                 drift: float, frames=None) -> dict:
    """The bf16 streams: equal, or a row's first difference a near-tie
    (the two tokens' fp32 logits after that context, one card, apart by
    at most ``drift``; an encoder-decoder's row with its ``frames``)."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    rows = []
    for r in range(placed.shape[0]):
        a, b = placed[r].tolist(), one[r].tolist()
        if a == b:
            rows.append(dict(equal=True))
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        n = int(lengths[r])
        ctx = tokens[r, :n].tolist() + b[:j]
        toks = torch.tensor([ctx], dtype=torch.int32, device=DEVICE)
        cache = model.init_cache(f32, 1, len(ctx), device=DEVICE)
        with torch.no_grad():
            logits, _ = model.prefill(params, cache, toks, f32,
                                      torch.tensor([len(ctx)],
                                                   dtype=torch.int32,
                                                   device=DEVICE),
                                      None if frames is None
                                      else frames[r:r + 1])
        gap = abs(float(logits[0, -1, a[j]] - logits[0, -1, b[j]]))
        rows.append(dict(equal=False, first_difference=j, tokens=[a[j],
                                                                  b[j]],
                         gap=gap, drift=drift, near_tie=gap <= drift))
    return dict(rows=rows, held=all(r["equal"] or r["near_tie"]
                                    for r in rows))


def pod_train(arch: str, n_steps: int) -> dict:
    """``arch`` trained placed at (pod 2, data world/2, model 1) and
    replicated data-parallel over (world, 1), the same rows a rank, from
    the same seed."""
    world = dist.get_world_size()
    args = launcher_args(arch, 1, n_steps)
    cfg, model, opt, _, pipeline = train.build(args)
    out = {}
    for tag, shape in (("pod", (2, world // 2, 1)),
                       ("replicated", (world, 1))):
        mesh = dryrun.mesh_of(shape, DEVICE)
        placed = tag == "pod"
        step = (steps_mod.make_train_step(model, cfg, opt, mesh=mesh)
                if placed else steps_mod.make_train_step(
                    model, cfg, opt, group=mesh.get_group("data")))
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        state = steps_mod.init_state(model, cfg, opt, gen, DEVICE,
                                     mesh=mesh if placed else None)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        losses, secs, rec = [], [], None
        for s in range(n_steps):
            batch = {k: t.to(DEVICE)
                     for k, t in pipeline.source.batch_at(s).items()}
            specs = sharding.data_specs(mesh, batch)
            rows = {k: sharding.local_shard(t, specs[k], mesh).contiguous()
                    for k, t in batch.items()}
            _sync()
            t0 = time.perf_counter()
            if s == 0:
                # collectives only: FlopCounterMode runs the decompositions
                # of ops it has no formula for, which moves the numbers
                coll = dryrun.Collectives()
                rec = {"memory": {"argument_size_in_bytes":
                                  dryrun.tensor_bytes((state, rows))}}
                with coll:
                    state, met = step(state, rows)
                rec["collectives"] = coll.record()
            else:
                state, met = step(state, rows)
            _sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
        out[tag] = dict(mesh=list(shape), losses=losses,
                        s_per_step=sum(secs[1:]) / max(len(secs) - 1, 1),
                        peak=(torch.cuda.max_memory_allocated()
                              if DEVICE == "cuda" else 0),
                        record=rec)
        del state
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        out["pod"]["losses"], out["replicated"]["losses"]))
    out.update(loss_rel=rel, losses_ok=rel <= POD_LOSS_RTOL)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="append", default=[],
                    help="ARCH:MODEL_PARALLEL:STEPS[:DTYPE] (repeatable;"
                         " not --run, which torchrun takes for --run-path)")
    ap.add_argument("--serve", action="append", default=[],
                    help="ARCH[:MODEL_PARALLEL[:dense]] served placed at "
                         "(world / MODEL_PARALLEL, MODEL_PARALLEL); 1 and "
                         "acdc by default")
    ap.add_argument("--serve-long", action="append", default=[],
                    help="ARCH:MODEL_PARALLEL: one row on an 8192-position "
                         "cache, a 4090-token prompt, 12 decode steps")
    ap.add_argument("--pod-train", action="append", default=[],
                    help="ARCH:STEPS trained at (2, world/2, 1) beside "
                         "(world, 1)")
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:KIND:SEQ:BATCH:MESH[:DTYPE]",
                    help="the dry run's cell built on the cards and held "
                         "against its reckoning at that mesh")
    ap.add_argument("--replicated", action="append", default=[],
                    help="ARCH also trained on rank 0 alone")
    ap.add_argument("--out", default="chiprun_out/placed_multi_card.json")
    args = ap.parse_args()
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("placed_multi_card: no CUDA device", file=sys.stderr)
        return 2
    mesh_mod.init_process_group(DEVICE)
    rank = dist.get_rank()
    if DEVICE == "cuda":        # one build, before any timed call
        if rank == 0:
            build.build_all()
        dist.barrier()
    report = {"device": smi(), "world": dist.get_world_size(), "runs": []}
    try:
        for spec in args.train:
            kw = train_spec(spec)
            arch, n = kw["arch"], kw["steps"]
            mine, pieces = placed_run(**kw)
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, mine)
            run = dict(arch=arch, model_parallel=kw["model_parallel"],
                       ranks=ranks, dtype=pieces[0].dtype,
                       sell=pieces[0].sell_kind,
                       seq_len=kw.get("seq_len", 128))
            if arch in args.replicated:
                group = pieces[3].dp.group
                run["data_parallel"] = replicated_run(pieces, n, group)
                if rank == 0:
                    if dist.get_world_size(group) > 1:
                        run["replicated"] = replicated_run(pieces, n)
                    rel = max(abs(a - b) / abs(b) for a, b in zip(
                        ranks[0]["losses"], run["data_parallel"]["losses"]))
                    run.update(loss_rel=rel, losses_ok=rel <= POD_LOSS_RTOL)
                dist.barrier()
            del pieces
            report["runs"].append(run)
            if rank == 0:
                gb = 1e9
                print(f"[placed] {arch} {run['sell']} {run['dtype']} "
                      f"4 x {run['seq_len']} mesh {ranks[0]['mesh']} "
                      f"({report['device']}): at rest "
                      f"{[round(r['rest_bytes'] / gb, 3) for r in ranks]} GB"
                      f" of {ranks[0]['full_bytes'] / gb:.3f}; peak init "
                      f"{[round(r['init_peak'] / gb, 2) for r in ranks]}, "
                      f"steps {[round(r['step_peak'] / gb, 2) for r in ranks]}"
                      f" GB; s/step {[round(r['s_per_step'], 4) for r in ranks]}"
                      f"; losses {ranks[0]['losses']}"
                      + (f"; replicated data-parallel "
                         f"{run['data_parallel']}, on one card "
                         f"{run.get('replicated', 'as data-parallel')} "
                         f"(losses max rel {run['loss_rel']:.3g}, ok "
                         f"{run['losses_ok']})"
                         if "data_parallel" in run else ""), flush=True)
        world = dist.get_world_size()
        serves = []
        for a in args.serve:
            arch, *rest = a.split(":")
            serves.append((arch, int(rest[0]) if rest else 1, False,
                           rest[1] if len(rest) > 1 else "acdc"))
        serves += [(a.split(":")[0], int(a.split(":")[1]), True, "acdc")
                   for a in args.serve_long]
        specs = ([serve_spec(a, world, mp) for a, mp, lg, sl in serves
                  if not lg and sl == "acdc"]
                 + [pod_spec(p.split(":")[0], world) for p in args.pod_train]
                 + args.cell)
        reckon_out = Path("build") / "placed_multi_card" / "reckon.json"
        reckoning = (dryrun.start_reckoning(specs, "acdc", reckon_out)
                     if rank == 0 and specs else None)
        served, pods = [], []
        for arch, mp, long, sell in serves:
            for dtype in ("float32", "bfloat16"):
                mine = serve_run(arch, dtype, mp, long, sell)
                ranks = [None] * world
                dist.all_gather_object(ranks, mine)
                served.append(dict(arch=arch, dtype=dtype, long=long,
                                   model_parallel=mp, sell=sell,
                                   ranks=ranks))
                if rank == 0:
                    r0 = ranks[0]
                    print(f"[serve] {arch} {sell} {dtype} placed "
                          f"{r0['mesh']}"
                          f"{' long row' if long else ''} "
                          f"({report['device']}): prefill "
                          f"{[round(r['prefill_s'], 3) for r in ranks]} s, "
                          f"decode {[round(r['decode_s'] * 1e3, 1) for r in ranks]}"
                          f" ms a step (one card {r0['one_card']['decode_s'] * 1e3:.1f});"
                          f" logits max |diff| at the prefill "
                          f"{r0['last_logits_max_abs']:.3g} (every real "
                          f"position {r0.get('full_logits_max_abs')}; one "
                          f"card, each row alone: "
                          f"{r0.get('prefill_rows_alone_max_abs')}), "
                          f"after the "
                          f"streams {r0['step_logits_max_abs']} (one card, "
                          f"each row alone: {r0['rows_alone_max_abs']:.3g}"
                          + (f"; in head blocks: {r0['head_blocks']}"
                             if "head_blocks" in r0 else "") + "); "
                          + (f"logits ok {r0['logits_ok']}; "
                             if dtype == "float32" else "")
                          + f"streams held {r0['streams_held']['held']}; "
                          f"the step's collectives "
                          f"{r0['step_collectives']['count']} of "
                          f"{r0['step_collectives']['bytes']} B",
                          flush=True)
            if not long and sell == "acdc":
                served[-1]["card_cell"] = card_record(
                    serve_spec(arch, world, mp))
        for spec in args.pod_train:
            arch, n = spec.split(":")
            mine = pod_train(arch, int(n))
            ranks = [None] * world
            dist.all_gather_object(ranks, mine)
            pods.append(dict(arch=arch, ranks=ranks))
            if rank == 0:
                r0 = ranks[0]
                print(f"[pod] {arch} ({report['device']}): losses "
                      f"{r0['pod']['losses']} placed at {r0['pod']['mesh']}"
                      f" vs {r0['replicated']['losses']} replicated at "
                      f"{r0['replicated']['mesh']} (max rel "
                      f"{r0['loss_rel']:.3g}, ok {r0['losses_ok']}); "
                      f"s/step {r0['pod']['s_per_step']:.3f} / "
                      f"{r0['replicated']['s_per_step']:.3f}; peak "
                      f"{[round(r['pod']['peak'] / 1e9, 2) for r in ranks]}"
                      f" GB", flush=True)
        cells = [dict(spec=spec, card=card_record(spec))
                 for spec in args.cell]
        if rank == 0:
            recs = (dryrun.reckoned(reckoning, reckon_out)
                    if reckoning is not None else {})
            for run in cells:
                held = dryrun.compare(
                    run["card"], recs[run["spec"]],
                    peak_rel=dryrun.PEAK_REL if DEVICE == "cuda" else None)
                run["reckoned"] = dict(held, record=recs[run["spec"]])
                print(f"[cell] {run['spec']} (acdc on auto) on the cards "
                      f"against the dry run: mismatches "
                      f"{held['mismatches']}; FLOPs "
                      f"{run['card']['flops_per_device']:.6g}, collectives "
                      f"{run['card']['collectives']['count']}; peak above "
                      f"the arguments "
                      f"{recs[run['spec']]['memory']['temp_size_in_bytes']}"
                      f" B reckoned vs "
                      f"{run['card'].get('measured_temp_bytes')} measured "
                      f"({held['peak_rel_err']})", flush=True)
            for run in served:
                if "card_cell" not in run:
                    continue
                spec = serve_spec(run["arch"], world, run["model_parallel"])
                held = dryrun.compare(
                    run["card_cell"], recs[spec],
                    peak_rel=dryrun.PEAK_REL if DEVICE == "cuda" else None)
                run["reckoned"] = dict(held, spec=spec, record=recs[spec])
                print(f"[reckon] {spec} (acdc on auto) on the cards against "
                      f"the dry run: mismatches {held['mismatches']}; "
                      f"peak above the arguments "
                      f"{recs[spec]['memory']['temp_size_in_bytes']} B "
                      f"reckoned vs "
                      f"{run['card_cell'].get('measured_temp_bytes')} "
                      f"measured ({held['peak_rel_err']})", flush=True)
            for run in pods:
                spec = pod_spec(run["arch"], world)
                held = dryrun.compare(run["ranks"][0]["pod"]["record"],
                                      recs[spec],
                                      exact=("collectives", "arguments"))
                run["reckoned"] = dict(held, spec=spec, record=recs[spec])
                print(f"[reckon] {spec}: the first placed step's "
                      f"collectives and argument bytes against the dry "
                      f"run: mismatches {held['mismatches']}", flush=True)
            report.update(served=served, pod_train=pods, cells=cells)
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
    finally:
        mesh_mod.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
