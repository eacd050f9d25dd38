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
of every row, at the prefill's last token and every real position and
at one more decode step after the streams, within ``SERVE_FP32_ATOL`` of
one card's, or else within ``SETTLE_CEIL`` times that limit and settled
by the placed-block control; the streams (both dtypes) equal or
departing first at a near-tie (the two tokens' one-card fp32 logits
apart by no more than the drift of the step that chose them: the
largest difference of that row's logits, placed against one card's, at
that context; what follows a near-tie is reported, not held), or else
with gaps within ``SETTLE_CEIL`` times their drift and settled by the
control.  The placed-block control (``block_control``) runs the placed
steps on rank 0's card by one thread a rank (:class:`VirtualMesh`),
with rank 0's plans: bitwise equal to the placed run, or first parting
at an all-reduce within the rounding of reordering its terms, settles
the excess as summation order.  It runs the placed steps' own code and
so copies a fault of theirs: the ceiling, which it cannot override, is
what tells a fault apart.  For Mamba2 the head-blocks control, built
from the unplaced model (``_ssm_blocks_step``: each model rank's SSM
heads run one after another on one card, joined in head order), must
equal the placed step bitwise too where the step makes no partial-sum
all-reduce.  Held in every run: each rank's digest of its launch plans
(the placed steps run inside ``autotune.agreeing()``: every rank takes
rank 0's plan for a key) equal, and the final hidden state bitwise
equal over each "model" group after the placed prefill, the step after
the streams and a ``--train`` run's first step.  Reported
beside them: one card's prefill and step taken again on each row alone
(its sums in another order).  ``--pod-train
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
train cell's step or a prefill cell's at any mesh of the world.  The
exit status is 1 when a held check failed (``failed_checks`` in the JSON
and the ``[checks]`` line name each), 0 when none did.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist import steps as steps_mod  # noqa: E402
from repro_torch.kernels import autotune, build  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (  # noqa: E402
    common, encdec, get_model, mamba2, transformer, zamba2)
from repro_torch.optim.optimizers import tree_map  # noqa: E402

#: the device the ranks train on (a rehearsal on the CPU sets "cpu")
DEVICE = "cuda"
#: placed fp32 logits against one card's (PERF.md §2, stated before the
#: first four-card run)
SERVE_FP32_ATOL = 1e-4
#: an excess the placed-block control settles stays within SETTLE_CEIL
#: times its limit: fp32 logits within SETTLE_CEIL * SERVE_FP32_ATOL of
#: one card's, a bf16 departure's gap within SETTLE_CEIL times its
#: step's drift.  The control runs the placed steps' own code, so it
#: copies a fault of theirs bit for bit; a fault of a block (a wrong
#: head or vocabulary block, a gather out of order) moves the logits by
#: O(1), orders of magnitude above this ceiling.  Chosen after the
#: four-card serve runs on H100s read excesses of at most 2.69e-4 in
#: fp32 and gaps of at most 1.17 times their step's drift in bf16.
SETTLE_CEIL = 4
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


#: the models' modules that call ``common.unembed`` by name
_UNEMBED_CALLERS = (transformer, encdec, mamba2, zamba2)
#: ``calls``: where the tapped ``unembed`` records on this thread
_TAP = threading.local()
_TAP_LOCK = threading.Lock()
_TAP_OPEN = [0]


def _tapped_unembed(params, x, tp=None):
    logits = common.unembed(params, x, tp)
    calls = getattr(_TAP, "calls", None)
    if calls is not None:
        calls.append((x.detach(), logits.detach()))
    return logits


@contextlib.contextmanager
def tap_unembed():
    """Every vocabulary projection (``common.unembed``) this thread makes
    inside the block: yields a list that gets ``(x, logits)`` of each,
    detached -- the final hidden state and what the projection made of
    it (under ``tp`` this rank's block of the vocabulary).  The models'
    modules call the tapped function while any block is open."""
    with _TAP_LOCK:
        if _TAP_OPEN[0] == 0:
            for m in _UNEMBED_CALLERS:
                m.unembed = _tapped_unembed
        _TAP_OPEN[0] += 1
    outer = getattr(_TAP, "calls", None)
    _TAP.calls = []
    try:
        yield _TAP.calls
    finally:
        _TAP.calls = outer
        with _TAP_LOCK:
            _TAP_OPEN[0] -= 1
            if _TAP_OPEN[0] == 0:
                for m in _UNEMBED_CALLERS:
                    m.unembed = common.unembed


def train_steps(step_fn, state, batch_at, n: int, hidden=None) -> tuple:
    """(state, losses, seconds a step) of n synchronised steps; the first
    step's final hidden state (the input of the vocabulary projection)
    appended to ``hidden`` when given."""
    losses, secs = [], []
    for s in range(n):
        batch = {k: t.to(DEVICE) for k, t in batch_at(s).items()}
        t0 = time.perf_counter()
        with tap_unembed() as tap:
            state, met = step_fn(state, batch)
        _sync()
        secs.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        if s == 0 and hidden is not None:
            hidden.append(tap[0][0])
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
    hidden = []
    with autotune.agreeing():
        state, losses, secs = train_steps(step_fn, state, pipeline.batch_at,
                                          steps, hidden)
    out.update(step_peak=torch.cuda.max_memory_allocated(), losses=losses,
               s_per_step=sum(secs[1:]) / max(len(secs) - 1, 1),
               step_s=secs,
               hidden_across_model=[model_gap(h, dp.mesh) for h in hidden],
               memo_digests=memo_digests(dist.get_world_size()))
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
    ``n_blocks``, built from the unplaced model's pieces, without its
    collectives (and with the gated norm and ``out_proj`` whole).
    Updates ``cache`` in place; returns the logits."""
    from repro_torch.models.common import embed_lookup, rms_norm
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
        return common.unembed(params["embed"], x)[:, 0]


def head_blocks(cfg, params, cache, first, n_blocks: int, n_steps: int,
                placed: dict) -> dict:
    """The control of a Mamba2 step built from the unplaced model
    (:func:`_ssm_blocks_step`): greedy from ``first`` on a copy of one
    card's prefilled ``cache``, ``n_steps`` steps and one more; its
    streams and last logits against the placed steps'."""
    ctl = {k: v.clone() for k, v in cache.items()}
    tok, stream = first, []
    for _ in range(n_steps + 1):
        stream.append(tok)
        logits = _ssm_blocks_step(cfg, params, ctl, tok, n_blocks).float()
        tok = logits.argmax(-1)
    equal = torch.stack(stream, 1).cpu().tolist() == \
        placed["streams"].tolist()
    return dict(streams_equal=equal,
                vs_placed=(float((logits - placed["step_logits"]).abs().max())
                           if equal else None))


# ---------------------------------------------------------------------------
# Checks of replicated values, and the collectives the controls stand in for
# ---------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def model_gap(h: torch.Tensor, mesh) -> dict:
    """``h``, a value every rank of a "model" group computes (the rows'
    final hidden state), against the copy of its group's first rank: the
    largest |h - h0| and the count of elements whose bits differ, each the
    largest over the world.  Every rank calls it."""
    h = h.detach().contiguous()
    got = torch.zeros(2, dtype=torch.float64, device=h.device)
    if sharding._axis_sizes(mesh).get("model", 1) > 1:
        group = mesh.get_group("model")
        h0 = h.clone()
        dist.broadcast(h0, dist.get_global_rank(group, 0), group=group)
        got[0] = (h.double() - h0.double()).abs().max()
        got[1] = (_bits(h) != _bits(h0)).sum()
    dist.all_reduce(got, op=dist.ReduceOp.MAX)
    return dict(max_abs=float(got[0]), differing=int(got[1]))


def memo_digests(world: int) -> list:
    """Every rank's digest of the launch plans its group agreed on
    (``autotune.digest``); every rank calls it."""
    out = [None] * world
    dist.all_gather_object(out, autotune.digest())
    return out


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(_bits(t).cpu().numpy().tobytes()).hexdigest()[:16]


class _Recorded:
    """``torch.distributed`` as the placed steps call it
    (``sharding.dist``, ``steps.dist``), each all-reduce's input and
    output kept: ``calls`` of (input, output)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(dist, name)

    def all_reduce(self, x, op=dist.ReduceOp.SUM, group=None, **kw):
        before = x.detach().clone()
        work = dist.all_reduce(x, op=op, group=group, **kw)
        self.calls.append((before, x.detach().clone()))
        return work


@contextlib.contextmanager
def _collectives(shim):
    """The placed steps' collectives through ``shim`` inside the block."""
    old = sharding.dist, steps_mod.dist
    sharding.dist = steps_mod.dist = shim
    try:
        yield shim
    finally:
        sharding.dist, steps_mod.dist = old


class _Line:
    """One line of a :class:`VirtualMesh` along an axis: its ranks (global
    virtual ranks, in group order) exchange tensors through a barrier."""

    def __init__(self, ranks: list):
        self.ranks, self.slots = ranks, {}
        self.barrier = threading.Barrier(len(ranks), timeout=600)

    def exchange(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` of this call, in group order."""
        self.slots[_VIRTUAL.rank] = x
        self.barrier.wait()
        got = [self.slots[r] for r in self.ranks]
        self.barrier.wait()
        return got


#: ``rank``: the virtual rank a control's thread runs
_VIRTUAL = threading.local()


class VirtualMesh:
    """A ("data", "model") mesh of threads on one card, as the placed
    steps read a ``DeviceMesh``: virtual rank r at the coordinate
    ``mesh_of(shape)`` gives global rank r."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape: tuple, rank: int, lines: dict):
        self.shape, self.rank, self._lines = tuple(shape), rank, lines
        self._coord = divmod(rank, shape[1])

    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def get_coordinate(self) -> list:
        return list(self._coord)

    def get_local_rank(self, axis: str) -> int:
        return self._coord[self.mesh_dim_names.index(axis)]

    def get_group(self, axis: str) -> _Line:
        d, m = self._coord
        return self._lines[(axis, m if axis == "data" else d)]


class _ThreadDist:
    """The collectives the placed serving steps make, over a
    :class:`VirtualMesh`'s lines: all-gathers copy, all-reduces sum in
    rank order; each all-reduce recorded on its thread as (input,
    output, the sum of its line's inputs in fp64, the sum of their
    magnitudes, the count of terms)."""

    ReduceOp = dist.ReduceOp

    def __init__(self, n: int):
        self.calls = [[] for _ in range(n)]

    def get_world_size(self, group=None) -> int:
        return len(group.ranks)

    def all_gather(self, parts, x, group=None, **kw):
        for p, v in zip(parts, group.exchange(x)):
            p.copy_(v)

    def all_reduce(self, x, op=dist.ReduceOp.SUM, group=None, **kw):
        vals = group.exchange(x)
        out = vals[0].clone()
        for v in vals[1:]:
            out = out + v if op == dist.ReduceOp.SUM else torch.maximum(
                out, v)
        exact = sum(v.double() for v in vals)
        size = sum(v.double().abs() for v in vals)
        before = x.detach().clone()
        group.barrier.wait()            # every rank has read every input
        x.copy_(out)
        self.calls[_VIRTUAL.rank].append((before, out, exact, size,
                                          len(vals)))


def virtual_run(shape: tuple, fn: Callable) -> tuple:
    """``fn(mesh)`` on a :class:`VirtualMesh` of ``shape``, one thread a
    virtual rank on this card, this process's own plans: (each rank's
    result, each rank's recorded all-reduces)."""
    n = shape[0] * shape[1]
    ranks = torch.arange(n).reshape(shape)
    lines = {("data", m): _Line(ranks[:, m].tolist())
             for m in range(shape[1])}
    lines.update({("model", d): _Line(ranks[d].tolist())
                  for d in range(shape[0])})
    shim, results, errors = _ThreadDist(n), [None] * n, []
    device = torch.cuda.current_device() if DEVICE == "cuda" else None

    def run(r: int) -> None:
        _VIRTUAL.rank = r
        if device is not None:
            torch.cuda.set_device(device)
        try:
            with torch.no_grad():
                results[r] = fn(VirtualMesh(shape, r, lines))
        except BaseException as e:      # noqa: BLE001 -- reraised below
            errors.append(e)
            for line in lines.values():
                line.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    with _collectives(shim):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return results, shim.calls


def first_difference(placed: list, placed_inputs: list, control: list
                     ) -> Optional[dict]:
    """Where the placed steps' all-reduces and the control's first part:
    ``placed`` rank 0's (input, output) of each all-reduce,
    ``placed_inputs`` every rank's input digests, ``control`` every
    virtual rank's records (:class:`_ThreadDist`).  Kind ``input``: an
    all-reduce's inputs differ (the difference arose before it, in a
    computation); ``all_reduce``: the inputs are equal and the outputs
    not, each held within the rounding of summing its n terms in some
    order: |out - sum p_r| <= gamma_(n-1) sum |p_r| elementwise, gamma_k =
    k u / (1 - k u) (u the unit roundoff of the sum's dtype: 2^-24 in
    fp32, 2^-8 in bf16; for four terms ~3 u sum |p_r|); ``count``: the
    calls differ in number.  None: every all-reduce bitwise equal."""
    for i, (inp, out) in enumerate(placed):
        if i >= len(control[0]):
            break
        if any(placed_inputs[r][i] != _sha(control[r][i][0])
               for r in range(len(control))):
            return dict(kind="input", call=i, of=len(placed))
        _, c_out, exact, size, n = control[0][i]
        if not torch.equal(out, c_out):
            k = (n - 1) * torch.finfo(out.dtype).eps / 2
            bound = (k / (1 - k) * size).clamp_min(1e-300)
            placed_over = ((out.double() - exact).abs() / bound).max()
            control_over = ((c_out.double() - exact).abs() / bound).max()
            return dict(kind="all_reduce", call=i, of=len(placed), terms=n,
                        max_abs=float((out.double() - c_out.double())
                                      .abs().max()),
                        placed_over_bound=float(placed_over),
                        control_over_bound=float(control_over),
                        within=bool(placed_over <= 1
                                    and control_over <= 1))
    if len(placed) != len(control[0]):
        return dict(kind="count", placed=len(placed),
                    control=len(control[0]))
    return None


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Prompts:
    """A ``--serve`` run's inputs: every row's prompt, its real length,
    an encoder-decoder's frames, the cache's length and the decode
    steps."""
    tokens: torch.Tensor
    lengths: torch.Tensor
    frames: Optional[torch.Tensor]
    cache_len: int
    n_steps: int

    def frames_of(self, rows):
        return None if self.frames is None else self.frames[rows]


def _greedy(serve, params, cache, first, p: Prompts) -> tuple:
    """``p.n_steps`` decode steps from ``first``: (streams on the host,
    seconds a step, cache, last token, next position, each step's
    ``unembed`` calls)."""
    pos, tok, stream, secs = p.lengths.clone(), first, [first], []
    with tap_unembed() as tap:
        for _ in range(p.n_steps):
            t0 = time.perf_counter()
            tok, cache = serve(params, cache, tok, pos)
            _sync()
            secs.append(time.perf_counter() - t0)
            pos = pos + 1
            stream.append(tok)
    return torch.stack(stream, 1).cpu(), secs, cache, tok, pos, tap


def _step_logits(tap: list, tp, spec, mesh) -> list:
    """Every row's whole-vocabulary logits of each recorded decode step
    (this rank's rows and vocabulary block gathered)."""
    out = []
    for _, logits in tap:
        rows = logits.reshape(logits.shape[0], -1)
        if mesh is not None:
            rows = steps_mod.gather_vocab(rows, tp)
            rows = sharding._all_gather(rows.float().contiguous(),
                                        tuple(spec) + (None,), mesh)
        out.append(rows.float())
    return out


def placed_serve(model, cfg, params, mesh, p: Prompts, long: bool) -> dict:
    """The placed steps on ``mesh`` (a ``DeviceMesh``, or a
    :class:`VirtualMesh` for the control): a ``full_logits`` prefill of
    every row, ``p.n_steps`` greedy steps through
    ``make_serve_step(mesh=)`` and one more decode step's logits.  Every
    rank calls it; logits come back whole (every row, the vocabulary)."""
    b = p.tokens.shape[0]
    prefill = steps_mod.make_prefill_step(model, cfg, full_logits=True,
                                          mesh=mesh)
    serve = steps_mod.make_serve_step(model, cfg, mesh=mesh)
    tp = steps_mod.tensor_split(cfg, mesh)
    placed_p = sharding.place_params(tree_map(lambda t: t, params), mesh)
    cache = sharding.place_cache(model.init_cache(cfg, b, p.cache_len,
                                                  device=DEVICE), mesh)
    spec = sharding.rows_spec(mesh, b)
    rows = sharding.local_shard(torch.arange(b), spec, mesh).to(DEVICE)
    if DEVICE == "cuda" and not isinstance(mesh, VirtualMesh):
        torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.perf_counter()
    with tap_unembed() as tap:
        logits, cache = prefill(placed_p, cache, p.tokens[rows], p.lengths,
                                p.frames_of(rows))
    _sync()
    prefill_s = time.perf_counter() - t0
    hidden = [tap[-1][0]]
    # a tensor-parallel prefill's full logits are this rank's block of
    # the vocabulary
    logits = steps_mod.gather_vocab(logits, tp)
    last = logits[torch.arange(len(rows)), p.lengths[rows].long()
                  - 1].float()
    full_last = sharding._all_gather(last.contiguous(), spec, mesh)
    full_logits = (None if long else sharding._all_gather(
        logits.float().contiguous(), tuple(spec) + (None, None), mesh))
    del logits
    streams, secs, cache, tok, pos, tap = _greedy(
        serve, placed_p, cache, full_last.argmax(-1), p)
    stream_logits = [full_last] + _step_logits(tap, tp, spec, mesh)
    coll = None if isinstance(mesh, VirtualMesh) else dryrun.Collectives()
    with tap_unembed() as tap:
        step_logits = _decode_logits(model, cfg, placed_p, cache, tok, pos,
                                     mesh, coll)
    hidden.append(tap[-1][0])
    return dict(full_last=full_last, full_logits=full_logits,
                streams=streams, stream_logits=stream_logits,
                step_logits=step_logits, hidden=hidden, secs=secs,
                prefill_s=prefill_s, rows=rows.tolist(),
                specs={k: list(v)
                       for k, v in cache.placement.specs.items()},
                collectives=None if coll is None else coll.record())


def _max_abs(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    return None if a is None or b is None else float((a - b).abs().max())


def block_control(model, cfg, params, shape: tuple, p: Prompts, long: bool,
                  placed: dict, recorded: list, placed_inputs: list,
                  one: dict) -> dict:
    """The placed blocks on one card: every model rank's blocks computed
    with the shapes that rank computes, this card's plans (rank 0's: the
    ranks agree on each key), joined in the placed steps' order
    (:func:`virtual_run` of :func:`placed_serve`).  Bitwise equal to the
    placed logits: the placed steps' difference from one card's is the
    order of the blocks' sums, ``settled``.  Where the steps all-reduce
    partial sums, NCCL's order is not this card's: the first difference
    must sit at an all-reduce, within its reordering bound
    (:func:`first_difference`).  The same code as the placed steps: a
    fault of theirs is settled too, and the caller's ceiling
    (``SETTLE_CEIL``) is what holds it."""
    results, calls = virtual_run(
        shape, lambda mesh: placed_serve(model, cfg, params, mesh, p, long))
    ctl = results[0]
    out = dict(
        full_last_vs_placed=_max_abs(ctl["full_last"], placed["full_last"]),
        full_logits_vs_placed=_max_abs(ctl["full_logits"],
                                       placed["full_logits"]),
        streams_equal=ctl["streams"].tolist() == placed["streams"].tolist(),
        step_logits_vs_placed=_max_abs(ctl["step_logits"],
                                       placed["step_logits"]),
        full_logits_vs_one_card=_max_abs(ctl["full_logits"],
                                         one["full_logits"]),
        step_logits_vs_one_card=(
            _max_abs(ctl["step_logits"], one["step_logits"])
            if ctl["streams"].tolist() == one["streams"].tolist() else None),
        all_reduces=len(recorded))
    diff = first_difference(recorded, placed_inputs, calls)
    bitwise = (out["streams_equal"] and out["full_last_vs_placed"] == 0.0
               and out["full_logits_vs_placed"] in (None, 0.0)
               and out["step_logits_vs_placed"] == 0.0)
    out.update(bitwise=bitwise, first_difference=diff,
               settled=(bitwise and diff is None) or (
                   diff is not None and diff["kind"] == "all_reduce"
                   and diff["within"]))
    del results, calls
    return out


def serve_run(arch: str, dtype: str, model_parallel: int = 1,
              long: bool = False, sell: str = "acdc") -> dict:
    """Placed serving at (world / model_parallel, model_parallel) and, on
    rank 0, the unplaced steps, the controls and the comparison."""
    cfg = registry.get_config(arch)
    if sell == "acdc":
        cfg = registry.with_sell(cfg, "acdc", method="pallas")
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = get_model(cfg)
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = (world // model_parallel, model_parallel)
    mesh = dryrun.mesh_of(shape, DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                        DEVICE)
    gen = torch.Generator().manual_seed(1)
    if long:
        b, plen = 1, LONG_LEN
        p = Prompts(None, torch.tensor([plen], dtype=torch.int32,
                                       device=DEVICE), None, LONG_CACHE,
                    LONG_STEPS)
    else:
        b, plen = SERVE_ROWS, SERVE_LEN
        p = Prompts(None, torch.tensor([64, 50, 64, 37][:b],
                                       dtype=torch.int32, device=DEVICE),
                    None, SERVE_CACHE, SERVE_STEPS)
    p.tokens = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                             dtype=torch.int32).to(DEVICE)
    p.frames = (torch.randn(b, SERVE_FRAMES, cfg.d_model, generator=gen)
                .to(DEVICE) if cfg.frontend == "audio" else None)
    # every all-reduce kept, for the placed-block control
    recorder = _Recorded()
    with _collectives(recorder), autotune.agreeing():
        placed = placed_serve(model, cfg, params, mesh, p, long)
    secs = placed["secs"]
    out = dict(mesh=list(mesh.shape), rows=placed["rows"],
               specs=placed["specs"], prefill_s=placed["prefill_s"],
               decode_s=sum(secs[1:]) / max(len(secs) - 1, 1),
               peak=(torch.cuda.max_memory_allocated()
                     if DEVICE == "cuda" else 0),
               streams=placed["streams"].tolist(),
               step_collectives=placed["collectives"],
               hidden_across_model=[model_gap(h, mesh)
                                    for h in placed["hidden"]])
    out["memo_digests"] = memo_digests(world)
    inputs = [None] * world
    dist.all_gather_object(inputs, [_sha(i) for i, _ in recorder.calls])
    del placed["hidden"]
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        out.update(one_card(model, cfg, params, p, long, dtype, placed,
                            recorder, inputs, shape))
    del params, placed, recorder
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def one_card(model, cfg, params, p: Prompts, long: bool, dtype: str,
             placed: dict, recorder, inputs: list, shape: tuple) -> dict:
    """Rank 0 alone: the unplaced steps, the controls and what is held."""
    b = p.tokens.shape[0]
    prefill = steps_mod.make_prefill_step(model, cfg, full_logits=True)
    serve = steps_mod.make_serve_step(model, cfg)
    res = {}
    cache = model.init_cache(cfg, b, p.cache_len, device=DEVICE)
    with torch.no_grad():
        one_logits, cache = prefill(params, cache, p.tokens, p.lengths,
                                    p.frames)
        one_last = one_logits[torch.arange(b), p.lengths.long()
                              - 1].float()
        one_full = None if long else one_logits.float()
        del one_logits
        if one_full is not None:
            # control: one card's prefill of each row alone (its sums
            # in another order), at every real position
            res["prefill_rows_alone_max_abs"] = max(
                float((prefill(params, model.init_cache(
                    cfg, 1, p.cache_len, device=DEVICE),
                    p.tokens[r:r + 1], p.lengths[r:r + 1],
                    p.frames_of(slice(r, r + 1)))[0][0, :n]
                    .float() - one_full[r, :n]).abs().max())
                for r, n in enumerate(p.lengths.tolist()))
        if cfg.family == "ssm" and shape[1] > 1:
            res["head_blocks"] = head_blocks(cfg, params, cache,
                                             one_last.argmax(-1), shape[1],
                                             p.n_steps, placed)
        one_streams, one_secs, cache, one_tok, one_pos, tap = _greedy(
            serve, params, cache, one_last.argmax(-1), p)
        one_stream_logits = [one_last] + _step_logits(tap, None, None,
                                                      None)
        del tap
        alone = [{k: (v[r:r + 1] if v.dim() == 1 else v[:, r:r + 1])
                  .clone() for k, v in cache.items()} for r in range(b)]
        one_step = _decode_logits(model, cfg, params, cache, one_tok,
                                  one_pos).float()
        # control: the same step on each row alone (one card's sums in
        # another order)
        one_rows = torch.cat([_decode_logits(
            model, cfg, params, c, one_tok[r:r + 1],
            one_pos[r:r + 1]).float() for r, c in enumerate(alone)])
        del alone, cache
    res["one_card"] = dict(streams=one_streams.tolist(),
                           decode_s=sum(one_secs[1:])
                           / max(len(one_secs) - 1, 1))
    diff = (placed["full_last"] - one_last).abs()
    res["last_logits_max_abs"] = float(diff.max())
    if one_full is not None:     # every real position's
        plen = p.tokens.shape[1]
        real = (torch.arange(plen, device=DEVICE)[None, :]
                < p.lengths[:, None])
        gap = (placed["full_logits"] - one_full).abs().amax(-1) * real
        worst = int(gap.argmax())
        res["full_logits_max_abs"] = float(gap.max())
        res["full_logits_worst"] = [worst // plen, worst % plen]
    streams = placed["streams"]
    same = streams.tolist() == one_streams.tolist()
    res["step_logits_max_abs"] = (float((placed["step_logits"] - one_step)
                                        .abs().max()) if same else None)
    res["rows_alone_max_abs"] = float((one_rows - one_step).abs().max())
    def settled() -> bool:
        """The placed-block control, run once, settles the excess: it
        reproduces the placed steps, and where the step makes no
        partial-sum all-reduce the head-blocks control built from the
        unplaced model (Mamba2) equals them bitwise too."""
        if "block_control" not in res:
            res["block_control"] = block_control(
                model, cfg, params, shape, p, long, placed,
                recorder.calls, inputs, dict(full_logits=one_full,
                                             step_logits=one_step,
                                             streams=one_streams))
        ctl, blocks = res["block_control"], res.get("head_blocks")
        return ctl["settled"] and (
            blocks is None or ctl["first_difference"] is not None
            or blocks["vs_placed"] == 0.0)

    if dtype == "float32":
        worst = max(float(diff.max()), res.get("full_logits_max_abs", 0.0),
                    res["step_logits_max_abs"] or 0.0)
        res["logits_ok"] = worst <= SERVE_FP32_ATOL
        # over the limit: held only under the ceiling, and where the
        # placed blocks on one card differ the same way (summation order)
        res["logits_held"] = res["logits_ok"] or (
            settled() and worst <= SETTLE_CEIL * SERVE_FP32_ATOL)
    res["streams_held"] = hold_streams(
        model, cfg, params, p, streams, one_streams,
        placed["stream_logits"], one_stream_logits, float(diff.max()))
    if not res["streams_held"]["held"]:
        # a departure over its step's drift: held only under the ceiling,
        # and where the placed blocks on one card depart the same way
        res["streams_held"]["held"] = settled() and all(
            r["equal"] or r["gap"] <= SETTLE_CEIL * r["drift"]
            for r in res["streams_held"]["rows"])
        res["streams_held"]["by_block_control"] = True
    return res


def hold_streams(model, cfg, params, p: Prompts, placed, one,
                 placed_logits: list, one_logits: list,
                 prefill_drift: float) -> dict:
    """The bf16 streams: equal, or a row's first difference a near-tie:
    the two tokens' fp32 logits after that context, one card, apart by at
    most the drift of the step that chose them -- the largest difference
    of that row's logits, placed against one card's, at that context (the
    prefill's last logits for the first token, else the decode step's).
    ``prefill_drift`` (the largest difference of the prefill's last
    logits over every row, the rule's drift before) is reported beside
    it.  An encoder-decoder's row with its frames."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    rows = []
    for r in range(placed.shape[0]):
        a, b = placed[r].tolist(), one[r].tolist()
        if a == b:
            rows.append(dict(equal=True))
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        n = int(p.lengths[r])
        ctx = p.tokens[r, :n].tolist() + b[:j]
        toks = torch.tensor([ctx], dtype=torch.int32, device=DEVICE)
        cache = model.init_cache(f32, 1, len(ctx), device=DEVICE)
        with torch.no_grad():
            logits, _ = model.prefill(params, cache, toks, f32,
                                      torch.tensor([len(ctx)],
                                                   dtype=torch.int32,
                                                   device=DEVICE),
                                      p.frames_of(slice(r, r + 1)))
        gap = abs(float(logits[0, -1, a[j]] - logits[0, -1, b[j]]))
        drift = float((placed_logits[j][r] - one_logits[j][r]).abs().max())
        rows.append(dict(equal=False, first_difference=j, tokens=[a[j],
                                                                  b[j]],
                         gap=gap, drift=drift, prefill_drift=prefill_drift,
                         near_tie=gap <= drift))
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


def _rank_checks(where: str, ranks: list) -> list:
    """The checks every rank's record of a run carries: the plans its
    group agreed on, and the final hidden state bitwise equal over each
    "model" group."""
    bad = []
    if any(r["memo_digests"] != ranks[0]["memo_digests"] for r in ranks) \
            or len(set(ranks[0]["memo_digests"])) != 1:
        bad.append(f"{where}: the ranks' launch plans differ "
                   f"({ranks[0]['memo_digests']})")
    for i, gap in enumerate(ranks[0]["hidden_across_model"]):
        if gap["differing"]:
            bad.append(f"{where}: hidden state {i} differs over \"model\" "
                       f"({gap})")
    return bad


def failed_checks(report: dict) -> list:
    """Every held check of a finished run that failed, named: the losses,
    the launch plans and the replicated hidden state of each ``--train``
    run; of each ``--serve`` run those two, the fp32 logits (within
    ``SERVE_FP32_ATOL`` of one card's, or settled by the placed-block
    control) and the streams; each reckoning's mismatches (the peak
    within ``dryrun.PEAK_REL`` among them)."""
    bad = []
    for run in report["runs"]:
        where = f"train {run['arch']} {run['sell']} {run['dtype']} " \
                f"model {run['model_parallel']}"
        bad += _rank_checks(where, run["ranks"])
        if run.get("losses_ok") is False:
            bad.append(f"{where}: losses {run['loss_rel']:.3g} apart")
    for run in report["served"]:
        where = f"serve {run['arch']} {run['sell']} {run['dtype']} " \
                f"model {run['model_parallel']}"
        r0 = run["ranks"][0]
        bad += _rank_checks(where, run["ranks"])
        if r0.get("logits_held") is False:
            bad.append(f"{where}: fp32 logits over {SERVE_FP32_ATOL}, over "
                       f"{SETTLE_CEIL} x that or not settled by the "
                       f"control")
        if not r0["streams_held"]["held"]:
            bad.append(f"{where}: streams not held")
    for run in report["pod_train"]:
        if not run["ranks"][0]["losses_ok"]:
            bad.append(f"pod {run['arch']}: losses apart")
    for run in (report["served"] + report["pod_train"] + report["cells"]):
        rec = run.get("reckoned")
        if rec is not None and rec["mismatches"]:
            bad.append(f"reckoning {rec.get('spec', run.get('spec'))}: "
                       f"{rec['mismatches']}")
    return bad


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
                with autotune.agreeing():
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
                      f"; losses {ranks[0]['losses']}; hidden state over "
                      f"\"model\" {ranks[0]['hidden_across_model']}, plans "
                      f"{ranks[0]['memo_digests']}"
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
                          f"each row alone: {r0['rows_alone_max_abs']:.3g}); "
                          + (f"logits ok {r0['logits_ok']} (placed-block "
                             f"control {r0.get('block_control')}; head "
                             f"blocks {r0.get('head_blocks')}; held "
                             f"{r0['logits_held']}); "
                             if dtype == "float32" else "")
                          + f"streams held {r0['streams_held']} ; "
                          f"hidden state over \"model\" "
                          f"{r0['hidden_across_model']}; plans "
                          f"{r0['memo_digests']}; "
                          f"the step's collectives "
                          f"{r0['step_collectives']['count']} of "
                          f"{r0['step_collectives']['bytes']} B",
                          flush=True)
            if not long and sell == "acdc":
                served[-1]["card_cell"] = card_record(
                    serve_spec(arch, world, mp))
        for spec in args.pod_train:
            arch, n = spec.split(":")
            with autotune.agreeing():
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
            report["failed_checks"] = failed_checks(report)
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
            print(f"[checks] failed: {report['failed_checks'] or 'none'}",
                  flush=True)
        verdict = [bool(report.get("failed_checks"))]
        dist.broadcast_object_list(verdict, src=0)
    finally:
        mesh_mod.shutdown()
    return 1 if verdict[0] else 0


if __name__ == "__main__":
    sys.exit(main())
