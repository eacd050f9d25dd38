"""The multi-pod dry run (port of :mod:`repro.launch.dryrun`).

For every (arch x shape) cell and production mesh, the port's own placed
step is traced once on ``meta`` tensors as rank 0 of a fake process group
of 256 or 512 ranks (:func:`repro_torch.launch.mesh.init_fake_group`):

    train    steps.abstract_state(..., mesh=) and make_train_step(mesh=)
    prefill  make_prefill_step(full_logits=True, mesh=) on the cache's
             placement (it reads no value of it), the frontend's
             embeddings where the config has one
    decode   make_serve_step(mesh=) (greedy) on a meta init_cache placed
             by cache_specs

The device is ``meta`` by design, as the reference's is 512 CPU
placeholders: the dry run allocates nothing, moves nothing and times
nothing.  It answers which cells fit a card and what collectives they
issue, from the real steps rather than a model of them:

* ``memory.argument_size_in_bytes``: this rank's blocks of the state or
  params and of a decode cell's cache (a prefill cell's step takes the
  cache's placement, shapes only), plus its inputs as the step takes
  them;
* ``memory.output_size_in_bytes``: the step's outputs (state updated in
  place counted, as the reference's undonated outputs are);
* ``memory.temp_size_in_bytes``: the peak of the bytes of storages the
  step allocated and held at once (:class:`LiveBytes`: each rounded up to
  512 B as the CUDA caching allocator rounds a block; arguments
  excluded);
* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count (matmuls, einsums and convolutions; not FFTs);
* ``collectives``: every c10d op the step issues, by the reference's five
  kinds, each sized by its output (an all-gather by the gathered tensor,
  a reduce-scatter by this rank's block), as the reference's
  ``collective_bytes`` sizes them (:class:`Collectives`).

A cell is ``ok``, ``skipped`` (the reference's reason) or ``error`` (the
traceback).  A decode cell runs on its cache as ``cache_specs`` places
it: heads over "model", the batch or (batch 1) the sequence over the row
axes (:class:`repro_torch.dist.sharding.DecodeSplit`).  The dry run runs
the config's own SELL route (``auto``: cuBLAS or ``torch.fft``, whose
meta tensors work); a cell asked on ``pallas`` raises, since the kernel
wrappers have no meta implementation.

Not ported: the reference's HLO text parsers (``collective_bytes``,
``hlo_text_analysis``, ``_shape_bytes``, ``bytes_accessed_per_device``:
the port has no HLO; the dispatch counters above take their place) and
``.compile()`` (nothing is compiled; ``trace_s`` replaces ``lower_s`` /
``compile_s``).  Records go to ``build/dryrun/<cell>.json`` and an
interrupted sweep resumes where it stopped::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_1_7b \\
        --shape train_4k [--multi-pod] [--force]

A run on real devices is held against the reckoning of the same cell at
the same mesh (``chip_smoke.py`` path M, ``scripts/placed_multi_card.py``):
:func:`start_reckoning` traces the cells in a subprocess of their own
(``--reckon ARCH:KIND:SEQ:BATCH:MESH[:DTYPE] --out OUT.json``), the run
is measured by :func:`measure_on_device` under the same counters, and
:func:`compare` holds FLOPs, collectives and argument and output bytes
equal and the peak within a stated limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.dist import sharding
from repro_torch.dist import steps as steps_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import get_model
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.optim.schedules import cosine_schedule

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op -> (kind, index of the argument holding its outputs)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
}

#: the CUDA caching allocator's block granularity
_BLOCK = 512

#: the seed of a cell's parameters, state and inputs on a real device
SEED = 0


def _tensors(tree) -> list:
    """The tensors of ``tree``: nested mappings (a ``PlacedCache`` too),
    lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    return []


def tensor_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (dicts, lists, tuples)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class Collectives(TorchDispatchMode):
    """Counts every c10d op dispatched inside it, by kind, with the bytes
    of its outputs; an op of no kind is counted under its own name in
    ``other``."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.count = {k: 0 for k in COLLECTIVES}
        self.other: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            name = func.__name__.split(".")[0]
            if name in _C10D:
                kind, at = _C10D[name]
                self.count[kind] += 1
                self.bytes[kind] += tensor_bytes(args[at])
            else:
                self.other[name] = self.other.get(name, 0) + 1
        return out

    def record(self) -> dict:
        rec = {"bytes": dict(self.bytes), "count": dict(self.count),
               "total_bytes": int(sum(self.bytes.values()))}
        if self.other:
            rec["other"] = dict(self.other)
        return rec


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes of storages allocated by ops dispatched
    inside it and alive at once (each rounded up to 512 B); a storage an
    op shares with one of its inputs (a view, an in-place result) or that
    was made before is not counted."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._held: dict = {}

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._held.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {id(t.untyped_storage())
                  for t in _tensors((args, kwargs or {}))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in inputs or key in self._held:
                continue
            n = -(-st.nbytes() // _BLOCK) * _BLOCK
            self._held[key] = weakref.finalize(st, self._free, key, n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def measure(fn, args) -> tuple:
    """(outputs, record) of ``fn(*args)`` run once under the counters:
    ``trace_s``, ``memory``, ``flops_per_device``, ``collectives``.
    ``FlopCounterMode`` runs the decomposition of every op it has no
    formula for, so on real tensors the outputs may differ in the last
    bits from an uncounted call's."""
    arg_bytes = tensor_bytes(args)
    coll, live = Collectives(), LiveBytes()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, coll, live:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        if id(t) not in seen:
            seen.add(id(t))
            out_bytes += t.numel() * t.element_size()
    return out, {
        "trace_s": round(trace_s, 3),
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "output_size_in_bytes": int(out_bytes),
                   "temp_size_in_bytes": int(live.peak)},
        "flops_per_device": float(flops.get_total_flops()),
        "collectives": coll.record(),
    }


def measure_on_device(fn, args) -> dict:
    """The record of :func:`measure` for ``fn(*args)`` on real tensors,
    taken after one warm-up call (caches such as the transforms'
    matrices are made there).  On the card it also holds
    ``measured_temp_bytes``: ``torch.cuda.max_memory_allocated`` above
    the bytes allocated before the call, the counterpart of
    ``memory.temp_size_in_bytes``."""
    cuda = any(t.is_cuda for t in _tensors(args))
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    res, rec = measure(fn, args)
    if cuda:
        torch.cuda.synchronize()
        rec["measured_temp_bytes"] = (torch.cuda.max_memory_allocated()
                                      - before)
    del res
    return rec


#: the limit of the reckoned peak above a step's arguments against the
#: card's measured one, relative to the measured (PERF.md §2)
PEAK_REL = 0.01

#: what :func:`compare` holds equal: name -> the record's value
EXACT = {
    "flops": lambda r: r["flops_per_device"],
    "collectives": lambda r: r["collectives"],
    "arguments": lambda r: r["memory"]["argument_size_in_bytes"],
    "outputs": lambda r: r["memory"]["output_size_in_bytes"],
}


def compare(card: dict, reckoned: dict, exact=tuple(EXACT),
            peak_rel: Optional[float] = None) -> dict:
    """A run's record (:func:`measure_on_device`, or :func:`measure` on
    real tensors) against the dry run's record of the same cell:
    ``{"mismatches": [...], "peak_rel_err": x}``.  Each of ``exact``
    (keys of :data:`EXACT`) must be equal; with ``peak_rel`` the
    reckoned peak above the arguments must lie within ``peak_rel`` of
    ``measured_temp_bytes``, relative to it.  No mismatch: they agree."""
    if reckoned.get("status", "ok") != "ok":
        return {"mismatches": [f"the dry run's cell is {reckoned['status']}"
                               f": {reckoned.get('error') or reckoned}"],
                "peak_rel_err": None}
    bad = [f"{k}: run {EXACT[k](card)} != reckoned {EXACT[k](reckoned)}"
           for k in exact if EXACT[k](card) != EXACT[k](reckoned)]
    err = None
    if peak_rel is not None:
        measured = card["measured_temp_bytes"]
        predicted = reckoned["memory"]["temp_size_in_bytes"]
        err = abs(predicted - measured) / max(measured, 1)
        if err > peak_rel:
            bad.append(f"peak above the arguments: reckoned {predicted} B "
                       f"vs measured {measured} B ({err:.4f} > {peak_rel})")
    return {"mismatches": bad, "peak_rel_err": err}


def _config(arch: str, sell: str, n_layers: int, cfg_overrides,
            smoke: bool):
    cfg = (registry.get_smoke_config(arch) if smoke
           else registry.get_config(arch))
    if sell != "dense":
        cfg = dataclasses.replace(cfg, sell_kind=sell)
    if n_layers:
        upd = {"n_layers": n_layers}
        if cfg.family == "encdec":
            upd["n_encoder_layers"] = n_layers
        cfg = dataclasses.replace(cfg, **upd)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if cfg.sell_kind != "dense" and cfg.sell_method == "pallas":
        raise ValueError("the dry run traces on meta tensors and the "
                         "kernel wrappers have no meta implementation: "
                         "ask for sell_method auto, matmul or fft")
    return cfg


def _inputs(specs: dict, mesh, device, vocab: int, rows: bool) -> dict:
    """``specs``' tensors on ``device``: on ``meta`` as they are, else
    drawn from a numpy generator seeded with :data:`SEED` (tokens below
    ``vocab``, positions and lengths as the cell's); with ``rows`` each
    cut to this rank's rows (``data_specs``)."""
    rng = np.random.default_rng(SEED)
    out = {}
    for k, t in specs.items():
        shape = tuple(t.shape)
        if rows:
            spec = sharding.data_specs(mesh, {k: shape})[k]
            shape = sharding.local_shape(shape, spec, mesh)
            if device != "meta":
                full = _draw(rng, k, tuple(t.shape), t.dtype, vocab)
                out[k] = sharding.local_shard(full, spec, mesh).to(
                    device).contiguous()
                continue
        out[k] = (torch.empty(shape, dtype=t.dtype, device="meta")
                  if device == "meta"
                  else _draw(rng, k, shape, t.dtype, vocab).to(device))
    return out


def _draw(rng, name: str, shape, dtype, vocab: int) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return torch.from_numpy(rng.integers(0, vocab, shape).astype(
        np.int64)).to(dtype)


def build_cell(arch: str, shape_name, mesh, sell: str = "dense",
               accum_steps: int = 1, n_layers: int = 0,
               cfg_overrides: Optional[dict] = None, *, smoke: bool = False,
               device: str = "meta") -> tuple:
    """``(fn, args)``: the cell's placed step and this rank's arguments
    on ``device`` (``meta``; a real run of the same cell, as the tests
    make on gloo, passes ``cpu`` or ``cuda`` and gets values drawn from
    :data:`SEED`).  ``shape_name`` is a name of ``registry.SHAPES`` or a
    ``ShapeCell``; ``smoke`` takes the arch's SMOKE config;
    ``n_layers`` > 0 overrides the depth (and the encoder's)."""
    cfg = _config(arch, sell, n_layers, cfg_overrides, smoke)
    shape = (shape_name if isinstance(shape_name, registry.ShapeCell)
             else registry.get_shape(shape_name))
    model = get_model(cfg)
    specs = registry.input_specs(cfg, shape)
    gen = torch.Generator(device="cpu" if device == "meta"
                          else device).manual_seed(SEED)
    vocab = cfg.vocab_size

    if shape.kind == "train":
        opt = make_optimizer(OptimizerConfig(kind="adamw"),
                             cosine_schedule(3e-4, 1000, 100_000))
        step = steps_mod.make_train_step(model, cfg, opt,
                                         accum_steps=accum_steps, mesh=mesh)
        state = steps_mod.init_state(model, cfg, opt, gen, device,
                                     mesh=mesh)
        batch = _inputs(specs["batch"], mesh, device, vocab, True)
        return step, (state, batch)

    params = sharding.place_params(model.init(gen, cfg, device), mesh)
    b, s = shape.global_batch, shape.seq_len
    cache_like = model.init_cache(cfg, b, s, device="meta")
    placement = sharding.CachePlacement(cache_like, mesh)

    if shape.kind == "prefill":
        # the cell's prefill reads no value of its input cache (frames
        # come with every encoder-decoder row): its placement alone
        inputs = _inputs(specs, mesh, device, vocab, True)
        lengths = (torch.empty((b,), dtype=torch.int32, device="meta")
                   if device == "meta" else
                   torch.full((b,), s, dtype=torch.int32, device=device))
        step = steps_mod.make_prefill_step(model, cfg, full_logits=True,
                                           mesh=mesh)
        args = [params, placement, inputs["tokens"], lengths]
        if "frontend_embeds" in inputs:
            args.append(inputs["frontend_embeds"])
        return step, tuple(args)

    cache = placement.place(cache_like if device == "meta"
                            else model.init_cache(cfg, b, s, device=device))
    if shape.kind == "decode":
        inputs = _inputs(specs, mesh, device, vocab, False)
        if device != "meta":
            inputs["position"] = torch.full((b,), s // 2, dtype=torch.int32,
                                            device=device)
        serve = steps_mod.make_serve_step(model, cfg, mesh=mesh)

        def decode(params, cache, tokens, position):
            return serve(params, cache, tokens, position)

        return decode, (params, cache, inputs["tokens"], inputs["position"])

    raise ValueError(shape.kind)


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_id(arch: str, shape: str, multi_pod: bool,
            sell: str = "dense") -> str:
    return f"{arch}.{shape}.{mesh_name(multi_pod)}" + (
        "" if sell == "dense" else f".{sell}")


def trace_cell(arch: str, shape_name, mesh, sell: str = "dense",
               **build) -> dict:
    """The record of one cell on ``mesh`` (status and, when ``ok``, the
    counters of :func:`measure`); never raises for a cell's own fault.
    A cell with SELL projections is measured after one warm-up call, as
    :func:`measure_on_device` measures it on the card: its transforms'
    matrices are made once a process and cached, so without it the peak
    would hold them or not by what the process traced before."""
    try:
        fn, args = build_cell(arch, shape_name, mesh, sell, **build)
        if sell != "dense":
            fn(*args)
        _, rec = measure(fn, args)
        del fn, args
        return {"status": "ok", **rec}
    except Exception as e:  # noqa: BLE001 -- a failed cell is a port fault
        return {"status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-4000:]}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             sell: str = "dense", save: bool = True) -> dict:
    cid = cell_id(arch, shape_name, multi_pod, sell)
    skip = registry.skips(arch, shape_name)
    if skip:
        rec = {"cell": cid, "status": "skipped", "reason": skip}
    else:
        mesh_mod.init_fake_group(512 if multi_pod else 256)
        mesh = mesh_mod.make_production_mesh(multi_pod, "cpu")
        out = trace_cell(arch, shape_name, mesh, sell)
        rec = {"cell": cid, "status": out.pop("status"), "arch": arch,
               "shape": shape_name, "mesh": mesh_name(multi_pod),
               "sell": sell, "n_devices": int(mesh.size()), **out}
    if save:
        _save(cid, rec)
    return rec


def _save(cid: str, rec: dict) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    (RESULTS_DIR / f"{cid}.json").write_text(json.dumps(rec, indent=1))


def summary(rec: dict) -> str:
    if rec["status"] == "ok":
        mem = rec["memory"]
        return (f" args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB/dev "
                f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
                f"flops={rec['flops_per_device']:.3g} "
                f"coll={rec['collectives']['total_bytes'] / 2**30:.3f}GiB "
                f"({rec['trace_s']:.1f}s)")
    if rec["status"] == "error":
        return " " + rec["error"][:200]
    return ""


def table(sell: str = "dense") -> str:
    """A markdown table of the records in ``RESULTS_DIR``: a row a cell,
    both meshes in it ("single-pod / multi-pod"); bytes at rest and the
    peak (arguments plus temporaries) in GB a rank, TFLOPs a rank,
    collective GB a rank by kind (all-gather, all-reduce,
    reduce-scatter)."""
    def rec(arch, shape, mp):
        path = RESULTS_DIR / f"{cell_id(arch, shape, mp, sell)}.json"
        return json.loads(path.read_text()) if path.exists() else None

    def both(recs, fn):
        return " / ".join(fn(r) for r in recs)

    gb = 1e9
    lines = ["| cell | status | at rest GB | peak GB | TFLOPs | "
             "all-gather GB | all-reduce GB | reduce-scatter GB |",
             "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for arch, shape in registry.cells(include_skipped=True):
        recs = [rec(arch, shape, mp) for mp in (False, True)]
        if any(r is None for r in recs):
            lines.append(f"| {arch} {shape} | not run | | | | | | |")
            continue
        status = {r["status"] for r in recs}
        if status != {"ok"}:
            what = both(recs, lambda r: r["status"])
            lines.append(f"| {arch} {shape} | {what} | | | | | | |")
            continue
        mem = [r["memory"] for r in recs]
        coll = [r["collectives"]["bytes"] for r in recs]
        lines.append(
            f"| {arch} {shape} | ok | "
            + both(mem, lambda m: f"{m['argument_size_in_bytes'] / gb:.2f}")
            + " | " + both(mem, lambda m: f"{(m['argument_size_in_bytes'] + m['temp_size_in_bytes']) / gb:.1f}")
            + " | " + both(recs, lambda r: f"{r['flops_per_device'] / 1e12:.0f}")
            + " | " + " | ".join(
                both(coll, lambda c, k=k: f"{c[k] / gb:.1f}")
                for k in ("all-gather", "all-reduce", "reduce-scatter"))
            + " |")
    return "\n".join(lines)


def mesh_of(shape: tuple, device_type: str) -> DeviceMesh:
    """A mesh of ``shape`` over the group's first ranks: ("data",
    "model") for two axes, ("pod", "data", "model") for three."""
    names = (("pod", "data", "model") if len(shape) == 3
             else ("data", "model"))
    return DeviceMesh(device_type,
                      torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


def parse_reckon(spec: str) -> tuple:
    """``ARCH:KIND:SEQ:BATCH:MESH[:DTYPE]`` (MESH as ``2x2x1``) ->
    ``(arch, ShapeCell, mesh shape, cfg_overrides)``."""
    arch, kind, seq, batch, shape, *dtype = spec.split(":")
    cell = registry.ShapeCell(f"{kind}_{seq}x{batch}", int(seq), int(batch),
                              kind)
    return (arch, cell, tuple(int(d) for d in shape.split("x")),
            {"dtype": dtype[0]} if dtype else None)


def reckon(specs: list, sell: str) -> dict:
    """``{spec: record}``: each cell of :func:`parse_reckon` traced on
    meta tensors as rank 0 of a fake group as large as its mesh."""
    out = {}
    try:
        for spec in specs:
            arch, cell, shape, overrides = parse_reckon(spec)
            mesh_mod.init_fake_group(int(np.prod(shape)))
            out[spec] = trace_cell(arch, cell, mesh_of(shape, "cpu"), sell,
                                   cfg_overrides=overrides)
    finally:
        mesh_mod.shutdown()
    return out


def start_reckoning(specs: list, sell: str, out: Path) -> subprocess.Popen:
    """Start ``python -m repro_torch.launch.dryrun --reckon ...`` for
    ``specs`` in a subprocess with CUDA hidden (its fake group is its
    own), writing to ``out``; :func:`reckoned` waits for it."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    src = str(Path(__file__).resolve().parents[2])
    path = os.environ.get("PYTHONPATH")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--sell", sell,
           "--out", str(out)]
    for spec in specs:
        cmd += ["--reckon", spec]
    return subprocess.Popen(
        cmd, env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                  "PYTHONPATH": src + (os.pathsep + path if path else "")},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def reckoned(proc: subprocess.Popen, out: Path, timeout: float = 900
             ) -> dict:
    """The records of a :func:`start_reckoning` subprocess; raises if it
    failed."""
    text, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the dry-run subprocess failed: {text[-3000:]}")
    return json.loads(Path(out).read_text())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=registry.CELL_ARCHS)
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in registry.SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--sell", default="dense",
                    help="SELL kind for projections (dense|acdc|...)")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have records")
    ap.add_argument("--table", action="store_true",
                    help="print the records as a markdown table; trace "
                         "nothing")
    ap.add_argument("--reckon", action="append", default=[],
                    metavar="ARCH:KIND:SEQ:BATCH:MESH[:DTYPE]",
                    help="trace this cell at this mesh (e.g. 2x2x1) and "
                         "write its record to --out (repeatable)")
    ap.add_argument("--out", default=None,
                    help="the JSON file of --reckon's records")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.sell))
        return
    if args.reckon:
        if not args.out:
            ap.error("--reckon needs --out")
        torch.set_num_threads(1)
        Path(args.out).write_text(json.dumps(reckon(args.reckon,
                                                    args.sell)))
        return

    if args.all:
        cells = registry.cells(include_skipped=True)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    torch.set_num_threads(1)
    try:
        for arch, shape in cells:
            for mp in meshes:
                cid = cell_id(arch, shape, mp, args.sell)
                path = RESULTS_DIR / f"{cid}.json"
                if not args.force and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip-cached] {cid}")
                        continue
                rec = run_cell(arch, shape, mp, sell=args.sell)
                print(f"[{rec['status']}] {cid}{summary(rec)}", flush=True)
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    main()
