"""One of four gloo ranks of the port's tensor-parallel placed steps, for
``test_torch_tensor_parallel.py``.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_tp_worker.py IN.npz OUT_DIR

``IN.npz`` is what the test drew (``_jax_tp_ref.py`` reads the same
file).  For each case and each of its meshes ("data", "model") over the
group's first ranks: the state from the params with fresh AdamW moments
placed by ``place_state``, one ``make_train_step(mesh=)`` step a batch
on this rank's rows (a rank outside a mesh of two only joins its
making); it keeps the metrics and its blocks of the final params.  A
case with ``accum`` 2 also runs the steps with ``accum_steps=2``
(``<case>/<mesh>/accum2``).  A
case with a prefill: ``make_prefill_step(full_logits=True, mesh=)`` at
(2, 2) on this rank's rows of a fresh cache placed by ``cache_specs``,
the logits gathered over the vocabulary, and its blocks of the new cache
with the slices of the full leaves they are; an encoder-decoder's also
runs the placed prefill without frames on a cache of more frame slots
than frames (the port's unplaced prefill's cross K/V written into the
leading slots, ``xlen`` the frame count), whose logits must be the
prefill's with frames (``prefill/noframes_logits``).  A case's optional
``overrides`` (JSON) replaces fields of its config.  ``structure``: one
placed step of a smoke config (``structure/arch``, Qwen3-1.7B by
default; dense; 8 stub frames a row for an audio frontend) at (1, 4)
counted by the dry run's ``Collectives``,
beside the bytes of its leaves.  A case that raises is recorded
(``errors``) and the others run on.

Writes ``OUT_DIR/rank<r>.npz`` and ``OUT_DIR/rank<r>.json``.
"""

import dataclasses
import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.dist import sharding, steps
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.models import get_model
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim import schedules

METRICS = ("loss", "grad_norm", "update_norm")


def under(src, prefix: str) -> dict:
    return {k[len(prefix):]: src[k] for k in src.files
            if k.startswith(prefix)}


def config(src, pre: str):
    cfg = registry.get_smoke_config(str(src[pre + "arch"]))
    if str(src[pre + "sell"]) == "acdc":
        cfg = registry.with_sell(cfg, "acdc", method="pallas")
    overrides = (json.loads(str(src[pre + "overrides"]))
                 if pre + "overrides" in src.files else {})
    return dataclasses.replace(
        cfg, capacity_factor=float(src[pre + "capacity_factor"]),
        **overrides)


def optimizer():
    return opt_mod.make_optimizer(
        opt_mod.OptimizerConfig(kind="adamw", lr=3e-3,
                                groups=train.SELL_GROUPS),
        schedules.cosine_schedule(3e-3, 1, 6))


def coord_of(mesh) -> dict:
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def rows_of(mesh, b: int) -> slice:
    return sharding.shard_slices(
        (b,), sharding.rows_spec(mesh, b), sharding._axis_sizes(mesh),
        coord_of(mesh))[0]


def train_case(src, case: str, tag: str, arrays: dict, facts: dict,
               accum: int = 1) -> None:
    pre = f"{case}/"
    shape = tuple(int(d) for d in tag.split("x"))
    mesh = dryrun.mesh_of(shape, "cpu")
    if int(os.environ["RANK"]) >= shape[0] * shape[1]:
        return          # outside this mesh: it only joined its making
    cfg = config(src, pre)
    model, opt = get_model(cfg), optimizer()
    params = bridge.to_torch(under(src, pre + "params/"), "cpu")
    state = sharding.place_state({"params": params,
                                  "opt": opt.init(params), "step": 0}, mesh)
    step = steps.make_train_step(model, cfg, opt, accum_steps=accum,
                                 mesh=mesh)
    n_steps = len({k.split("/")[1] for k in src.files
                   if k.startswith(pre + "batch")})
    metrics = {k: [] for k in METRICS}
    for s in range(n_steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in under(src, f"{pre}batch{s}/").items()}
        rows = rows_of(mesh, batch["tokens"].shape[0])
        state, met = step(state, {k: t[rows] for k, t in batch.items()})
        for k in METRICS:
            metrics[k].append(float(met[k]))
    d, m = (mesh.get_local_rank(a) for a in ("data", "model"))
    key = f"{case}/{tag}" + (f"/accum{accum}" if accum > 1 else "")
    paths, leaves = opt_mod.tree_flatten(state["params"])
    arrays.update({f"{key}/{p}": t.numpy().copy()
                   for p, t in zip(paths, leaves)})
    facts[key] = dict(metrics=metrics, coord=[d, m])


def prefill_case(src, case: str, arrays: dict, facts: dict) -> None:
    pre = f"{case}/"
    cfg = config(src, pre)
    model = get_model(cfg)
    mesh = dryrun.mesh_of((2, 2), "cpu")
    params = sharding.place_params(
        bridge.to_torch(under(src, pre + "params/"), "cpu"), mesh)
    tokens = torch.from_numpy(src[pre + "prefill/tokens"])
    lengths = torch.from_numpy(src[pre + "prefill/lengths"])
    b = tokens.shape[0]
    rows = rows_of(mesh, b)
    fe = (torch.from_numpy(src[pre + "prefill/frontend_embeds"])[rows]
          if pre + "prefill/frontend_embeds" in src.files else None)
    cache = sharding.place_cache(model.init_cache(
        cfg, b, int(src[pre + "prefill/cache_len"]), device="cpu"), mesh)
    step = steps.make_prefill_step(model, cfg, full_logits=True, mesh=mesh)
    logits, cache = step(params, cache, tokens[rows], lengths, fe)
    block = logits.shape[-1]
    logits = steps.gather_vocab(logits, steps.tensor_split(cfg, mesh))
    arrays[pre + "prefill/logits"] = logits.numpy().copy()
    if cfg.family == "encdec":
        arrays[pre + "prefill/noframes_logits"] = noframes_logits(
            src, pre, cfg, model, mesh, step, rows)
    pl = cache.placement
    slices = {}
    for k, t in cache.items():
        arrays[f"{pre}prefill/cache/{k}"] = t.numpy().copy()
        slices[k] = [[s.start, s.stop] for s in sharding.shard_slices(
            pl.shapes[k], pl.specs[k], pl.sizes, coord_of(mesh))]
    facts[f"{case}/prefill"] = dict(rows=[rows.start, rows.stop],
                                    vocab_block=block, slices=slices)


def noframes_logits(src, pre: str, cfg, model, mesh, step, rows):
    """The placed prefill without frames, this rank's rows, on a cache
    whose leading frame slots hold the port's unplaced prefill's cross
    K/V of the case's frames and ``xlen`` their count: its keys beyond
    the frames are masked, so its logits are the prefill's with them."""
    params = bridge.to_torch(under(src, pre + "params/"), "cpu")
    tokens = torch.from_numpy(src[pre + "prefill/tokens"])
    lengths = torch.from_numpy(src[pre + "prefill/lengths"])
    frames = torch.from_numpy(src[pre + "prefill/frontend_embeds"])
    b, f = frames.shape[:2]
    cache = model.init_cache(cfg, b, int(src[pre + "prefill/cache_len"]),
                             device="cpu")
    if cache["xk"].shape[2] <= f:
        raise ValueError("the case's frames must leave cache slots empty")
    with torch.no_grad():
        _, made = model.prefill(params, model.init_cache(
            cfg, b, cache["k"].shape[2], device="cpu"), tokens, cfg,
            lengths, frames)
    for k in ("xk", "xv"):
        cache[k][:, :, :f] = made[k]
    cache["xlen"].fill_(f)
    logits, _ = step(sharding.place_params(params, mesh),
                     sharding.place_cache(cache, mesh), tokens[rows],
                     lengths)
    return steps.gather_vocab(logits, steps.tensor_split(cfg, mesh)
                              ).numpy().copy()


def structure(facts: dict, arch: str = "qwen3_1_7b") -> None:
    """One placed step of smoke ``arch`` (dense, fp32) at (1, 4) under
    the dry run's ``Collectives``, and the full bytes of every leaf."""
    cfg = registry.get_smoke_config(arch)
    model, opt = get_model(cfg), optimizer()
    mesh = dryrun.mesh_of((1, 4), "cpu")
    gen = torch.Generator().manual_seed(0)
    state = steps.init_state(model, cfg, opt, gen, "cpu", mesh=mesh)
    step = steps.make_train_step(model, cfg, opt, mesh=mesh)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = torch.randn(4, 8, cfg.d_model,
                                               generator=g)
    coll = dryrun.Collectives()
    with coll:
        step(state, batch)
    like = model.init(torch.Generator(), cfg, "meta")
    paths, leaves = opt_mod.tree_flatten(like)
    facts["structure"] = dict(
        collectives=coll.record(), remat=cfg.remat,
        leaves={p: [list(t.shape), t.element_size()]
                for p, t in zip(paths, leaves)})


def main(src: str, out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    rank = int(os.environ["RANK"])
    mesh_mod.init_process_group("cpu")
    src = np.load(src)
    arrays, facts, errors = {}, {}, {}
    try:
        for case in sorted({k.split("/")[0] for k in src.files}
                           - {"structure"}):
            for tag in str(src[f"{case}/meshes"]).split(","):
                for accum in range(1, int(src[f"{case}/accum"]) + 1):
                    key = f"{case}/{tag}" + (f"/accum{accum}"
                                             if accum > 1 else "")
                    try:
                        train_case(src, case, tag, arrays, facts, accum)
                    except Exception:  # noqa: BLE001 -- for the test
                        errors[key] = traceback.format_exc()[-3000:]
            if f"{case}/prefill/tokens" in src.files:
                try:
                    prefill_case(src, case, arrays, facts)
                except Exception:  # noqa: BLE001
                    errors[f"{case}/prefill"] = traceback.format_exc()[-3000:]
        try:
            structure(facts, str(src["structure/arch"])
                      if "structure/arch" in src.files else "qwen3_1_7b")
        except Exception:  # noqa: BLE001
            errors["structure"] = traceback.format_exc()[-3000:]
        facts["errors"] = errors
        np.savez(out / f"rank{rank}.npz", **arrays)
        (out / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    assert "RANK" in os.environ, "start one process a rank (torchrun's env)"
    main(sys.argv[1], sys.argv[2])
