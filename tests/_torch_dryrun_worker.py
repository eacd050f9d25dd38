"""One of four gloo ranks of the port's placed steps, for
``test_torch_dryrun.py``.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_dryrun_worker.py IN.npz OUT_DIR

``IN.npz`` is what the test drew (``_jax_dryrun_ref.py`` reads the same
file).  Every rank runs, in order:

* ``train``: smoke Qwen3-1.7B placed at rest on the mesh ("pod", "data",
  "model") = (2, 2, 1) from ``train/params``, the steps of
  ``make_train_step(mesh=)`` on this rank's rows of each batch: the
  losses and this rank's final blocks;
* ``serve``: smoke Qwen3-1.7B at (data 4, model 1) and smoke DeepSeek-67B
  (one KV head) at (2, 2): params placed by ``param_specs``, a (B, 16)
  cache placed by ``cache_specs``, ``make_prefill_step(full_logits=True,
  mesh=)`` on this rank's rows, then ``DECODE_STEPS`` greedy
  ``make_serve_step(mesh=)`` steps from ``first``: the logits rows, the
  cache blocks after each phase (with the slices of the full leaf they
  are) and the next tokens;
* ``refused``: smoke Qwen3-1.7B's decode at (2, 2) on a cache whose
  placement was made by hand to split the batch of ``k`` over "model"
  (no rule makes such a split; no step reads it): the leaf and spec it
  raises with;
* ``counted``: the dry run's cells of ``_torch_dryrun_fake.COMPARE``
  built on real CPU tensors (``build_cell(device="cpu")``) and run once
  under the dry run's counters.

Writes ``OUT_DIR/rank<r>.npz`` and ``OUT_DIR/rank<r>.json``.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.dist import sharding, steps
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import get_model
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim import schedules

import _torch_dryrun_fake as fake

DECODE_STEPS = 3
CACHE_LEN = 16
SERVED = (("qwen3_1_7b", (4, 1)), ("deepseek_67b", (2, 2)))


def under(src, prefix: str) -> dict:
    return {k[len(prefix):]: src[k] for k in src.files
            if k.startswith(prefix)}


def host_mesh(shape) -> DeviceMesh:
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    return DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=names)


def train(src, arrays: dict, facts: dict) -> None:
    cfg = registry.get_smoke_config("qwen3_1_7b")
    model = get_model(cfg)
    opt = opt_mod.make_optimizer(
        opt_mod.OptimizerConfig(kind="adamw", lr=3e-3),
        schedules.cosine_schedule(3e-3, 1, 6))
    mesh = host_mesh((2, 2, 1))
    params = bridge.to_torch(under(src, "train/params/"), "cpu")
    state = sharding.place_state(
        {"params": params, "opt": opt.init(params), "step": 0}, mesh)
    step = steps.make_train_step(model, cfg, opt, mesh=mesh)
    losses = []
    n_steps = len({k.split("/")[1] for k in src.files
                   if k.startswith("train/batch")})
    for s in range(n_steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in under(src, f"train/batch{s}/").items()}
        specs = sharding.data_specs(mesh, batch)
        rows = {k: sharding.local_shard(t, specs[k], mesh)
                for k, t in batch.items()}
        state, met = step(state, rows)
        losses.append(float(met["loss"]))
    facts["train"] = dict(losses=losses, coord=[
        mesh.get_local_rank(a) for a in ("pod", "data", "model")])
    paths, leaves = opt_mod.tree_flatten({k: state[k]
                                          for k in ("params", "opt")})
    arrays.update({f"train/{p}": t.numpy().copy()
                   for p, t in zip(paths, leaves)})


def cache_slices(cache: sharding.PlacedCache) -> dict:
    pl = cache.placement
    coord = {a: pl.mesh.get_local_rank(a) for a in pl.mesh.mesh_dim_names}
    return {k: [[s.start, s.stop] for s in sharding.shard_slices(
        pl.shapes[k], pl.specs[k], pl.sizes, coord)] for k in cache}


def serve(src, arrays: dict, facts: dict) -> None:
    for arch, shape in SERVED:
        cfg = registry.get_smoke_config(arch)
        model = get_model(cfg)
        mesh = host_mesh(shape)
        pre = f"serve/{arch}/"
        params = sharding.place_params(
            bridge.to_torch(under(src, pre + "params/"), "cpu"), mesh)
        tokens = torch.from_numpy(src[pre + "tokens"])
        lengths = torch.from_numpy(src[pre + "lengths"])
        b = tokens.shape[0]
        cache = sharding.place_cache(
            model.init_cache(cfg, b, CACHE_LEN, device="cpu"), mesh)
        spec = sharding.rows_spec(mesh, b)
        rows = sharding.shard_slices(
            (b,), spec, sharding._axis_sizes(mesh),
            {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names})[0]
        prefill = steps.make_prefill_step(model, cfg, full_logits=True,
                                          mesh=mesh)
        logits, cache = prefill(params, cache, tokens[rows], lengths)
        # this rank's block of the vocabulary, gathered over "model"
        logits = steps.gather_vocab(logits, steps.tensor_split(cfg, mesh))
        arrays[pre + "logits"] = logits.numpy().copy()
        arrays.update({f"{pre}cache/{k}": v.numpy().copy()
                       for k, v in cache.items()})
        after_prefill = cache_slices(cache)
        step = steps.make_serve_step(model, cfg, mesh=mesh)
        tok, pos = torch.from_numpy(src[pre + "first"]), lengths.clone()
        nxt = []
        for _ in range(DECODE_STEPS):
            tok, cache = step(params, cache, tok, pos)
            nxt.append(tok.tolist())
            pos = pos + 1
        arrays.update({f"{pre}final/{k}": v.numpy().copy()
                       for k, v in cache.items()})
        facts[pre.rstrip("/")] = dict(
            rows=[rows.start, rows.stop], next=nxt,
            cache_slices=after_prefill, final_slices=cache_slices(cache))


def refused(facts: dict) -> None:
    cfg = registry.get_smoke_config("qwen3_1_7b")
    model = get_model(cfg)
    mesh = host_mesh((2, 2))
    params = sharding.place_params(
        model.init(torch.Generator().manual_seed(0), cfg, "cpu"), mesh)
    cache = sharding.place_cache(model.init_cache(cfg, 4, CACHE_LEN, "cpu"),
                                 mesh)
    cache.placement.specs["k"] = (None, "model", None, None, None)
    step = steps.make_serve_step(model, cfg, mesh=mesh)
    try:
        step(params, cache, torch.zeros(4, dtype=torch.int32),
             torch.zeros(4, dtype=torch.int32))
        facts["refused"] = None
    except sharding.CacheSplitError as e:
        facts["refused"] = dict(leaf=e.leaf, spec=list(e.spec),
                                message=str(e))


def counted(facts: dict) -> None:
    meshes = {"m22": host_mesh((2, 2)), "m221": host_mesh((2, 2, 1))}
    out = {}
    for tag, arch, name in fake.COMPARE:
        fn, args = dryrun.build_cell(arch, fake.SMALL[name], meshes[tag],
                                     smoke=True, device="cpu")
        _, rec = dryrun.measure(fn, args)
        out[f"{tag}/{arch}/{name}"] = rec
    facts["counted"] = out


def main(src: str, out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    rank = int(os.environ["RANK"])
    mesh_mod.init_process_group("cpu")
    src = np.load(src)
    arrays, facts = {}, {}
    try:
        train(src, arrays, facts)
        serve(src, arrays, facts)
        refused(facts)
        counted(facts)
        np.savez(out / f"rank{rank}.npz", **arrays)
        (out / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    assert "RANK" in os.environ, "start one process a rank (torchrun's env)"
    main(sys.argv[1], sys.argv[2])
