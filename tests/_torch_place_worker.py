"""One rank of the port's placed train state over gloo, for
``test_torch_placement.py``.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_place_worker.py REF.npz OUT_DIR

``REF.npz`` is what ``_jax_placed_steps.py`` wrote.  On two ranks the
mesh is (data=2, model=1), on four (2, 2).  Every rank runs, in order:

* ``parity``: the reference's initial state placed by
  ``sharding.place_state``, two steps of ``make_train_step(mesh=)`` on
  this rank's rows of the reference's batches (smoke Qwen3-1.7B,
  ``acdc`` on ``pallas``, fp32, the reference's optimizer): this rank's
  final blocks and the metrics;
* ``gather``: the gather's backward on a (4, 6) leaf, over "data" (rank
  r's upstream gradient seeded by its data coordinate: summed and
  halved), over "model" (one upstream gradient: sliced, not summed) and,
  on four ranks, over both;
* ``norm``: the mesh-wide global norm and the clipped AdamW update of a
  seeded gradient tree against the unplaced ones;
* two ranks only: ``family`` (two placed steps of smoke DeepSeekMoE-16B
  on (1, 2), the experts split over "model", of Zamba2-1.2B and of
  Seamless-M4T on (2, 1), against the port's replicated steps);
  ``compress`` (two placed ``--compress-grads`` steps against two
  unplaced ones); ``saved`` (which gathered layers outlive a placed
  forward, with and without remat); ``ckpt`` (the launcher's ``build``
  and ``run`` at (2, 1) with a checkpoint, restored at (2, 1));
* four ranks only: ``launcher`` (``launch.train.main`` at
  ``--model-parallel 2`` with a checkpoint).

Writes ``OUT_DIR/rank<r>.npz`` (arrays, keyed ``<scenario>/...``) and
``OUT_DIR/rank<r>.json`` (facts).
"""

import dataclasses
import gc
import json
import os
import sys
import weakref
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import sharding, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.models import get_model
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim import schedules

METRICS = ("loss", "grad_norm", "update_norm")
OPT = opt_mod.OptimizerConfig(kind="adamw", lr=3e-3,
                              groups=train.SELL_GROUPS)
SCHEDULE = schedules.cosine_schedule(OPT.lr, 1, 6)


def smoke(arch: str):
    cfg = registry.with_sell(registry.get_smoke_config(arch), "acdc",
                             method="pallas")
    return cfg, get_model(cfg), opt_mod.make_optimizer(OPT, SCHEDULE)


def blocks(state: dict, prefix: str) -> dict:
    """{prefix/params/..., prefix/opt/...}: this rank's blocks."""
    paths, leaves = opt_mod.tree_flatten({k: state[k]
                                          for k in ("params", "opt")})
    return {f"{prefix}/{p}": t.detach().numpy().copy()
            for p, t in zip(paths, leaves)}


def parity(ref, mesh, arrays: dict, facts: dict) -> None:
    cfg, model, opt = smoke("qwen3_1_7b")
    init = {k[len("init/"):]: ref[k] for k in ref.files
            if k.startswith("init/")}
    state = sharding.place_state(bridge.state_to_torch(init, "cpu"), mesh)
    like = steps.abstract_state(model, cfg, opt)
    specs = dict(zip(*opt_mod.tree_flatten(sharding.param_specs(
        {k: like[k] for k in ("params", "opt")}, mesh))))
    shapes = dict(zip(*opt_mod.tree_flatten(
        {k: like[k] for k in ("params", "opt")})))
    facts["reckoned_numel"] = sum(
        int(np.prod(sharding.local_shape(shapes[p].shape, specs[p], mesh)))
        for p in specs)
    facts["local_numel"] = sum(
        t.numel() for t in opt_mod.tree_flatten(
            {k: state[k] for k in ("params", "opt")})[1])
    step = steps.make_train_step(model, cfg, opt, mesh=mesh)
    rank, size = mesh.get_local_rank("data"), mesh.shape[0]
    metrics = {k: [] for k in METRICS}
    for s in range(len(ref["m21/loss"])):
        batch = {k.split("/")[1]: torch.from_numpy(ref[k])
                 for k in ref.files if k.startswith(f"batch{s}/")}
        per = batch["tokens"].shape[0] // size
        rows = {k: t[rank * per:(rank + 1) * per] for k, t in batch.items()}
        state, met = step(state, rows)
        for k in METRICS:
            metrics[k].append(float(met[k]))
    arrays.update(blocks(state, "parity"))
    facts["parity_metrics"] = metrics


def gather_case(mesh, spec) -> float:
    """max |grad of this rank's block - its block of the data ranks' mean
    upstream gradient| (plus the gathered leaf's error) for a (4, 6) leaf
    placed by ``spec``; a rank's upstream gradient is seeded by its data
    coordinate (the ranks of one data row compute the same loss)."""
    full = torch.arange(24.0).reshape(4, 6)
    local = sharding.local_shard(full, spec, mesh).clone()
    local.requires_grad_(True)
    y = sharding.gather(local, spec, mesh)
    ups = [torch.randn(4, 6, generator=torch.Generator().manual_seed(s))
           for s in range(mesh.shape[0])]
    (y * ups[mesh.get_local_rank("data")]).sum().backward()
    want = sharding.local_shard(sum(ups) / len(ups), spec, mesh)
    return float((local.grad - want).abs().max()) + float(
        (y.detach() - full).abs().max())


def gather(world: int, facts: dict) -> None:
    if world == 2:
        facts["gather_data"] = gather_case(
            mesh_mod.make_host_mesh(1, "cpu"), ("data", None))
        facts["gather_model"] = gather_case(
            mesh_mod.make_host_mesh(2, "cpu"), (None, "model"))
    else:
        facts["gather_both"] = gather_case(
            mesh_mod.make_host_mesh(2, "cpu"), ("data", "model"))


def norm(mesh, facts: dict) -> None:
    cfg, model, opt = smoke("qwen3_1_7b")
    gen = torch.Generator().manual_seed(1)
    params = model.init(gen, cfg, "cpu")
    grads = opt_mod.tree_map(
        lambda p: torch.randn(p.shape, generator=gen), params)
    placement = sharding.Placement(steps.abstract_state(model, cfg, opt),
                                   mesh)
    want = opt_mod.global_norm(grads)
    got = placement.norm()(placement.local(grads))
    facts["norm"] = [float(got), float(want)]
    state = opt.init(params)
    upd, _ = opt.update(grads, state, params, 3)
    local_p = placement.local(params)
    lstate = opt.init(local_p)
    lupd, _ = opt.update(placement.local(grads), lstate, local_p, 3,
                         norm=placement.norm())
    want = placement.local(upd)
    facts["clip_max_err"] = max(
        float((a - b).abs().max()) for a, b in zip(
            opt_mod.tree_flatten(lupd)[1], opt_mod.tree_flatten(want)[1]))


def batches(cfg, n: int, seq: int = 32) -> list:
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=4,
        frontend=cfg.frontend, d_model=cfg.d_model,
        n_frontend_tokens=(cfg.n_frontend_tokens
                           or (seq // 4 if cfg.frontend == "audio" else 0))))
    return [data.batch_at(s) for s in range(n)]


def rows_of(batch, mesh) -> dict:
    rank, size = mesh.get_local_rank("data"), mesh.shape[0]
    per = batch["tokens"].shape[0] // size
    return {k: t[rank * per:(rank + 1) * per] for k, t in batch.items()}


def family(arrays: dict, facts: dict) -> None:
    for arch, model_axis in (("deepseek_moe_16b", 2), ("zamba2_1_2b", 1),
                             ("seamless_m4t_large_v2", 1)):
        mesh = mesh_mod.make_host_mesh(model_axis, "cpu")
        cfg, model, opt = smoke(arch)
        rows = [rows_of(b, mesh) for b in batches(cfg, 2)]
        out = {}
        for side, m in (("replicated", None), ("placed", mesh)):
            gen = torch.Generator().manual_seed(0)
            state = steps.init_state(model, cfg, opt, gen, "cpu", mesh=m)
            step = (steps.make_train_step(model, cfg, opt, mesh=mesh)
                    if m is not None else steps.make_train_step(
                        model, cfg, opt, group=mesh.get_group("data")))
            mets = []
            for batch in rows:
                state, met = step(state, batch)
                mets.append({k: float(v) for k, v in met.items()})
            if m is None:
                placement = sharding.Placement(state, mesh)
                state = {"params": placement.local(state["params"]),
                         "opt": placement.local(state["opt"], "opt")}
            arrays.update(blocks(state, f"family/{arch}/{side}"))
            out[side] = mets
        facts[f"family/{arch}"] = out


def compress(arrays: dict, facts: dict) -> None:
    mesh = mesh_mod.make_host_mesh(1, "cpu")
    cfg, model, opt = smoke("qwen3_1_7b")
    out = {}
    for side, m in (("replicated", None), ("placed", mesh)):
        gen = torch.Generator().manual_seed(0)
        state = steps.init_state(model, cfg, opt, gen, "cpu", compress_dp=1,
                                 mesh=m)
        step = steps.make_train_step(model, cfg, opt, compress=True,
                                     group=mesh.get_group("data"), mesh=m)
        mets = []
        for batch in batches(cfg, 2):
            state, met = step(state, rows_of(batch, mesh))
            mets.append({k: float(v) for k, v in met.items()})
        if m is None:
            placement = sharding.Placement(state, mesh)
            state = {**state, "params": placement.local(state["params"]),
                     "opt": placement.local(state["opt"], "opt")}
        arrays.update(blocks(state, f"compress/{side}"))
        arrays.update({f"compress/{side}/grad_error/{k}": v
                       for k, v in bridge.to_numpy(
                           state["grad_error"]).items()})
        out[side] = mets
    facts["compress"] = out


def saved(facts: dict) -> None:
    """Gathered layers alive after a placed forward: under remat none (the
    layer is gathered inside its checkpointed function), without remat
    every one (its products saved them); and which full layer shapes
    that differ from their blocks' the forward saved outside the
    checkpointed functions."""
    mesh = mesh_mod.make_host_mesh(1, "cpu")
    for remat in (True, False):
        cfg, model, opt = smoke("qwen3_1_7b")
        cfg = dataclasses.replace(cfg, remat=remat)
        placement = sharding.Placement(steps.abstract_state(model, cfg, opt),
                                       mesh)
        gen = torch.Generator().manual_seed(0)
        state = steps.init_state(model, cfg, opt, gen, "cpu", mesh=mesh)
        layers = opt_mod.tree_flatten(state["params"]["layers"])
        full = {tuple(placement.shapes[f"params/layers/{p}"][1:])
                for p in layers[0]}
        gathered_only = full - {tuple(t.shape[1:]) for t in layers[1]}
        gathered, kept = [], []
        real = sharding.PlacedStack.layer

        def layer(self, i):
            out = real(self, i)
            gathered.extend(weakref.ref(t)
                            for t in opt_mod.tree_flatten(out)[1])
            return out

        sharding.PlacedStack.layer = layer
        try:
            for p in opt_mod.tree_flatten(state["params"])[1]:
                p.requires_grad_(True)
            with torch.autograd.graph.saved_tensors_hooks(
                    lambda t: (kept.append(t), t)[1], lambda t: t):
                loss = model.loss_fn(placement.view(state["params"]),
                                     rows_of(batches(cfg, 1)[0], mesh), cfg)
            gc.collect()
            alive = sum(r() is not None for r in gathered)
            n_gathered = len(gathered)
            loss.backward()
        finally:
            sharding.PlacedStack.layer = real
        facts[f"saved/remat={remat}"] = dict(
            gathered=n_gathered, alive=alive,
            gathered_only_shapes=len(gathered_only),
            saved_gathered_shapes=sorted(
                {tuple(t.shape) for t in kept} & gathered_only))


def ckpt(out: Path, arrays: dict, facts: dict) -> None:
    args = train.parse_args([
        "--smoke", "--sell", "acdc", "--sell-method", "pallas", "--device",
        "cpu", "--steps", "2", "--global-batch", "4", "--seq-len", "16",
        "--ckpt-every", "0", "--log-every", "1",
        "--ckpt-dir", str(out / "ckpt21")])
    cfg, model, opt, step, pipeline = train.build(args)
    state, hist = train.run(args, cfg, model, opt, step, pipeline)
    torch.distributed.barrier()     # rank 0 has written the checkpoint
    ck = train.CheckpointManager(args.ckpt_dir)
    back = train._restore(ck, ck.latest_step(), model, cfg, opt, args,
                          pipeline.dp)
    same = [torch.equal(a, b) for a, b in zip(
        opt_mod.tree_flatten({k: state[k] for k in ("params", "opt")})[1],
        opt_mod.tree_flatten({k: back[k] for k in ("params", "opt")})[1])]
    facts["ckpt"] = dict(restored_equal=all(same), leaves=len(same),
                         losses=[h["loss"] for h in hist])
    arrays.update(blocks(state, "ckpt"))


def main(src: str, out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    mesh = mesh_mod.make_host_mesh(world // 2, "cpu")
    ref = np.load(src)
    arrays, facts = {}, {"coord": [mesh.get_local_rank("data"),
                                   mesh.get_local_rank("model")]}
    try:
        parity(ref, mesh, arrays, facts)
        gather(world, facts)
        norm(mesh, facts)
        if world == 2:
            family(arrays, facts)
            compress(arrays, facts)
            saved(facts)
            ckpt(out, arrays, facts)
        np.savez(out / f"rank{rank}.npz", **arrays)
        (out / f"rank{rank}.json").write_text(json.dumps(facts))
        if world == 4:
            _, hist = train.main([
                "--smoke", "--sell", "acdc", "--sell-method", "pallas",
                "--device", "cpu", "--model-parallel", "2", "--steps", "3",
                "--global-batch", "4", "--seq-len", "16", "--ckpt-every",
                "2", "--log-every", "1", "--ckpt-dir", str(out / "ckpt22")])
            (out / f"launcher{rank}.json").write_text(json.dumps(
                [h["loss"] for h in hist]))
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    assert "RANK" in os.environ, "start one process a rank (torchrun's env)"
    main(sys.argv[1], sys.argv[2])
