"""Port parity, the train state placed at rest by the sharding rules
(``repro_torch.dist.sharding``'s runtime half, ``make_train_step(mesh=)``,
the launcher's placed state and checkpoints) over gloo on the CPU.

* **Blocks.** ``shard_slices`` of every leaf of the ten configs'
  full-width train states (params, AdamW moments, step; ``acdc``
  projections) at every coordinate of the meshes (2, 1), (1, 2) and
  (2, 2), equal to the reference's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` on forced host
  devices (shapes only).
* **Shard for shard against the reference.** Two steps of smoke
  Qwen3-1.7B (``acdc`` on ``pallas``, fp32, batch 4 x 32, the launcher's
  AdamW) on 2 gloo ranks at (2, 1) and 4 at (2, 2), from the
  reference's initial state placed by ``place_state``, against the
  reference's step jitted with ``param_shardings`` on forced host
  devices (``_jax_placed_steps.py``, a subprocess): each rank's blocks of
  every parameter and moment equal the reference's block at the same
  mesh coordinate, and the metrics equal, at fp32 atol 2e-4 / rtol 1e-3
  (tests/test_kernel_grads.py:248); each rank holds only its blocks (its
  elements add up to what ``param_specs`` reckons).
* **The gather's backward** (``_torch_place_worker.py``): over "data"
  the data ranks' upstream gradients summed and halved; over "model" the
  rank's slice, not a sum; over both, both.
* **Mesh-wide norm and clip** equal to the unplaced ones.
* **Per family**: two placed steps of smoke DeepSeekMoE-16B on (1, 2)
  (the expert axis), Zamba2-1.2B (the shared block) and Seamless-M4T
  (both stacks) on (2, 1), against the port's replicated steps.
* **Remat**: after a placed forward under remat no gathered layer is
  alive and the forward saved none (without remat: alive and saved).
* **Checkpoints**: saved by the launcher at (2, 1) (gathered to rank 0),
  restored at (2, 1) to the same blocks and at (1, 1) to the full leaves
  those blocks cut from; ``--compress-grads`` placed at (2, 1) equals the
  unplaced compressed step bit for bit; a model axis above 1 with it is
  refused; ``launch.train.main --model-parallel 2`` on four ranks trains
  and checkpoints full leaves.

The reference subprocess and the six ranks run once for the module (one
torch thread each); ~40 worker-seconds.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as tshard
from repro_torch.dist import steps as tsteps
from repro_torch.models import get_model as tget
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-4, rtol=1e-3)
MESHES = {"m21": (2, 1), "m12": (1, 2), "m22": (2, 2)}
FAMILIES = ("deepseek_moe_16b", "zamba2_1_2b", "seamless_m4t_large_v2")


def _finish(procs, timeout: float) -> list:
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            out.append((p.returncode, text or ""))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's steps and block indices, then the port's ranks: two
    at (2, 1) and four at (2, 2), all at once."""
    d = tmp_path_factory.mktemp("placement")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_jax_placed_steps.py"),
         str(d / "ref.npz"), "2"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    script = str(ROOT / "tests" / "_torch_place_worker.py")
    procs = []
    for n in (2, 4):
        (d / f"w{n}").mkdir()
        procs += worker.launch_ranks(
            n, [script, str(d / "ref.npz"), str(d / f"w{n}")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = _finish(procs, 300)
    for rc, text in logs:
        assert rc == 0, text
    ranks = {}
    for n, tag in ((2, "m21"), (4, "m22")):
        ranks[tag] = [dict(npz=np.load(d / f"w{n}" / f"rank{r}.npz"),
                           facts=json.loads((d / f"w{n}" /
                                             f"rank{r}.json").read_text()))
                      for r in range(n)]
    return dict(ref=np.load(d / "ref.npz"), ranks=ranks, dir=d,
                logs=[text for _, text in logs])


def _smoke():
    cfg = treg.with_sell(treg.get_smoke_config("qwen3_1_7b"), "acdc",
                         method="pallas")
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="adamw"),
                              tsched.constant_schedule(1e-3))
    return cfg, tget(cfg), opt


@functools.lru_cache(maxsize=None)
def _full_like(arch: str) -> dict:
    """The full-width train state of ``arch`` (``acdc``) on ``meta``."""
    cfg = treg.with_sell(treg.get_config(arch), "acdc", method="pallas")
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="adamw"),
                              tsched.constant_schedule(1e-3))
    return tsteps.abstract_state(tget(cfg), cfg, opt)


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", treg.ARCHS)
def test_blocks_match_reference_index(runs, arch, tag):
    like = _full_like(arch)
    sizes = dict(zip(("data", "model"), MESHES[tag]))
    paths, specs = topt.tree_flatten(tshard.param_specs(like, sizes))
    shapes = dict(zip(*topt.tree_flatten(like)))
    want = json.loads(str(runs["ref"][f"index/{tag}/{arch}"]))
    assert sorted(paths) == sorted(want)
    for path, spec in zip(paths, specs):
        shape = tuple(getattr(shapes[path], "shape", ()))
        for where, index in want[path].items():
            d, m = map(int, where.split("_"))
            got = tshard.shard_slices(shape, spec, sizes,
                                      {"data": d, "model": m})
            assert [[s.start, s.stop] for s in got] == index, (path, where)
            assert tshard.local_shape(shape, spec, sizes) == tuple(
                b - a for a, b in index)


@pytest.mark.parametrize("tag", ["m21", "m22"])
def test_placed_steps_match_reference_shard_for_shard(runs, tag):
    ref = runs["ref"]
    for rank in runs["ranks"][tag]:
        d, m = rank["facts"]["coord"]
        got = {k[len("parity/"):]: rank["npz"][k] for k in rank["npz"].files
               if k.startswith("parity/")}
        assert got, "no blocks"
        for path, block in got.items():
            want = ref[f"{tag}/{d}_{m}/{path}"]
            assert block.shape == want.shape, (path, block.shape)
            np.testing.assert_allclose(block, want, err_msg=path, **F32)
        for k in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(rank["facts"]["parity_metrics"][k],
                                       ref[f"{tag}/{k}"], err_msg=k, **F32)


@pytest.mark.parametrize("tag", ["m21", "m22"])
def test_each_rank_holds_only_its_blocks(runs, tag):
    cfg, model, opt = _smoke()
    like = tsteps.abstract_state(model, cfg, opt)
    full = sum(t.numel() for t in topt.tree_flatten(
        {k: like[k] for k in ("params", "opt")})[1])
    for rank in runs["ranks"][tag]:
        f = rank["facts"]
        assert f["local_numel"] == f["reckoned_numel"] < full


def test_gather_backward_sums_over_data(runs):
    assert all(r["facts"]["gather_data"] == 0.0
               for r in runs["ranks"]["m21"])


def test_gather_backward_slices_over_model(runs):
    assert all(r["facts"]["gather_model"] == 0.0
               for r in runs["ranks"]["m21"])


def test_gather_backward_over_both_axes(runs):
    assert all(r["facts"]["gather_both"] == 0.0
               for r in runs["ranks"]["m22"])


@pytest.mark.parametrize("tag", ["m21", "m22"])
def test_mesh_wide_norm_and_clip_equal_unplaced(runs, tag):
    for rank in runs["ranks"][tag]:
        got, want = rank["facts"]["norm"]
        np.testing.assert_allclose(got, want, **F32)
        assert rank["facts"]["clip_max_err"] <= F32["atol"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_family_steps_match_replicated(runs, arch):
    for rank in runs["ranks"]["m21"]:
        mets = rank["facts"][f"family/{arch}"]
        for a, b in zip(mets["placed"], mets["replicated"]):
            for k in ("loss", "grad_norm", "update_norm"):
                np.testing.assert_allclose(a[k], b[k], err_msg=k, **F32)
        npz = rank["npz"]
        pre = f"family/{arch}/placed/"
        placed = [k for k in npz.files if k.startswith(pre)]
        assert placed
        for k in placed:
            want = npz[k.replace("/placed/", "/replicated/")]
            assert npz[k].shape == want.shape, k
            np.testing.assert_allclose(npz[k], want, err_msg=k, **F32)


def test_remat_gathers_inside_the_checkpointed_layer(runs):
    for rank in runs["ranks"]["m21"]:
        remat = rank["facts"]["saved/remat=True"]
        plain = rank["facts"]["saved/remat=False"]
        assert remat["gathered"] > 0 and remat["gathered_only_shapes"] > 0
        assert remat["alive"] == 0 and remat["saved_gathered_shapes"] == []
        # without remat the products keep the gathered layers: the check
        # sees them
        assert plain["alive"] > 0 and plain["saved_gathered_shapes"]


def test_checkpoint_restores_at_another_mesh(runs):
    ranks = runs["ranks"]["m21"]
    assert all(r["facts"]["ckpt"]["restored_equal"] for r in ranks)
    cfg, model, opt = _smoke()
    ckpt = CheckpointManager(str(runs["dir"] / "w2" / "ckpt21"))
    like = tsteps.abstract_state(model, cfg, opt)
    full = ckpt.restore(ckpt.latest_step(), like, device="cpu")
    paths, leaves = topt.tree_flatten({k: full[k]
                                       for k in ("params", "opt")})
    specs = dict(zip(*topt.tree_flatten(tshard.param_specs(
        {k: like[k] for k in ("params", "opt")}, {"data": 2, "model": 1}))))
    for rank in ranks:
        d, m = rank["facts"]["coord"]
        for path, leaf in zip(paths, leaves):
            index = tshard.shard_slices(leaf.shape, specs[path],
                                        {"data": 2, "model": 1},
                                        {"data": d, "model": m})
            assert np.array_equal(rank["npz"][f"ckpt/{path}"],
                                  leaf[index].numpy()), path


def test_compressed_placed_equals_unplaced_bitwise(runs):
    for rank in runs["ranks"]["m21"]:
        facts = rank["facts"]["compress"]
        assert facts["placed"] == facts["replicated"]
        npz = rank["npz"]
        placed = [k for k in npz.files if k.startswith("compress/placed/")]
        assert any("/grad_error/" in k for k in placed)
        for k in placed:
            assert np.array_equal(
                npz[k], npz[k.replace("/placed/", "/replicated/")]), k


def test_compress_with_a_model_axis_is_refused():
    cfg, model, opt = _smoke()
    with pytest.raises(ValueError, match="model axis must be 1"):
        tsteps.make_train_step(model, cfg, opt, compress=True,
                               mesh={"data": 2, "model": 2})


def test_launcher_model_parallel_trains_and_checkpoints(runs):
    d = runs["dir"] / "w4"
    losses = [json.loads((d / f"launcher{r}.json").read_text())
              for r in range(4)]
    assert len(losses[0]) == 3 and all(l == losses[0] for l in losses)
    assert all(np.isfinite(losses[0]))
    text = "".join(runs["logs"])
    assert "[elastic] resolved mesh data=2 model=2 from 4 devices" in text
    assert text.count("of mesh (2, 2)") == 4
    cfg, model, opt = _smoke()
    like = tsteps.abstract_state(model, cfg, opt)
    ckpt = CheckpointManager(str(d / "ckpt22"))
    assert ckpt.all_steps() == [2, 3]
    full = ckpt.restore(3, like, device="cpu")
    for a, b in zip(topt.tree_flatten(full)[1], topt.tree_flatten(like)[1]):
        if isinstance(b, torch.Tensor):
            assert a.shape == b.shape
