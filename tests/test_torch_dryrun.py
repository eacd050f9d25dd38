"""Port parity, the dry run and placed serving (``configs/registry.py``'s
shape cells, ``launch/mesh.py``'s production mesh and fake group,
``launch/dryrun.py``, the pod axis of ``make_train_step(mesh=)``,
``make_prefill_step`` / ``make_serve_step`` with ``mesh=``, the cache
placed at rest).

* **Cells.** ``SHAPES``, ``get_shape``, ``skips``, ``cells``,
  ``LONG_CONTEXT_OK`` equal the reference's; ``input_specs`` gives the
  reference's keys, shapes and dtypes for the ten configs x four shapes.
* **Bytes at rest.** For the ten full configs on the production meshes
  (16, 16) and (2, 16, 16), each rank's block shapes of params, AdamW
  moments and every serve cell's cache equal those of the reference's
  ``param_specs`` / ``cache_specs`` on a ``jax.sharding.AbstractMesh``
  over ``jax.eval_shape`` trees (shapes only).
* **The pod axis.** Smoke Qwen3-1.7B trained 3 steps on four gloo ranks
  at (pod 2, data 2, model 1) (``_torch_dryrun_worker.py``) against the
  reference's step jitted with ``param_shardings`` at the same mesh on
  four forced host devices (``_jax_dryrun_ref.py``): per-step losses and
  every rank's final blocks, at fp32 atol 2e-4 / rtol 1e-3
  (tests/test_kernel_grads.py:248).
* **Placed serving.** ``make_prefill_step(full_logits=True, mesh=)`` and 3
  greedy ``make_serve_step(mesh=)`` steps, smoke Qwen3-1.7B at (4, 1) and
  smoke DeepSeek-67B (one KV head) at (2, 2): each rank's logits rows and
  cache blocks against the reference's unplaced steps on the same params,
  the streams exactly; a decode on a placement no step reads (the batch
  of a leaf over "model", made by hand) raises and names the leaf.
* **The dry run** (``_torch_dryrun_fake.py``, two processes with their own
  fake groups): every
  arch x shape at SMOKE width on small shape cells over (2, 2) and
  (2, 2, 2) with the statuses the reference's ``skips`` predicts (every
  other cell ``ok``, decode on caches split over heads and sequence
  included); the cells run for real on the gloo ranks count
  the same collectives, bytes, argument and output bytes and FLOPs; the
  full-width Qwen3-1.7B ``train_4k`` cell on the single-pod mesh runs.

Inputs are drawn from seeds (numpy for the batches and prompts); the
reference, the two fake dry runs and the four ranks run at once.
"""

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.dist import sharding as rshard
from repro.dist import steps as rsteps
from repro.models import get_model as rget
from repro.optim import optimizers as ropt
from repro.optim import schedules as rsched
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as tshard
from repro_torch.dist import steps as tsteps
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.models import get_model as tget
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

import _torch_dist_worker as worker
import _torch_dryrun_fake as fake
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-4, rtol=1e-3)
SERVED = {"qwen3_1_7b": (4, 1), "deepseek_67b": (2, 2)}
PRODUCTION = {"pod16x16": ((16, 16), ("data", "model")),
              "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


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


def _draw_inputs(path: Path) -> None:
    rng = np.random.default_rng(0)
    arrays = {}
    cfg = treg.get_smoke_config("qwen3_1_7b")
    params = tget(cfg).init(torch.Generator().manual_seed(0), cfg, "cpu")
    arrays.update({f"train/params/{k}": v
                   for k, v in bridge.to_numpy(params).items()})
    for s in range(3):
        seq = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
        arrays[f"train/batch{s}/tokens"] = seq[:, :-1]
        arrays[f"train/batch{s}/labels"] = seq[:, 1:]
    for i, arch in enumerate(SERVED):
        cfg = treg.get_smoke_config(arch)
        params = tget(cfg).init(torch.Generator().manual_seed(i + 1), cfg,
                                "cpu")
        pre = f"serve/{arch}/"
        arrays.update({f"{pre}params/{k}": v
                       for k, v in bridge.to_numpy(params).items()})
        arrays[pre + "tokens"] = rng.integers(
            0, cfg.vocab_size, (4, 8)).astype(np.int32)
        arrays[pre + "lengths"] = np.array([8, 5, 8, 3], np.int32)
        arrays[pre + "first"] = rng.integers(
            0, cfg.vocab_size, (4,)).astype(np.int32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference, the fake-group dry run and four gloo ranks, at
    once, on the inputs drawn here."""
    d = tmp_path_factory.mktemp("dryrun")
    _draw_inputs(d / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    pipe = dict(cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                   "_jax_dryrun_ref.py"),
                               str(d / "in.npz"), str(d / "ref.npz")],
                              **pipe)]
    for i, tags in enumerate((["m22", "m221", "full"], ["m222"])):
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_dryrun_fake.py"),
             str(d / f"fake{i}.json"), *tags], **pipe))
    (d / "w").mkdir()
    procs += worker.launch_ranks(
        4, [str(ROOT / "tests" / "_torch_dryrun_worker.py"),
            str(d / "in.npz"), str(d / "w")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for rc, text in _finish(procs, 600):
        assert rc == 0, text[-6000:]
    ranks = [dict(npz=np.load(d / "w" / f"rank{r}.npz"),
                  facts=json.loads((d / "w" / f"rank{r}.json").read_text()))
             for r in range(4)]
    fake_recs = {}
    for i in range(2):
        fake_recs.update(json.loads((d / f"fake{i}.json").read_text()))
    return dict(ref=np.load(d / "ref.npz"), ranks=ranks, fake=fake_recs)


# ---------------------------------------------------------------------------
# The shape cells.
# ---------------------------------------------------------------------------

def test_shape_cells_equal_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in treg.SHAPES] == [(s.name, s.seq_len, s.global_batch,
                                       s.kind) for s in rreg.SHAPES]
    assert treg.LONG_CONTEXT_OK == rreg.LONG_CONTEXT_OK
    assert treg.CELL_ARCHS == rreg.ARCHS
    assert sorted(treg.ARCHS) == sorted(rreg.ARCHS)
    for flag in (True, False):
        assert treg.cells(flag) == rreg.cells(flag)
    for arch in rreg.ARCHS:
        for s in rreg.SHAPES:
            assert treg.skips(arch, s.name) == rreg.skips(arch, s.name)
            assert treg.get_shape(s.name) == treg.ShapeCell(
                s.name, s.seq_len, s.global_batch, s.kind)
    with pytest.raises(KeyError):
        treg.get_shape("train_8k")


@pytest.mark.parametrize("arch", rreg.ARCHS)
def test_input_specs_equal_reference(arch):
    for shape in rreg.SHAPES:
        want = rreg.input_specs(rreg.get_config(arch), shape)
        got = treg.input_specs(treg.get_config(arch),
                               treg.get_shape(shape.name))
        wf = dict(zip(*_flat(want)))
        gf = dict(zip(*_flat(got)))
        assert sorted(wf) == sorted(gf), shape.name
        for k, w in wf.items():
            g = gf[k]
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (shape.name, k)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (shape.name,
                                                                 k)


def _flat(tree, prefix=""):
    paths, leaves = [], []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            a, b = _flat(v, p)
            paths += a
            leaves += b
        else:
            paths.append(p)
            leaves.append(v)
    return paths, leaves


# ---------------------------------------------------------------------------
# Bytes at rest on the production meshes.
# ---------------------------------------------------------------------------

def _ref_local(shape, spec, sizes) -> tuple:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, e in zip(shape, spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(d // math.prod(sizes[a] for a in axes))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str) -> dict:
    """The reference's full train state of ``arch`` (params, AdamW
    moments), shapes only."""
    opt = ropt.make_optimizer(ropt.OptimizerConfig(kind="adamw"),
                              rsched.constant_schedule(1e-3))
    cfg = rreg.get_config(arch)
    state = jax.eval_shape(lambda k: rsteps.init_state(rget(cfg), cfg, opt,
                                                       k),
                           jax.random.PRNGKey(0))
    return {k: state[k] for k in ("params", "opt")}


@functools.lru_cache(maxsize=None)
def _port_state(arch: str) -> dict:
    cfg = treg.get_config(arch)
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="adamw"),
                              tsched.constant_schedule(1e-3))
    return tsteps.abstract_state(tget(cfg), cfg, opt)


@pytest.mark.parametrize("mesh", sorted(PRODUCTION))
@pytest.mark.parametrize("arch", rreg.ARCHS)
def test_blocks_at_rest_equal_reference(arch, mesh):
    shape, names = PRODUCTION[mesh]
    amesh = jax.sharding.AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    rcfg = rreg.get_config(arch)
    rmodel = rget(rcfg)
    rstate = _ref_state(arch)
    rspecs = rshard.param_specs(rstate, amesh)
    want = {p: _ref_local(leaf.shape, spec, sizes) for p, leaf, spec in zip(
        jax.tree.leaves(ropt.tree_paths(rstate)), jax.tree.leaves(rstate),
        jax.tree.leaves(rspecs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)))}
    tcfg = treg.get_config(arch)
    like = _port_state(arch)
    placement = tshard.Placement(like, sizes)
    paths, leaves = topt.tree_flatten({k: like[k]
                                       for k in ("params", "opt")})
    got = {p: tshard.local_shape(t.shape, placement.specs[p], sizes)
           for p, t in zip(paths, leaves) if isinstance(t, torch.Tensor)}
    assert got == want
    for s in rreg.SHAPES:
        if s.kind == "train":
            continue
        rcache = jax.eval_shape(lambda: rmodel.init_cache(
            rcfg, s.global_batch, s.seq_len))
        rc = rshard.cache_specs(rcache, amesh)
        want = {k: _ref_local(v.shape, rc[k], sizes)
                for k, v in rcache.items()}
        tcache = tget(tcfg).init_cache(tcfg, s.global_batch, s.seq_len,
                                       device="meta")
        cp = tshard.CachePlacement(tcache, sizes)
        got = {k: tshard.local_shape(v.shape, cp.specs[k], sizes)
               for k, v in tcache.items() if k in want}
        assert set(tcache) - set(want) <= {"xlen"}, s.name
        assert got == want, s.name


# ---------------------------------------------------------------------------
# The pod axis and placed serving on gloo, against the reference.
# ---------------------------------------------------------------------------

def test_pod_axis_losses_match_reference(runs):
    want = runs["ref"]["train/loss"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["facts"]["train"]["losses"], want,
                                   **F32)


def test_pod_axis_blocks_match_reference(runs):
    ref = runs["ref"]
    for rank in runs["ranks"]:
        p, d, m = rank["facts"]["train"]["coord"]
        got = {k[len("train/"):]: rank["npz"][k] for k in rank["npz"].files
               if k.startswith("train/")}
        assert got
        for path, block in got.items():
            want = ref[f"train/{p}_{d}_{m}/{path}"]
            assert block.shape == want.shape, path
            np.testing.assert_allclose(block, want, err_msg=path, **F32)


def test_pod_axis_pods_agree(runs):
    """Both pods of one data coordinate end with the same blocks: the
    pods' copies do not drift apart."""
    by = {}
    for rank in runs["ranks"]:
        p, d, _ = rank["facts"]["train"]["coord"]
        by[(p, d)] = rank["npz"]
    for d in (0, 1):
        a, b = by[(0, d)], by[(1, d)]
        for k in a.files:
            if k.startswith("train/"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _slices(index) -> tuple:
    return tuple(slice(a, b) for a, b in index)


@pytest.mark.parametrize("arch", sorted(SERVED))
def test_placed_prefill_matches_reference(runs, arch):
    ref, pre = runs["ref"], f"serve/{arch}/"
    for rank in runs["ranks"]:
        facts = rank["facts"][pre.rstrip("/")]
        a, b = facts["rows"]
        np.testing.assert_allclose(rank["npz"][pre + "logits"],
                                   ref[pre + "logits"][a:b], **F32)
        for leaf, index in facts["cache_slices"].items():
            want = ref[f"{pre}cache/{leaf}"][_slices(index)]
            np.testing.assert_allclose(rank["npz"][f"{pre}cache/{leaf}"],
                                       want, err_msg=leaf, **F32)


@pytest.mark.parametrize("arch", sorted(SERVED))
def test_placed_decode_matches_reference(runs, arch):
    ref, pre = runs["ref"], f"serve/{arch}/"
    for rank in runs["ranks"]:
        facts = rank["facts"][pre.rstrip("/")]
        assert facts["next"] == ref[pre + "next"].tolist()
        for leaf, index in facts["final_slices"].items():
            want = ref[f"{pre}final/{leaf}"][_slices(index)]
            np.testing.assert_allclose(rank["npz"][f"{pre}final/{leaf}"],
                                       want, err_msg=leaf, **F32)


def test_placed_serving_splits_the_cache(runs):
    """At (2, 2) each rank holds half the rows of the cache, at (4, 1) a
    quarter: the blocks, not the whole cache."""
    for rank in runs["ranks"]:
        for arch, (data, _) in SERVED.items():
            pre = f"serve/{arch}/"
            k = rank["npz"][pre + "cache/k"]
            assert k.shape[1] == 4 // data
            assert rank["facts"][pre.rstrip("/")]["rows"][1] - rank[
                "facts"][pre.rstrip("/")]["rows"][0] == 4 // data


def test_decode_on_model_split_cache_raises(runs):
    """A placement no step reads (``k``'s batch over "model", made by
    hand: the rules never split a batch over "model") still raises."""
    for rank in runs["ranks"]:
        refused = rank["facts"]["refused"]
        assert refused is not None
        assert refused["leaf"] == "k"
        assert refused["spec"] == [None, "model", None, None, None]
        assert "'k'" in refused["message"]


# ---------------------------------------------------------------------------
# The dry run.
# ---------------------------------------------------------------------------

def _predicted(arch: str, name: str, tag: str) -> str:
    """The reference's status of a cell: skipped where it skips it, else
    ok on every mesh (its decode runs on any placement ``cache_specs``
    makes, and so does the port's)."""
    del tag
    return "skipped" if rreg.skips(arch, name) else "ok"


@pytest.mark.parametrize("tag", ["m22", "m222"])
def test_dry_run_statuses_as_predicted(runs, tag):
    got = {k.split("/", 1)[1]: r for k, r in runs["fake"].items()
           if k.startswith(tag + "/")}
    for arch, name in treg.cells(include_skipped=True):
        want = _predicted(arch, name, tag)
        if want == "skipped":
            assert f"{arch}/{name}" not in got
            continue
        rec = got[f"{arch}/{name}"]
        assert rec["status"] == want, (arch, name, rec.get("error"),
                                       rec.get("trace"))
        assert rec["flops_per_device"] > 0
        assert rec["collectives"]["count"]["all-gather"] > 0


@pytest.mark.parametrize("cell", ["/".join(c) for c in fake.COMPARE])
def test_dry_run_counts_equal_real_run(runs, cell):
    want = runs["fake"][cell]
    assert want["status"] == "ok", want
    for rank in runs["ranks"]:
        got = rank["facts"]["counted"][cell]
        assert got["collectives"] == want["collectives"]
        for k in ("argument_size_in_bytes", "output_size_in_bytes"):
            assert got["memory"][k] == want["memory"][k], k
        assert got["flops_per_device"] == want["flops_per_device"]
        assert tdry.compare(got, want)["mismatches"] == []


@pytest.mark.parametrize("key", sorted(tdry.EXACT))
def test_compare_names_each_mismatch(runs, key):
    """``dryrun.compare`` holds each counter equal, and the peak within
    its limit only where one is asked."""
    want = runs["fake"]["m22/qwen3_1_7b/prefill_32k"]
    got = json.loads(json.dumps(want))
    if key == "flops":
        got["flops_per_device"] += 1
    elif key == "collectives":
        got["collectives"]["count"]["all-gather"] += 1
    else:
        got["memory"][{"arguments": "argument_size_in_bytes",
                       "outputs": "output_size_in_bytes"}[key]] += 512
    bad = tdry.compare(got, want)["mismatches"]
    assert len(bad) == 1 and bad[0].startswith(key + ":"), bad
    assert tdry.compare(got, want, exact=[k for k in tdry.EXACT
                                          if k != key])["mismatches"] == []
    peak = want["memory"]["temp_size_in_bytes"]
    near = dict(want, measured_temp_bytes=round(peak * 1.005))
    far = dict(want, measured_temp_bytes=round(peak * 1.02))
    assert tdry.compare(near, want, peak_rel=0.01)["mismatches"] == []
    assert tdry.compare(far, want, peak_rel=0.01)["mismatches"][0].startswith(
        "peak above the arguments")
    assert tdry.compare(want, dict(status="error", error="x"))["mismatches"]


def test_reckon_mode_in_subprocess(tmp_path):
    """``python -m repro_torch.launch.dryrun --reckon`` (what the chip
    scripts start beside their runs) writes each cell's record."""
    specs = ["qwen3_1_7b:prefill:16:4:2x2", "qwen3_1_7b:decode:16:4:2x2"]
    assert tdry.parse_reckon(specs[0])[1:] == (
        treg.ShapeCell("prefill_16x4", 16, 4, "prefill"), (2, 2), None)
    out = tmp_path / "reckon.json"
    recs = tdry.reckoned(tdry.start_reckoning(specs, "dense", out), out,
                         timeout=300)
    assert recs[specs[0]]["status"] == "ok", recs[specs[0]]
    assert recs[specs[0]]["collectives"]["count"]["all-gather"] > 0
    assert recs[specs[1]]["status"] == "ok", recs[specs[1]]
    assert recs[specs[1]]["collectives"]["count"]["all-gather"] > 0


def test_dry_run_argument_bytes_count_params_cache_and_inputs(runs):
    """A decode cell's argument bytes are this rank's blocks of the params
    and of the placed cache plus the replicated tokens and positions."""
    rec = runs["fake"]["m22/deepseek_67b/decode_32k"]
    sizes = {"data": 2, "model": 2}
    cfg = treg.get_smoke_config("deepseek_67b")
    model = tget(cfg)
    params = model.init(torch.Generator(), cfg, "meta")
    placement = tshard.Placement({"params": params}, sizes)
    paths, leaves = topt.tree_flatten(params)
    want = sum(math.prod(tshard.local_shape(
        t.shape, placement.specs[f"params/{p}"], sizes)) * t.element_size()
        for p, t in zip(paths, leaves))
    small = fake.SMALL["decode_32k"]
    cache = model.init_cache(cfg, small.global_batch, small.seq_len,
                             device="meta")
    cp = tshard.CachePlacement(cache, sizes)
    want += sum(math.prod(tshard.local_shape(t.shape, cp.specs[k], sizes))
                * t.element_size() for k, t in cache.items())
    want += 2 * small.global_batch * 4
    assert rec["memory"]["argument_size_in_bytes"] == want


def test_dry_run_full_width_cell(runs):
    rec = runs["fake"]["full"]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["cell"] == "qwen3_1_7b.train_4k.pod16x16"
    assert rec["n_devices"] == 256
    cfg = treg.get_config("qwen3_1_7b")
    opt = topt.make_optimizer(topt.OptimizerConfig(kind="adamw"),
                              tsched.constant_schedule(1e-3))
    sizes = {"data": 16, "model": 16}
    like = tsteps.abstract_state(tget(cfg), cfg, opt)
    placement = tshard.Placement(like, sizes)
    paths, leaves = topt.tree_flatten({k: like[k]
                                       for k in ("params", "opt")})
    at_rest = sum(math.prod(tshard.local_shape(
        t.shape, placement.specs[p], sizes)) * t.element_size()
        for p, t in zip(paths, leaves))
    batch = 2 * (256 // 16) * 4096 * 4       # tokens + labels, int32
    assert rec["memory"]["argument_size_in_bytes"] == at_rest + batch
    coll = rec["collectives"]
    assert coll["count"]["all-gather"] > 0 and coll["total_bytes"] > 0
    assert rec["flops_per_device"] > 0


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(False)
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(True)


def test_reckoned_sell_cell_does_not_depend_on_earlier_traces(tmp_path):
    """A SELL cell's reckoning (``acdc`` on ``auto``) is the same traced
    first in its process or after another: the transforms' matrices,
    cached once a process, are made in a warm-up call, as the card's
    measurement makes them before it counts (a fresh process counted
    them in its first cell's peak: Zamba2's fp32 decode cell at (1, 4)
    reckoned 258 MB above its arguments against the card's 131 MB)."""
    cell = "zamba2_1_2b:decode:16:4:1x4:float32"
    before = "mamba2_1_3b:decode:16:4:1x4:float32"
    procs = [(tdry.start_reckoning(specs, "acdc", tmp_path / f"{i}.json"),
              tmp_path / f"{i}.json")
             for i, specs in enumerate(([cell], [before, cell]))]
    alone, after = (tdry.reckoned(p, out, timeout=300)[cell]
                    for p, out in procs)
    assert alone["status"] == "ok", alone
    assert alone["memory"] == after["memory"]
    assert alone["collectives"] == after["collectives"]
