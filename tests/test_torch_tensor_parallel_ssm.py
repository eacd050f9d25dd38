"""Port parity, tensor-parallel compute in the placed train and prefill
steps of the ssm family (Mamba2) and the hybrid family (Zamba2)
(``dist/sharding.py``'s ``TensorSplit``: SSM heads, ``out_proj`` rows, the
shared block's heads and ffn columns, the vocabulary).

Four gloo ranks (``_torch_tp_worker.py``) against the reference's steps
jitted with ``param_shardings`` / ``data_specs`` on forced host devices
(``_jax_tp_ref.py``), on the same numpy-seeded weights (``bridge``),
batches and prompts, in fp32:

* two train steps at (data 2, model 2) and (1, 4) of smoke Mamba2-1.3B
  and Zamba2-1.2B, with ``dense`` projections (``out_proj`` on its rows,
  ``in_proj`` whole and cut to this rank's heads' columns) and with
  ``acdc`` on ``pallas`` (the SELL ``in_proj`` / ``out_proj`` whole, the
  SSD on the heads between them): the metrics, and each rank's blocks of
  the updated params.  The updated blocks are what hold the gradient
  rules: every leaf a rank reads in part (``in_proj``'s columns,
  ``conv_w``, ``conv_b``, ``dt_bias``, ``a_log``, ``d_skip``, the inner
  norm's ``scale``) must get its gradient summed over "model", and the
  inner norm's mean over all ``d_inner`` channels its gradient summed
  back;
* a ``full_logits`` prefill at (2, 2) of the same four: each rank's rows
  of the logits (its vocabulary block, gathered over "model") and its
  blocks of the new ``ssm`` (heads over "model"), ``conv`` (every
  channel) and, for Zamba2, ``attn_k`` / ``attn_v`` cache;
* the divisibility fallback: smoke Mamba2 with ``d_inner`` 192 (6 SSM
  heads, which do not divide 4) at (1, 4), its mamba layers whole;
* the structure: a placed step of smoke Mamba2 at (1, 4) gathers the
  embedding and every ``out_proj`` at its "model" block and every
  ``in_proj`` whole (the dry run's ``Collectives``);
* the dry run's reckoning (``--reckon``) of a full-width Zamba2 prefill
  cell at (2, 2): its output bytes are the logits' block by
  ``spec_for(..., ("batch", None, "vocab"))`` plus the cache's blocks by
  ``cache_specs`` (the logits were whole over "model" before).

Held at fp32 atol 2e-4 / rtol 1e-3 (tests/test_kernel_grads.py:248).  The
reference (in four processes), the reckoning and the four ranks run at
once, one thread each (~60 s).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.models import get_model as tget

import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_tensor_parallel import F32, _finish, _held_train, _labels

ROOT = Path(__file__).resolve().parents[1]
MAIN = "2x2,1x4"
#: case -> (arch, sell, meshes, prefill at (2, 2), config overrides)
CASES = {
    "mamba2_dense": ("mamba2_1_3b", "dense", MAIN, True, {}),
    "mamba2_acdc": ("mamba2_1_3b", "acdc", MAIN, True, {}),
    "zamba2_dense": ("zamba2_1_2b", "dense", MAIN, True, {}),
    "zamba2_acdc": ("zamba2_1_2b", "acdc", MAIN, True, {}),
    "mamba2_whole": ("mamba2_1_3b", "dense", "1x4", False,
                     {"d_inner": 192}),
}
TP_CASES = [c for c, v in CASES.items() if v[2] == MAIN]
#: the reference's cases in four processes at once (its jit compiles
#: set the fixture's time: Zamba2 on ``pallas`` in interpret mode ~40 s)
REF_GROUPS = (("zamba2_acdc",), ("zamba2_dense",), ("mamba2_acdc",),
              ("mamba2_dense", "mamba2_whole"))
#: the dry run's cell reckoned at (2, 2): full-width Zamba2's prefill
RECKON = "zamba2_1_2b:prefill:64:4:2x2"
ROWS, SEQ, STEPS = 4, 16, 2


def _draw_inputs(path: Path) -> None:
    rng = np.random.default_rng(1)
    arrays = {"structure/arch": np.array("mamba2_1_3b")}
    for i, (case, (arch, sell, meshes, pre, over)) in enumerate(
            CASES.items()):
        cfg = treg.get_smoke_config(arch)
        if sell == "acdc":
            cfg = treg.with_sell(cfg, "acdc", method="pallas")
        cfg = dataclasses.replace(cfg, **over)
        params = tget(cfg).init(torch.Generator().manual_seed(i), cfg, "cpu")
        p = f"{case}/"
        arrays.update({f"{p}params/{k}": v
                       for k, v in bridge.to_numpy(params).items()})
        arrays[p + "arch"] = np.array(arch)
        arrays[p + "sell"] = np.array(sell)
        arrays[p + "capacity_factor"] = np.array(cfg.capacity_factor)
        arrays[p + "meshes"] = np.array(meshes)
        arrays[p + "accum"] = np.array(1)
        if over:
            arrays[p + "overrides"] = np.array(json.dumps(over))
        for s in range(STEPS):
            tokens = rng.integers(0, cfg.vocab_size,
                                  (ROWS, SEQ)).astype(np.int32)
            arrays[f"{p}batch{s}/tokens"] = tokens
            arrays[f"{p}batch{s}/labels"] = _labels(tokens, 0)
        if pre:
            arrays[p + "prefill/tokens"] = rng.integers(
                0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
            arrays[p + "prefill/lengths"] = np.array([16, 11, 16, 13],
                                                     np.int32)
            arrays[p + "prefill/cache_len"] = np.array(24)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference, the reckoning and four gloo ranks, at once, on the
    inputs drawn here."""
    d = tmp_path_factory.mktemp("tensor_parallel_ssm")
    _draw_inputs(d / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_tp_ref.py"),
         str(d / "in.npz"), str(d / f"ref{i}.npz"), ",".join(group)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i, group in enumerate(REF_GROUPS)]
    reckoning = tdry.start_reckoning([RECKON], "dense", d / "reckon.json")
    (d / "w").mkdir()
    procs += worker.launch_ranks(
        4, [str(ROOT / "tests" / "_torch_tp_worker.py"), str(d / "in.npz"),
            str(d / "w")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for rc, text in _finish(procs, 600):
        assert rc == 0, text[-6000:]
    reckoned = tdry.reckoned(reckoning, d / "reckon.json", timeout=300)
    ranks = [dict(npz=np.load(d / "w" / f"rank{r}.npz"),
                  facts=json.loads((d / "w" / f"rank{r}.json").read_text()))
             for r in range(4)]
    ref = {}
    for i in range(len(REF_GROUPS)):
        with np.load(d / f"ref{i}.npz") as part:
            ref.update({k: part[k] for k in part.files})
    return dict(ref=ref, ranks=ranks, reckoned=reckoned)


@pytest.mark.parametrize("tag", ["2x2", "1x4"])
@pytest.mark.parametrize("case", TP_CASES)
def test_ssm_tensor_parallel_train_matches_reference(runs, case, tag):
    _held_train(runs, case, tag)


def test_ssm_heads_that_do_not_divide_model_compute_whole(runs):
    """6 SSM heads over 4 model ranks: the mamba layers compute every
    head (``out_proj`` gathered whole), as the reference's divisibility
    fallback does; the vocabulary still splits."""
    _held_train(runs, "mamba2_whole", "1x4")


@pytest.mark.parametrize("case", TP_CASES)
def test_ssm_tensor_parallel_prefill_matches_reference(runs, case):
    ref, pre = runs["ref"], f"{case}/prefill/"
    vocab = treg.get_smoke_config(CASES[case][0]).vocab_size
    leaves = ({"ssm", "conv", "attn_k", "attn_v"}
              if CASES[case][0] == "zamba2_1_2b" else {"ssm", "conv"})
    for rank in runs["ranks"]:
        assert f"{case}/prefill" not in rank["facts"]["errors"], \
            rank["facts"]["errors"][f"{case}/prefill"]
        facts = rank["facts"][f"{case}/prefill"]
        assert facts["vocab_block"] == vocab // 2   # the rank's block
        a, b = facts["rows"]
        np.testing.assert_allclose(rank["npz"][pre + "logits"],
                                   ref[pre + "logits"][a:b], **F32)
        assert set(facts["slices"]) == leaves
        for leaf, index in facts["slices"].items():
            want = ref[f"{pre}cache/{leaf}"][tuple(slice(x, y)
                                                   for x, y in index)]
            got = rank["npz"][f"{pre}cache/{leaf}"]
            assert got.shape == want.shape, leaf
            np.testing.assert_allclose(got, want, err_msg=leaf, **F32)
        # the SSM state holds this rank's heads: half of them
        heads = facts["slices"]["ssm"][2]
        assert heads[1] - heads[0] == rank["npz"][pre + "cache/ssm"].shape[2]
        assert 2 * (heads[1] - heads[0]) == ref[pre + "cache/ssm"].shape[2]


def test_ssm_step_gathers_out_proj_blocks_and_in_proj_whole(runs):
    """Every all-gather of a placed smoke Mamba2 step at (1, 4): the
    embedding and each ``out_proj`` over the size-1 "data" axis at their
    "model" block (a quarter of the leaf), each ``in_proj`` over "data"
    at its block and then over "model" whole; a stacked layer's twice
    (forward and the remat's recompute).  Nothing else is gathered."""
    for rank in runs["ranks"]:
        assert "structure" not in rank["facts"]["errors"], \
            rank["facts"]["errors"]["structure"]
        facts = rank["facts"]["structure"]
        assert facts["remat"]
        want_bytes = want_count = 0
        for path, (shape, size) in facts["leaves"].items():
            name = path.split("/")
            if name[-1] == "table":
                want_bytes += math.prod(shape) * size // 4
                want_count += 1
            elif name[-2] == "out_proj":
                want_bytes += 2 * math.prod(shape) * size // 4
                want_count += 2 * shape[0]
            elif name[-2] == "in_proj":
                want_bytes += 2 * (math.prod(shape) * size // 4
                                   + math.prod(shape) * size)
                want_count += 4 * shape[0]
        coll = facts["collectives"]
        assert coll["count"]["all-gather"] == want_count
        assert coll["bytes"]["all-gather"] == want_bytes


def test_reckoned_zamba2_prefill_outputs_the_vocabulary_block(runs):
    """The dry run's full-width Zamba2 prefill at (2, 2) puts out the
    logits as the reference's prefill cell does, at ("batch", None,
    "vocab"): 32000 splits over "model", so each rank holds its rows and
    half the vocabulary, beside its blocks of the new cache."""
    rec = runs["reckoned"][RECKON]
    assert rec["status"] == "ok", rec
    arch, cell, shape, _ = tdry.parse_reckon(RECKON)
    cfg = treg.get_config(arch)
    mesh = dict(zip(("data", "model"), shape))
    b, s, v = cell.global_batch, cell.seq_len, cfg.vocab_size
    spec = tsh.spec_for(mesh, (b, s, v), ("batch", None, "vocab"))
    assert spec == ("data", None, "model")
    want = math.prod(tsh.local_shape((b, s, v), spec, mesh)) * 4
    cache = tget(cfg).init_cache(cfg, b, s, device="meta")
    specs = tsh.cache_specs(cache, mesh)
    want += sum(math.prod(tsh.local_shape(t.shape, specs[k], mesh))
                * t.element_size() for k, t in cache.items())
    assert rec["memory"]["output_size_in_bytes"] == want
