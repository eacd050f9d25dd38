"""Port parity, tensor-parallel compute in the decoder family's placed
train and prefill steps (``dist/sharding.py``'s ``TensorSplit`` and the
model-local view; ``make_train_step(mesh=)``, ``make_prefill_step(mesh=)``)
and the placed train step's whole-batch loss and MoE queues.

Four gloo ranks (``_torch_tp_worker.py``) against the reference's steps
jitted with ``param_shardings`` / ``data_specs`` on forced host devices
(``_jax_tp_ref.py``), on the same numpy-seeded weights (``bridge``),
batches and prompts, in fp32:

* two train steps at (data 2, model 2) and (1, 4) of smoke Qwen3-1.7B
  with ``dense`` projections and with ``acdc`` on ``pallas`` (the main
  path: Q/K/V, attention and the vocabulary split, the SELL ``attn_out``
  and MLP whole), Gemma3-27B (window 8, qk-norm), ChatGLM3-6B (2 KV heads:
  at model 4 every rank projects both and keeps its query group's),
  DeepSeekMoE-16B (experts over "model") and LLaVA-NeXT-34B (an 8-position
  frontend prefix, its labels masked): the metrics, and each rank's
  blocks of the updated params;
* a ``full_logits`` prefill at (2, 2) of the same configs: each rank's
  rows of the logits (its vocabulary block, gathered over "model") and
  its blocks of the new cache;
* the placed train step's repairs (each failed before them): DeepSeekMoE
  at (2, 1) and (2, 2) with a capacity factor of 0.5 (8 rows an expert
  for 128 routed slots: the queues drop tokens, so a rank's own queues
  would differ from the batch's); smoke Qwen3 at (2, 1) with label masks
  that differ between the data ranks (every batch here has them: 9
  positions masked on row 0, 3 on row 2), so a mean of the ranks' masked
  means is not the batch's, and the same in two micro-batches a step;
* the structure: a model-local step at (1, 4) gathers every dense
  projection and the embedding at its "model" block (the dry run's
  ``Collectives``: all-gather bytes of a quarter of each leaf a gather,
  twice a layer under remat), never whole.

Held at fp32 atol 2e-4 / rtol 1e-3 (tests/test_kernel_grads.py:248).  The
reference (in three processes) and the four ranks run at once, one
thread each.
"""

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
from repro_torch.models import get_model as tget

import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-4, rtol=1e-3)
MAIN = "2x2,1x4"
#: case -> (arch, sell, capacity factor, meshes, prefill at (2, 2))
CASES = {
    "qwen3_dense": ("qwen3_1_7b", "dense", 1.25, MAIN, True),
    "qwen3_acdc": ("qwen3_1_7b", "acdc", 1.25, MAIN, True),
    "gemma3": ("gemma3_27b", "dense", 1.25, MAIN, True),
    "chatglm3": ("chatglm3_6b", "dense", 1.25, MAIN, True),
    "deepseek_moe": ("deepseek_moe_16b", "dense", 1.25, MAIN, True),
    "llava": ("llava_next_34b", "dense", 1.25, MAIN, True),
    "moe_drop": ("deepseek_moe_16b", "dense", 0.5, "2x1,2x2", False),
    "ragged": ("qwen3_1_7b", "dense", 1.25, "2x1", False),
}
TP_CASES = [c for c, v in CASES.items() if v[3] == MAIN]
#: the reference's cases in three processes at once (its jit compiles
#: set the fixture's time)
REF_GROUPS = (("qwen3_acdc", "llava", "ragged"),
              ("gemma3", "chatglm3", "qwen3_dense"),
              ("deepseek_moe", "moe_drop"))
ROWS, SEQ, STEPS = 4, 16, 2


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


def _labels(tokens: np.ndarray, prefix: int) -> np.ndarray:
    """Next tokens, with the prefix masked and ragged masks: 9 positions
    of row 0, 3 of row 2."""
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[:, :prefix] = -1
    labels[0, :9] = -1
    labels[2, -3:] = -1
    return labels


def _draw_inputs(path: Path) -> None:
    rng = np.random.default_rng(0)
    arrays = {}
    for i, (case, (arch, sell, cap, meshes, pre)) in enumerate(CASES.items()):
        cfg = treg.get_smoke_config(arch)
        if sell == "acdc":
            cfg = treg.with_sell(cfg, "acdc", method="pallas")
        params = tget(cfg).init(torch.Generator().manual_seed(i), cfg, "cpu")
        p = f"{case}/"
        arrays.update({f"{p}params/{k}": v
                       for k, v in bridge.to_numpy(params).items()})
        arrays[p + "arch"] = np.array(arch)
        arrays[p + "sell"] = np.array(sell)
        arrays[p + "capacity_factor"] = np.array(cap)
        arrays[p + "meshes"] = np.array(meshes)
        arrays[p + "accum"] = np.array(2 if case == "ragged" else 1)
        prefix = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
        for s in range(STEPS):
            tokens = rng.integers(0, cfg.vocab_size,
                                  (ROWS, SEQ)).astype(np.int32)
            arrays[f"{p}batch{s}/tokens"] = tokens
            arrays[f"{p}batch{s}/labels"] = _labels(tokens, prefix)
            if prefix:
                arrays[f"{p}batch{s}/frontend_embeds"] = rng.standard_normal(
                    (ROWS, prefix, cfg.d_model)).astype(np.float32)
        if pre:
            arrays[p + "prefill/tokens"] = rng.integers(
                0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
            arrays[p + "prefill/lengths"] = np.array([16, 11, 16, 13],
                                                     np.int32)
            arrays[p + "prefill/cache_len"] = np.array(24)
            if prefix:
                arrays[p + "prefill/frontend_embeds"] = rng.standard_normal(
                    (ROWS, prefix, cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and four gloo ranks, at once, on the inputs drawn
    here."""
    d = tmp_path_factory.mktemp("tensor_parallel")
    _draw_inputs(d / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_tp_ref.py"),
         str(d / "in.npz"), str(d / f"ref{i}.npz"), ",".join(group)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i, group in enumerate(REF_GROUPS)]
    (d / "w").mkdir()
    procs += worker.launch_ranks(
        4, [str(ROOT / "tests" / "_torch_tp_worker.py"), str(d / "in.npz"),
            str(d / "w")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for rc, text in _finish(procs, 600):
        assert rc == 0, text[-6000:]
    ranks = [dict(npz=np.load(d / "w" / f"rank{r}.npz"),
                  facts=json.loads((d / "w" / f"rank{r}.json").read_text()))
             for r in range(4)]
    ref = {}
    for i in range(len(REF_GROUPS)):
        with np.load(d / f"ref{i}.npz") as part:
            ref.update({k: part[k] for k in part.files})
    return dict(ref=ref, ranks=ranks)


def _held_train(runs, case: str, tag: str, run: str = "") -> None:
    """The port's steps ``<case>/<tag>[/<run>]`` against the reference's
    ``<case>/<tag>`` (one jitted step of the whole batch)."""
    ref, pre = runs["ref"], f"{case}/{tag}/"
    key = f"{case}/{tag}" + (f"/{run}" if run else "")
    n = math.prod(int(x) for x in tag.split("x"))
    for rank in runs["ranks"][:n]:
        assert key not in rank["facts"]["errors"], \
            rank["facts"]["errors"][key]
        facts = rank["facts"][key]
        for k, got in facts["metrics"].items():
            np.testing.assert_allclose(got, ref[pre + k], err_msg=k, **F32)
        d, m = facts["coord"]
        got = {k[len(key) + 1:]: rank["npz"][k] for k in rank["npz"].files
               if k.startswith(key + "/") and "/accum" not in k[len(key):]}
        assert got
        for path, block in got.items():
            want = ref[f"{pre}{d}_{m}/{path}"]
            assert block.shape == want.shape, (path, block.shape)
            np.testing.assert_allclose(block, want, err_msg=path, **F32)


@pytest.mark.parametrize("tag", ["2x2", "1x4"])
@pytest.mark.parametrize("case", TP_CASES)
def test_tensor_parallel_train_matches_reference(runs, case, tag):
    _held_train(runs, case, tag)


@pytest.mark.parametrize("case", TP_CASES)
def test_tensor_parallel_prefill_matches_reference(runs, case):
    ref, pre = runs["ref"], f"{case}/prefill/"
    vocab = treg.get_smoke_config(CASES[case][0]).vocab_size
    for rank in runs["ranks"]:
        assert f"{case}/prefill" not in rank["facts"]["errors"], \
            rank["facts"]["errors"][f"{case}/prefill"]
        facts = rank["facts"][f"{case}/prefill"]
        assert facts["vocab_block"] == vocab // 2   # the rank's block
        a, b = facts["rows"]
        np.testing.assert_allclose(rank["npz"][pre + "logits"],
                                   ref[pre + "logits"][a:b], **F32)
        for leaf, index in facts["slices"].items():
            want = ref[f"{pre}cache/{leaf}"][tuple(slice(x, y)
                                                   for x, y in index)]
            got = rank["npz"][f"{pre}cache/{leaf}"]
            assert got.shape == want.shape, leaf
            np.testing.assert_allclose(got, want, err_msg=leaf, **F32)


@pytest.mark.parametrize("tag", ["2x1", "2x2"])
def test_placed_moe_train_queues_the_whole_batch(runs, tag):
    _held_train(runs, "moe_drop", tag)


def test_placed_loss_is_the_whole_batch_masked_mean(runs):
    _held_train(runs, "ragged", "2x1")


def test_placed_accumulation_keeps_the_whole_batch_mean(runs):
    """Two micro-batches a step (one row a rank each, unequal masks) sum
    their numerators and counts: the step is the reference's step of the
    whole batch."""
    _held_train(runs, "ragged", "2x1", "accum2")


def test_model_local_step_gathers_model_blocks(runs):
    """Every all-gather of a placed step at (1, 4) is a leaf's gather over
    the size-1 "data" axis at its model-local size: a dense projection
    and the embedding a quarter of the leaf, a stacked layer's twice
    (forward and the remat's recompute); the norms are not gathered."""
    for rank in runs["ranks"]:
        assert "structure" not in rank["facts"]["errors"], \
            rank["facts"]["errors"]["structure"]
        facts = rank["facts"]["structure"]
        assert facts["remat"]
        want_bytes = want_count = 0
        for path, (shape, size) in facts["leaves"].items():
            if path.split("/")[-1] not in ("w", "table"):
                continue
            stacked = path.startswith("layers/")
            times = 2 * shape[0] if stacked else 1
            want_bytes += times * math.prod(shape) // (
                shape[0] if stacked else 1) * size // 4
            want_count += times
        coll = facts["collectives"]
        assert coll["count"]["all-gather"] == want_count
        assert coll["bytes"]["all-gather"] == want_bytes
