"""Port parity, tensor-parallel compute in the placed decode step of every
family (``make_serve_step(mesh=)`` reading the model-local view,
``dist/sharding.py``'s ``TensorSplit``): query and KV heads, ffn
columns, experts, SSM heads and the vocabulary on their "model" blocks,
``wo``'s, ``wd``'s and ``out_proj``'s rows reduced over "model" where
the heads' outputs were gathered before a whole ``wo``.

Four gloo ranks (``_torch_headsplit_worker.py``) against the reference's
steps jitted with ``param_shardings`` / ``cache_specs`` / ``data_specs``
on forced host devices (``_jax_headsplit_ref.py``: its ``decode_step``
jitted the same way gives each step's logits), on the same numpy-seeded
weights (``bridge``), prompts and first tokens, in fp32.  Each case is a
``full_logits`` prefill of ragged 8-token prompts on a (4, 16) cache,
then 3 greedy decode steps:

* at (1, 4): smoke Gemma3-27B (4 KV heads split 4 ways), ChatGLM3-6B
  (the queries split, its 2 KV heads whole on every rank), Moonshot and
  DeepSeekMoE (experts over "model", capacity drops), Mamba2 and Zamba2
  (SSM heads; the conv window whole on every rank), Seamless-M4T (self-
  and cross-attention heads, the GeGLU ffn, the vocabulary) and Qwen3 on
  ``acdc`` / ``pallas`` (interpret mode in the reference, the plain
  versions here: its SELL ``wo`` gathers the heads);
* heads that do not divide "model", computed whole: 3 heads at (2, 2),
  6 at (1, 4);
* Seamless-M4T with a vocabulary of 514, which splits 2 ways and not 4,
  at (2, 2) and (1, 4).

Held: every decode step's logits at fp32 atol 2e-4 / rtol 1e-3
(tests/test_kernel_grads.py:248), the next tokens exactly, every rank's
final cache blocks against the slices of the reference's leaves, and
every block two ranks both hold (the conv window, KV heads replicated
over "model") bitwise equal across them.  Beside them the dry run's
reckoning (``--reckon``) of full-width Qwen3-1.7B's decode cell at
(2, 2): each leaf gathered over "data" at its "model" block, one
all-reduce a ``wo`` / ``wd`` and the embedding's.  The reference (in
four processes), the reckoning and the four ranks run at once, one
thread each.
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
from repro_torch.optim.optimizers import tree_flatten

import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_headsplit import F32, _finish, _slices

ROOT = Path(__file__).resolve().parents[1]
#: case -> (arch, mesh, sell, config overrides)
CASES = {
    "gemma3": ("gemma3_27b", "1x4", "dense", {}),
    "chatglm3": ("chatglm3_6b", "1x4", "dense", {}),
    "moonshot": ("moonshot_v1_16b_a3b", "1x4", "dense", {}),
    "deepseek_moe": ("deepseek_moe_16b", "1x4", "dense", {}),
    "mamba2": ("mamba2_1_3b", "1x4", "dense", {}),
    "zamba2": ("zamba2_1_2b", "1x4", "dense", {}),
    "seamless": ("seamless_m4t_large_v2", "1x4", "dense", {}),
    "qwen3_acdc": ("qwen3_1_7b", "1x4", "acdc", {}),
    "heads3_2x2": ("qwen3_1_7b", "2x2", "dense",
                   {"n_heads": 3, "n_kv_heads": 3}),
    "heads6_1x4": ("qwen3_1_7b", "1x4", "dense",
                   {"n_heads": 6, "n_kv_heads": 6}),
    "seamless_v514_2x2": ("seamless_m4t_large_v2", "2x2", "dense",
                          {"vocab_size": 514}),
    "seamless_v514_1x4": ("seamless_m4t_large_v2", "1x4", "dense",
                          {"vocab_size": 514}),
}
#: the reference's cases in four processes at once
REF_GROUPS = (("qwen3_acdc", "chatglm3"),
              ("zamba2", "mamba2", "heads3_2x2"),
              ("seamless", "seamless_v514_2x2", "seamless_v514_1x4"),
              ("gemma3", "moonshot", "deepseek_moe", "heads6_1x4"))
#: the dry run's cell reckoned at (2, 2): full-width Qwen3-1.7B's decode
RECKON = "qwen3_1_7b:decode:64:4:2x2"
ROWS, CACHE, PROMPT, STEPS = 4, 16, 8, 3


def _config(case: str):
    arch, _, sell, over = CASES[case]
    cfg = treg.get_smoke_config(arch)
    if sell == "acdc":
        cfg = treg.with_sell(cfg, "acdc", method="pallas")
    return dataclasses.replace(cfg, **over)


def _draw_inputs(path: Path) -> None:
    rng = np.random.default_rng(3)
    arrays = {"sampled": np.array(False)}
    for i, (case, (arch, mesh, sell, over)) in enumerate(CASES.items()):
        cfg = _config(case)
        params = tget(cfg).init(torch.Generator().manual_seed(i), cfg, "cpu")
        pre = f"{case}/"
        arrays.update({f"{pre}params/{k}": v
                       for k, v in bridge.to_numpy(params).items()})
        arrays[pre + "arch"] = np.array(arch)
        arrays[pre + "mesh"] = np.array(mesh)
        arrays[pre + "sell"] = np.array(sell)
        if over:
            arrays[pre + "overrides"] = np.array(json.dumps(over))
        arrays[pre + "decode_logits"] = np.array(True)
        arrays[pre + "cache_len"] = np.array(CACHE)
        arrays[pre + "steps"] = np.array(STEPS)
        arrays[pre + "tokens"] = rng.integers(
            0, cfg.vocab_size, (ROWS, PROMPT)).astype(np.int32)
        arrays[pre + "lengths"] = np.array([8, 5, 8, 3], np.int32)
        arrays[pre + "first"] = rng.integers(
            0, cfg.vocab_size, (ROWS,)).astype(np.int32)
        if cfg.family == "encdec":
            arrays[pre + "frames"] = rng.standard_normal(
                (ROWS, cfg.n_frontend_tokens, cfg.d_model)).astype(
                    np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference, the reckoning and four gloo ranks, at once, on the
    inputs drawn here."""
    d = tmp_path_factory.mktemp("tensor_parallel_decode")
    _draw_inputs(d / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_headsplit_ref.py"),
         str(d / "in.npz"), str(d / f"ref{i}.npz"), ",".join(group)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i, group in enumerate(REF_GROUPS)]
    reckoning = tdry.start_reckoning([RECKON], "dense", d / "reckon.json")
    (d / "w").mkdir()
    procs += worker.launch_ranks(
        4, [str(ROOT / "tests" / "_torch_headsplit_worker.py"),
            str(d / "in.npz"), str(d / "w")],
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


def test_reference_groups_cover_the_cases():
    assert sorted(c for g in REF_GROUPS for c in g) == sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_prefill_matches_reference(runs, case):
    ref, pre = runs["ref"], f"{case}/"
    for rank in runs["ranks"]:
        a, b = rank["facts"][case]["rows"]
        np.testing.assert_allclose(rank["npz"][pre + "logits"],
                                   ref[pre + "logits"][a:b], **F32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_decode_logits_match_reference(runs, case):
    """Every decode step's logits, whole over the vocabulary, of each
    rank's rows: what its sampler draws from."""
    ref, pre = runs["ref"], f"{case}/"
    vocab = _config(case).vocab_size
    for rank in runs["ranks"]:
        a, b = rank["facts"][case]["rows"]
        got = rank["npz"][pre + "decode_logits"]
        assert got.shape == (STEPS, b - a, vocab)
        np.testing.assert_allclose(got, ref[pre + "decode_logits"][:, a:b],
                                   **F32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_decode_tokens_match_reference(runs, case):
    want = runs["ref"][f"{case}/next"].tolist()
    for rank in runs["ranks"]:
        assert rank["facts"][case]["next"] == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_decode_blocks_match_reference(runs, case):
    ref, pre = runs["ref"], f"{case}/"
    for rank in runs["ranks"]:
        for leaf, index in rank["facts"][case]["final_slices"].items():
            got = rank["npz"][f"{pre}final/{leaf}"]
            if leaf == "xlen":      # the port's frame count: every frame
                assert (got == ref[f"{pre}final/xk"].shape[2]).all()
                continue
            want = ref[f"{pre}final/{leaf}"][_slices(index)]
            assert got.shape == want.shape, leaf
            np.testing.assert_allclose(got, want, err_msg=leaf, **F32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_decode_shared_blocks_are_bitwise_equal(runs, case):
    """Ranks that hold the same block of a leaf (its rows, every model
    rank of them where it does not split over "model": the conv window,
    KV heads that do not divide "model", the cross frame count) hold it
    bitwise equal: each model rank wrote the same values."""
    pre = f"{case}/"
    shared = 0
    for leaf in runs["ranks"][0]["facts"][case]["final_slices"]:
        by_block: dict = {}
        for rank in runs["ranks"]:
            key = json.dumps(rank["facts"][case]["final_slices"][leaf])
            by_block.setdefault(key, []).append(
                rank["npz"][f"{pre}final/{leaf}"])
        for blocks in by_block.values():
            for other in blocks[1:]:
                assert np.array_equal(other, blocks[0]), leaf
                shared += 1
    cfg = _config(case)
    if cfg.family in ("ssm", "hybrid") or cfg.n_kv_heads % 4:
        assert shared > 0       # the conv window or replicated KV heads


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_decode_cache_splits_as_the_heads(runs, case):
    """The cache's heads split over "model" where the KV (SSM) heads
    divide it, which is where the weights' heads split too: 4 KV heads
    over 4 ranks, ChatGLM3's 2 whole, 3 and 6 heads whole at (2, 2) and
    (1, 4)."""
    cfg = _config(case)
    model = int(CASES[case][1].split("x")[1])
    leaf, heads, dim = {
        "decoder": ("k", cfg.n_kv_heads, 3),
        "encdec": ("xk", cfg.n_kv_heads, 3),
        "ssm": ("ssm", cfg.d_inner_ // cfg.ssm_head_dim, 2),
        "hybrid": ("attn_k", cfg.n_kv_heads, 3)}[cfg.family]
    for rank in runs["ranks"]:
        specs = rank["facts"][case]["specs"]
        want = "model" if heads % model == 0 else None
        assert specs[leaf][dim] == want, specs
        if cfg.family in ("ssm", "hybrid"):
            assert "model" not in specs["conv"], specs


def _gathered_bytes(cfg, mesh: dict) -> tuple:
    """(bytes, count) of the all-gathers of every weight leaf split over
    any axis, each gathered over "data" at its "model" block: the block
    of its spec without "data"."""
    like = tget(cfg).init(torch.Generator(), cfg, "meta")
    total = count = 0
    for path, t in zip(*tree_flatten(like)):
        spec = tsh.spec_for(mesh, t.shape,
                            tsh.logical_axes_for(f"params/{path}", t.dim()))
        if not any(tsh._axes(e) for e in spec):
            continue
        assert "model" in tsh._axes(spec[-1]) + tsh._axes(spec[-2]), path
        total += math.prod(tsh.local_shape(
            t.shape, tsh.without(spec, "data"), mesh)) * t.element_size()
        count += t.shape[0] if path.startswith("layers/") else 1
    return total, count


def test_reckoned_qwen3_decode_gathers_model_blocks(runs):
    """Full-width Qwen3-1.7B's decode cell at (2, 2), reckoned on meta:
    every weight leaf is gathered over "data" at its "model" block (half
    of it), never whole, then the logits' vocabulary blocks of the rank's
    rows and the next tokens; the all-reduces are one a ``wo`` and a
    ``wd`` and the embedding's, each a bf16 (rows, d_model) activation,
    where the heads' outputs were gathered before a whole ``wo``."""
    rec = runs["reckoned"][RECKON]
    assert rec["status"] == "ok", rec
    arch, cell, shape, _ = tdry.parse_reckon(RECKON)
    cfg = treg.get_config(arch)
    mesh = dict(zip(("data", "model"), shape))
    rows = cell.global_batch // mesh["data"]
    weights, n_leaves = _gathered_bytes(cfg, mesh)
    coll = rec["collectives"]
    assert coll["count"]["all-gather"] == n_leaves + 2
    assert coll["bytes"]["all-gather"] == (weights + rows * cfg.vocab_size * 4
                                           + cell.global_batch * 4)
    act = torch.empty((), dtype=cfg.compute_dtype).element_size()
    assert coll["count"]["all-reduce"] == 2 * cfg.n_layers + 1
    assert coll["bytes"]["all-reduce"] == ((2 * cfg.n_layers + 1) * rows
                                           * cfg.d_model * act)
