"""Port parity, tensor-parallel compute in the placed train and prefill
steps of the encoder-decoder (Seamless-M4T-large-v2;
``dist/sharding.py``'s ``TensorSplit``: the encoder's heads, the
decoder's self- and cross-attention heads, the GeGLU ffn columns, the
vocabulary where it divides).

Four gloo ranks (``_torch_tp_worker.py``) against the reference's steps
jitted with ``param_shardings`` / ``data_specs`` on forced host devices
(``_jax_tp_ref.py``), on the same numpy-seeded weights (``bridge``),
batches (8 stub frames a row) and prompts, in fp32:

* three train steps at (data 2, model 2) and (1, 4) of smoke Seamless
  with ``dense`` projections (Q/K/V and ``wg`` / ``wu`` on their
  columns, ``wo`` / ``wd`` on their rows) and with ``acdc`` on
  ``pallas`` (the SELL ``attn_out`` and MLP whole, the heads gathered
  before ``wo``): the metrics, and each rank's blocks of the updated
  params.  The encoder states feed every decoder layer's cross K/V on
  the rank's heads, so their gradient is a partial sum over "model":
  without its ``copy`` the encoder's replicated leaves (its norms) would
  differ by rank and the blocks part from the reference's;
* a ``full_logits`` prefill at (2, 2) with 12 frames: each rank's rows of
  the logits (its vocabulary block, gathered over "model") and its
  blocks of the new ``k`` / ``v`` and cross ``xk`` / ``xv`` (heads over
  "model", projected on them) and ``xlen``; then the same prompts
  prefilled without frames on a 16-slot cross cache holding them
  (``xlen`` 12 masks the rest), whose logits are the reference's too;
* the divisibility fallbacks: 6 heads (which do not divide 4) at (1, 4),
  every attention whole and the ffn and vocabulary split; a vocabulary of
  514 (2 x 257) split at (2, 2) and whole at (1, 4);
* the structure: ``Placement.view`` keeps at their "model" block exactly
  the dense ``wq`` / ``wk`` / ``wv`` / ``wo`` of ``encoder/attn``,
  ``decoder/attn`` and ``decoder/cross``, the dense ``wg`` / ``wu`` /
  ``wd`` and the table where it divides; a placed step at (1, 4) gathers
  each of them at a quarter of the leaf and nothing else (the dry run's
  ``Collectives``);
* the dry run's reckoning (``--reckon``) of a full-width Seamless prefill
  cell at (2, 2): its logits are the vocabulary block 128103, and its
  all-reduces are one a ``wo`` / ``wd`` a layer and the embedding's (the
  layers computed on their heads and ffn columns; none before).

Held at fp32 atol 2e-4 / rtol 1e-3 (tests/test_kernel_grads.py:248).  The
reference (in three processes), the reckoning and the four ranks run at
once, one thread each.
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
from repro_torch.dist import steps as tsteps
from repro_torch.launch import dryrun as tdry
from repro_torch.models import get_model as tget
from repro_torch.optim import optimizers as topt

import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_tensor_parallel import F32, _finish, _held_train, _labels

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless_m4t_large_v2"
MAIN = "2x2,1x4"
#: case -> (sell, meshes, prefill at (2, 2), config overrides)
CASES = {
    "seamless_dense": ("dense", MAIN, True, {}),
    "seamless_acdc": ("acdc", MAIN, True, {}),
    "seamless_whole": ("dense", "1x4", False,
                       {"n_heads": 6, "n_kv_heads": 6}),
    "seamless_vocab": ("dense", MAIN, True, {"vocab_size": 514}),
}
PREFILL_CASES = [c for c, v in CASES.items() if v[2]]
#: the reference's cases in three processes at once (its jit compiles
#: set the fixture's time)
REF_GROUPS = (("seamless_acdc",), ("seamless_dense",),
              ("seamless_whole", "seamless_vocab"))
#: the dry run's cell reckoned at (2, 2): full-width Seamless's prefill
RECKON = "seamless_m4t_large_v2:prefill:64:4:2x2"
ROWS, SEQ, STEPS, FRAMES, PREFILL_FRAMES = 4, 16, 3, 8, 12


def _config(case: str):
    sell, _, _, over = CASES[case]
    cfg = treg.get_smoke_config(ARCH)
    if sell == "acdc":
        cfg = treg.with_sell(cfg, "acdc", method="pallas")
    return dataclasses.replace(cfg, **over)


def _draw_inputs(path: Path) -> None:
    rng = np.random.default_rng(2)
    arrays = {"structure/arch": np.array(ARCH)}
    for i, (case, (sell, meshes, pre, over)) in enumerate(CASES.items()):
        cfg = _config(case)
        params = tget(cfg).init(torch.Generator().manual_seed(i), cfg, "cpu")
        p = f"{case}/"
        arrays.update({f"{p}params/{k}": v
                       for k, v in bridge.to_numpy(params).items()})
        arrays[p + "arch"] = np.array(ARCH)
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
            arrays[f"{p}batch{s}/frontend_embeds"] = rng.standard_normal(
                (ROWS, FRAMES, cfg.d_model)).astype(np.float32)
        if pre:
            arrays[p + "prefill/tokens"] = rng.integers(
                0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
            arrays[p + "prefill/lengths"] = np.array([16, 11, 16, 13],
                                                     np.int32)
            arrays[p + "prefill/cache_len"] = np.array(24)
            arrays[p + "prefill/frontend_embeds"] = rng.standard_normal(
                (ROWS, PREFILL_FRAMES, cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference, the reckoning and four gloo ranks, at once, on the
    inputs drawn here."""
    d = tmp_path_factory.mktemp("tensor_parallel_encdec")
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
@pytest.mark.parametrize("case", ["seamless_dense", "seamless_acdc"])
def test_encdec_tensor_parallel_train_matches_reference(runs, case, tag):
    _held_train(runs, case, tag)


def test_encdec_heads_that_do_not_divide_model_compute_whole(runs):
    """6 heads over 4 model ranks: every attention (the encoder's, the
    decoder's self and cross) computes every head, its Q/K/V/O gathered
    whole, as the reference's divisibility fallback does; the ffn and the
    vocabulary still split."""
    _held_train(runs, "seamless_whole", "1x4")


@pytest.mark.parametrize("tag", ["2x2", "1x4"])
def test_encdec_vocabulary_splits_where_it_divides(runs, tag):
    """A vocabulary of 514: on its "model" block at (2, 2), through the
    split cross-entropy; whole at (1, 4), as the reference's fallback
    keeps it (Seamless's 256206 on the production meshes)."""
    _held_train(runs, "seamless_vocab", tag)


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_encdec_tensor_parallel_prefill_matches_reference(runs, case):
    ref, pre = runs["ref"], f"{case}/prefill/"
    cfg = _config(case)
    for rank in runs["ranks"]:
        assert f"{case}/prefill" not in rank["facts"]["errors"], \
            rank["facts"]["errors"][f"{case}/prefill"]
        facts = rank["facts"][f"{case}/prefill"]
        assert facts["vocab_block"] == cfg.vocab_size // 2  # the rank's
        a, b = facts["rows"]
        np.testing.assert_allclose(rank["npz"][pre + "logits"],
                                   ref[pre + "logits"][a:b], **F32)
        # the placed prefill without frames, on them in a larger cache
        np.testing.assert_allclose(rank["npz"][pre + "noframes_logits"],
                                   ref[pre + "logits"][a:b], **F32)
        assert set(facts["slices"]) == {"k", "v", "xk", "xv", "xlen"}
        for leaf, index in facts["slices"].items():
            got = rank["npz"][f"{pre}cache/{leaf}"]
            if leaf == "xlen":      # the port's own leaf: the frames
                assert got.tolist() == [PREFILL_FRAMES] * (b - a)
                continue
            want = ref[f"{pre}cache/{leaf}"][tuple(slice(x, y)
                                                   for x, y in index)]
            assert got.shape == want.shape, leaf
            np.testing.assert_allclose(got, want, err_msg=leaf, **F32)
        # the cross K/V hold this rank's heads: half of them
        heads = facts["slices"]["xk"][3]
        assert 2 * (heads[1] - heads[0]) == cfg.n_kv_heads
        assert rank["npz"][pre + "cache/xk"].shape[3] == heads[1] - heads[0]


class _Mesh:
    """A (data, model) mesh's sizes and this rank at its origin (all
    ``TensorSplit`` reads of it)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data: int, model: int):
        self.shape = (data, model)

    def get_local_rank(self, axis: str) -> int:
        return 0


#: (case, config, mesh (data, model), the table kept, the heads kept)
VIEWS = {
    "full_16x16": ("full", (16, 16), False, True),
    "smoke_2x2": ("smoke", (2, 2), True, True),
    "acdc_1x4": ("acdc", (1, 4), True, True),
    "heads6_1x4": ("heads6", (1, 4), True, False),
    "vocab514_1x4": ("vocab514", (1, 4), False, True),
}


def _view_config(name: str):
    if name == "full":
        return treg.get_config(ARCH)
    cfg = treg.get_smoke_config(ARCH)
    if name == "acdc":
        return treg.with_sell(cfg, "acdc", method="pallas")
    if name == "heads6":
        return dataclasses.replace(cfg, n_heads=6, n_kv_heads=6)
    if name == "vocab514":
        return dataclasses.replace(cfg, vocab_size=514)
    return cfg


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_model_local_view_keeps_the_encdec_blocks(view):
    """``Placement.view``'s rule (``TensorSplit.keeps``) over every leaf
    of Seamless's params: the dense attention projections of
    ``encoder/attn``, ``decoder/attn`` and ``decoder/cross`` where the
    heads divide "model", the dense MLP, the table where the vocabulary
    divides; no norm, no SELL leaf (full width 256206 does not divide 16:
    the reference's fallback keeps the table whole)."""
    name, (data, model), table, heads = VIEWS[view]
    cfg = _view_config(name)
    like = tget(cfg).init(torch.Generator(), cfg, "meta")
    mesh = {"data": data, "model": model}
    placement = tsh.Placement({"params": like}, mesh)
    split = tsh.TensorSplit(_Mesh(data, model), cfg)
    kept = {p[len("params/"):] for p, spec in placement.specs.items()
            if split.keeps(p, spec)}
    dense = cfg.sell_kind == "dense"
    # the SELL targets: attn_out and the MLP
    attn = ("wq", "wk", "wv") + (("wo",) if dense else ())
    mlp = ("wg", "wu", "wd") if dense else ()
    want = set()
    for stack, blocks in (("encoder", ("attn",)),
                          ("decoder", ("attn", "cross"))):
        for block in blocks if heads else ():
            want |= {f"{stack}/{block}/{w}/w" for w in attn}
        want |= {f"{stack}/mlp/{w}/w" for w in mlp}
    if table:
        want.add("embed/table")
    assert kept == want
    assert (cfg.vocab_size % model == 0) == table


def test_encdec_step_gathers_model_blocks(runs):
    """Every all-gather of a placed smoke Seamless step at (1, 4) is a
    leaf's gather over the size-1 "data" axis at its model-local size: a
    dense projection of either stack and the embedding a quarter of the
    leaf, a stacked layer's twice (forward and the remat's recompute);
    the norms are not gathered."""
    for rank in runs["ranks"]:
        assert "structure" not in rank["facts"]["errors"], \
            rank["facts"]["errors"]["structure"]
        facts = rank["facts"]["structure"]
        assert facts["remat"]
        want_bytes = want_count = 0
        for path, (shape, size) in facts["leaves"].items():
            if path.split("/")[-1] not in ("w", "table"):
                continue
            stacked = path.split("/")[0] in ("encoder", "decoder")
            times = 2 * shape[0] if stacked else 1
            want_bytes += times * math.prod(shape) // (
                shape[0] if stacked else 1) * size // 4
            want_count += times
        coll = facts["collectives"]
        assert coll["count"]["all-gather"] == want_count
        assert coll["bytes"]["all-gather"] == want_bytes


def test_reckoned_seamless_prefill_outputs_the_vocabulary_block(runs):
    """The dry run's full-width Seamless prefill at (2, 2) puts out the
    logits as the reference's prefill cell does, at ("batch", None,
    "vocab"): 256206 = 2 x 128103 splits over "model", so each rank holds
    its rows and 128103 columns, beside its blocks of the new cache (the
    cross K/V of its 16 frames on its heads).  Its all-reduces are the
    layers' on their heads and ffn columns: one after each ``wo`` and
    ``wd`` (2 an encoder layer, 3 a decoder layer) and the embedding's,
    each of a (rows, positions, d_model) activation."""
    rec = runs["reckoned"][RECKON]
    assert rec["status"] == "ok", rec
    arch, cell, shape, _ = tdry.parse_reckon(RECKON)
    cfg = treg.get_config(arch)
    mesh = dict(zip(("data", "model"), shape))
    b, s, v = cell.global_batch, cell.seq_len, cfg.vocab_size
    spec = tsh.spec_for(mesh, (b, s, v), ("batch", None, "vocab"))
    assert spec == ("data", None, "model")
    block = tsh.local_shape((b, s, v), spec, mesh)
    assert block == (b // 2, s, 128103)
    want = math.prod(block) * 4
    frames = treg.input_specs(cfg, cell)["frontend_embeds"].shape[1]
    cache = tget(cfg).init_cache(cfg, b, s, device="meta")
    for k in ("xk", "xv"):      # a prefill's cross K/V: its frames
        cache[k] = cache[k][:, :, :frames]
    placement = tsh.CachePlacement(cache, mesh)
    assert placement.specs["xk"][3] == "model"
    want += sum(math.prod(tsh.local_shape(t.shape, placement.specs[k],
                                          mesh)) * t.element_size()
                for k, t in cache.items())
    assert rec["memory"]["output_size_in_bytes"] == want
    n_enc, n_dec = cfg.n_encoder_layers or cfg.n_layers, cfg.n_layers
    act = torch.empty((), dtype=cfg.compute_dtype).element_size()
    rows, d = b // 2, cfg.d_model
    reduces = rec["collectives"]
    assert reduces["count"]["all-reduce"] == 2 * n_enc + 3 * n_dec + 1
    assert reduces["bytes"]["all-reduce"] == act * rows * d * (
        2 * n_enc * frames + (3 * n_dec + 1) * s)
