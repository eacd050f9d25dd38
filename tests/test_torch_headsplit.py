"""Port parity, head-parallel and sequence-parallel decode: the placed
serving steps (``make_prefill_step`` / ``make_serve_step`` with
``mesh=``) on caches placed by ``cache_specs`` beyond their rows, K/V and
SSM heads over "model" and, at batch 1, the K/V sequence over "data"
(``dist/sharding.py``'s ``DecodeSplit``).

Four gloo ranks at (data 2, model 2) (``_torch_headsplit_worker.py``)
against the reference's steps jitted with ``param_shardings`` /
``cache_specs`` / ``data_specs`` on the same mesh of four forced host
devices (``_jax_headsplit_ref.py``), on the same numpy-seeded weights
(``bridge``), prompts and first tokens:

* smoke Gemma3-27B (window 8, softcap), Moonshot-v1-16B-A3B (MoE),
  Seamless-M4T-large-v2 (cross K/V from 16 frames), Mamba2-1.3B and
  Zamba2-1.2B with a (4, 16) cache: a ``full_logits`` prefill of ragged
  8-token prompts, then 3 greedy decode steps;
* smoke Gemma3-27B and Mamba2-1.3B at batch 1 with a 32-position cache
  (16 a data rank for Gemma3): a 12-token prompt, then 8 decode steps
  through position 19, across the blocks' boundary at 16.

Each rank's logits rows are held at fp32 atol 2e-4 / rtol 1e-3
(tests/test_kernel_grads.py:248), its final cache blocks against the
slices of the reference's final leaves at the same tolerance, the next
tokens exactly; Seamless's second prefill without frames reads its block
of the cross cache.  A sampled (``temp``) decode, each rank drawing from
its own generator, gives every rank of a row the same tokens (the first
model rank's draw) and blocks equal to the unplaced steps fed them.
"""

import json
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
#: case -> (arch, rows, cache length, prompt positions, decode steps)
CASES = {
    "gemma3_27b": ("gemma3_27b", 4, 16, 8, 3),
    "moonshot_v1_16b_a3b": ("moonshot_v1_16b_a3b", 4, 16, 8, 3),
    "seamless_m4t_large_v2": ("seamless_m4t_large_v2", 4, 16, 8, 3),
    "mamba2_1_3b": ("mamba2_1_3b", 4, 16, 8, 3),
    "zamba2_1_2b": ("zamba2_1_2b", 4, 16, 8, 3),
    "gemma3_27b_long": ("gemma3_27b", 1, 32, 12, 8),
    "mamba2_1_3b_long": ("mamba2_1_3b", 1, 32, 12, 8),
}
#: the cache leaf that carries each family's heads
HEADS_LEAF = {"decoder": "k", "encdec": "xk", "ssm": "ssm",
              "hybrid": "attn_k"}


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
    for i, (case, (arch, b, cache_len, s, n)) in enumerate(CASES.items()):
        cfg = treg.get_smoke_config(arch)
        params = tget(cfg).init(torch.Generator().manual_seed(i), cfg, "cpu")
        pre = f"{case}/"
        arrays.update({f"{pre}params/{k}": v
                       for k, v in bridge.to_numpy(params).items()})
        arrays[pre + "arch"] = np.array(arch)
        arrays[pre + "cache_len"] = np.array(cache_len)
        arrays[pre + "steps"] = np.array(n)
        arrays[pre + "tokens"] = rng.integers(
            0, cfg.vocab_size, (b, s)).astype(np.int32)
        arrays[pre + "lengths"] = np.array([s, s - 3, s, s - 5][:b],
                                           np.int32)
        arrays[pre + "first"] = rng.integers(
            0, cfg.vocab_size, (b,)).astype(np.int32)
        if cfg.family == "encdec":
            arrays[pre + "frames"] = rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and four gloo ranks, at once, on the inputs drawn
    here."""
    d = tmp_path_factory.mktemp("headsplit")
    _draw_inputs(d / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_headsplit_ref.py"),
         str(d / "in.npz"), str(d / "ref.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    (d / "w").mkdir()
    procs += worker.launch_ranks(
        4, [str(ROOT / "tests" / "_torch_headsplit_worker.py"),
            str(d / "in.npz"), str(d / "w")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for rc, text in _finish(procs, 600):
        assert rc == 0, text[-6000:]
    ranks = [dict(npz=np.load(d / "w" / f"rank{r}.npz"),
                  facts=json.loads((d / "w" / f"rank{r}.json").read_text()))
             for r in range(4)]
    return dict(ref=np.load(d / "ref.npz"), ranks=ranks)


def _slices(index) -> tuple:
    return tuple(slice(a, b) for a, b in index)


@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_prefill_matches_reference(runs, case):
    ref, pre = runs["ref"], f"{case}/"
    for rank in runs["ranks"]:
        a, b = rank["facts"][case]["rows"]
        np.testing.assert_allclose(rank["npz"][pre + "logits"],
                                   ref[pre + "logits"][a:b], **F32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_decode_tokens_match_reference(runs, case):
    want = runs["ref"][f"{case}/next"].tolist()
    for rank in runs["ranks"]:
        assert rank["facts"][case]["next"] == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_decode_blocks_match_reference(runs, case):
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
def test_cache_splits_beyond_its_rows(runs, case):
    """Every case decodes a cache split as the reference places it: the
    family's heads over "model"; at batch 1 Gemma3's K/V sequence over
    "data" (Mamba2's state has no sequence: replicated over "data")."""
    arch, b = CASES[case][:2]
    cfg = treg.get_smoke_config(arch)
    leaf = HEADS_LEAF[cfg.family]
    for rank in runs["ranks"]:
        specs = rank["facts"][case]["specs"]
        heads_dim = 2 if leaf == "ssm" else 3
        assert specs[leaf][heads_dim] == "model", specs
        if b == 1 and leaf != "ssm":
            assert specs[leaf][2] == "data", specs
        if b > 1:
            assert specs[leaf][1] == "data", specs


def test_prefill_reads_head_split_cross_cache(runs):
    """Seamless's prefill without frames attends its block of the placed
    cache's cross K/V (split over heads), as the reference's reads the
    whole."""
    case = "seamless_m4t_large_v2"
    ref = runs["ref"][f"{case}/again"]
    for rank in runs["ranks"]:
        a, b = rank["facts"][case]["rows"]
        assert rank["facts"][case]["specs"]["xk"][3] == "model"
        np.testing.assert_allclose(rank["npz"][f"{case}/again"], ref[a:b],
                                   **F32)


def test_sampled_decode_draws_once_a_row(runs):
    """Each rank samples from a generator of its own seed; the two model
    ranks of a row decode the first one's tokens and write the same
    tokens' K/V into their head blocks."""
    streams = [r["facts"]["sampled"]["next"] for r in runs["ranks"]]
    assert all(s == streams[0] for s in streams)
    coords = {tuple(r["facts"]["sampled"]["coord"]) for r in runs["ranks"]}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for rank in runs["ranks"]:
        assert rank["facts"]["sampled"]["block_vs_unplaced"] <= F32["atol"]
