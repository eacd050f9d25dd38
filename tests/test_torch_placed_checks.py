"""The four-card script's held checks (``scripts/placed_multi_card.py``)
on the CPU at SMOKE width: a run whose check fails exits nonzero and
names the check, the same run within its limit exits 0; the placed steps
run by threads of one process on a :class:`VirtualMesh` (the placed-block
control) equal the unplaced steps; a fault planted in the placed steps
(the vocabulary's blocks gathered out of order), which the control
copies bit for bit, is not settled: the ceiling holds it;
:func:`first_difference` places where two runs' all-reduces part.  The
script is the port's own: no reference to hold it against.
"""

import types

import json

import pytest
import torch

import _torch_dist_worker as worker
import _torch_placed_script_runner as runner
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import registry
from repro_torch.dist import steps as steps_mod
from repro_torch.models import get_model

TIMEOUT_S = 300


@pytest.fixture(scope="module")
def script():
    return runner.load()


@pytest.mark.parametrize("loss_rtol,rc", [(-1.0, 1), (1e-4, 0)])
def test_failed_check_sets_the_exit_status(tmp_path, loss_rtol, rc):
    out = tmp_path / "out.json"
    (proc,) = worker.launch_ranks(1, [
        "tests/_torch_placed_script_runner.py", str(loss_rtol), "--train",
        "qwen3_1_7b:1:2", "--replicated", "qwen3_1_7b", "--out", str(out)])
    try:
        assert proc.wait(timeout=TIMEOUT_S) == rc
    finally:
        proc.kill()
    report = json.loads(out.read_text())
    (run,) = report["runs"]
    assert run["losses_ok"] is (rc == 0)
    assert run["ranks"][0]["hidden_across_model"] == [
        {"max_abs": 0.0, "differing": 0}]
    if rc:
        assert report["failed_checks"] == [
            f"train qwen3_1_7b acdc float32 model 1: losses "
            f"{run['loss_rel']:.3g} apart"]
    else:
        assert report["failed_checks"] == []


def _smoke(script, arch):
    """(cfg, model, params, prompts) of ARCH at SMOKE width on ``acdc``:
    4 rows of 12 positions (ragged), a 20-position cache, 3 steps."""
    cfg = registry.with_sell(registry.get_smoke_config(arch), "acdc",
                             method="pallas")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    lengths = torch.tensor([12, 9, 12, 5], dtype=torch.int32)
    p = script.Prompts(torch.randint(0, cfg.vocab_size, (4, 12),
                                     generator=gen, dtype=torch.int32),
                       lengths, None, 20, 3)
    return cfg, model, params, p


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "zamba2_1_2b"])
def test_virtual_mesh_runs_the_placed_steps(script, arch):
    """Four virtual ranks at (1, 4) and (2, 2) on one CPU process: the
    streams and logits of the unplaced steps (fp32), every all-reduce
    recorded on each rank."""
    cfg, model, params, p = _smoke(script, arch)
    lengths = p.lengths
    with torch.no_grad():
        full, _ = steps_mod.make_prefill_step(model, cfg, full_logits=True)(
            params, model.init_cache(cfg, 4, 20, device="cpu"), p.tokens,
            lengths, None)
    for shape in ((1, 4), (2, 2)):
        results, calls = script.virtual_run(
            shape, lambda m: script.placed_serve(model, cfg, params, m, p,
                                                 False))
        for r in results[1:]:
            assert r["streams"].tolist() == results[0]["streams"].tolist()
            assert torch.equal(r["full_logits"], results[0]["full_logits"])
        assert results[0]["streams"].shape == (4, 4)
        torch.testing.assert_close(results[0]["full_logits"], full.float(),
                                   atol=2e-4, rtol=1e-3)
        assert len({len(c) for c in calls}) == 1 and calls[0]


def test_a_planted_fault_is_not_settled(script, monkeypatch):
    """The placed steps at (1, 4) with their vocabulary's blocks gathered
    out of order (rolled by one column after the gather): the logits
    depart from one card's by O(1); the placed-block control, the same
    code, reproduces them bitwise, and the ceiling leaves the fp32 check
    failed."""
    cfg, model, params, p = _smoke(script, "qwen3_1_7b")
    real = steps_mod.gather_vocab
    monkeypatch.setattr(steps_mod, "gather_vocab",
                        lambda logits, tp: real(logits, tp).roll(1, -1))
    results, calls = script.virtual_run(
        (1, 4), lambda m: script.placed_serve(model, cfg, params, m, p,
                                              False))
    recorder = types.SimpleNamespace(calls=[c[:2] for c in calls[0]])
    inputs = [[script._sha(c[0]) for c in rank] for rank in calls]
    res = script.one_card(model, cfg, params, p, False, "float32",
                          results[0], recorder, inputs, (1, 4))
    assert res["last_logits_max_abs"] > 100 * script.SETTLE_CEIL \
        * script.SERVE_FP32_ATOL
    assert res["block_control"]["bitwise"]
    assert res["block_control"]["settled"]
    assert res["logits_ok"] is False and res["logits_held"] is False
    report = {"runs": [], "pod_train": [], "cells": [], "served": [
        dict(arch="qwen3_1_7b", sell="acdc", dtype="float32",
             model_parallel=4, ranks=[dict(res, memo_digests=["x"],
                                           hidden_across_model=[])])]}
    assert any("fp32 logits" in c for c in script.failed_checks(report))


def test_first_difference_places_the_part(script):
    s = script
    a = torch.ones(3)
    exact = (a * 4).double()
    parts = [[(a, a * 4, exact, a.double().abs() * 4, 4)] for _ in range(4)]
    placed = [(a, a * 4)]
    inputs = [[s._sha(a)] for _ in range(4)]
    assert s.first_difference(placed, inputs, parts) is None
    # a different input: the difference arose before the all-reduce
    got = s.first_difference(placed, [[s._sha(a + 1)]] + inputs[1:], parts)
    assert got["kind"] == "input" and got["call"] == 0
    # equal inputs, the output one rounding from the exact sum: within
    # gamma_3 sum |p| = ~3 * 2^-24 * 4
    near = [(a, (a * 4) * (1 + 2.0 ** -23))]
    got = s.first_difference(near, inputs, parts)
    assert got["kind"] == "all_reduce" and got["terms"] == 4
    assert got["within"] and got["control_over_bound"] == 0.0
    far = [(a, (a * 4) * (1 + 2.0 ** -21))]
    got = s.first_difference(far, inputs, parts)
    assert not got["within"] and got["placed_over_bound"] > 1
    assert s.first_difference(placed * 2, inputs, parts)["kind"] == "count"
