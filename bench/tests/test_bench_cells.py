"""Each cell end to end on the CPU at smoke size through the harness's
functions; the result line's shape; a cell found from new files alone;
the command's refusal without a card; the control and planted faults,
each put in the program's place under a whole run, come out as not
correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench import harness
from bench.tests.smoke import smoke_model, smoke_run
from bench.tools import planted

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_end_to_end_and_is_correct(workload):
    res = harness.execute(smoke_run(workload))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in harness.benchmark()["end_to_end"]
             if harness.applies(m, workload)}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_the_result_line_has_the_contract_keys_and_checks_last():
    res = harness.execute(smoke_run("dsmoe.train.2x1024"))
    res.pop("art")
    res.pop("readings")
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    for name, (value, limit) in line["checks"].items():
        assert isinstance(value, float) and isinstance(limit, float), name
    assert "memory_peak_bytes" in line["device"]


@pytest.mark.parametrize("workload,fault", [
    ("dsmoe.train.2x1024", "frozen"),
    ("dsmoe.train.2x1024", "half_batch"),
])
def test_a_planted_fault_is_not_correct(workload, fault):
    with planted.in_place(fault):
        res = harness.execute(smoke_run(workload))
    assert not res["correct"], res["checks"]


def test_a_cell_is_found_from_new_files_alone(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = harness.benchmark()
    with open(root / "bench" / "configs" / "tiny.json", "w") as f:
        json.dump({"model": smoke_model("deepseek_moe_16b-stage7")}, f)
    with open(root / "bench" / "traffic" / "train.tiny.json", "w") as f:
        mix = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                             "train.2x1024.json"))
        json.dump(dict(mix, rows=2, seq=8), f)
    with open(root / "bench" / "limits" / "tiny.train.json", "w") as f:
        json.dump({"limits": {"loss_rel": 1.0, "grad1_gap": 1.0,
                              "change3_gap": 1.0}}, f)
    bench["configs"].append({"name": "tiny", "file": "bench/configs/"
                             "tiny.json", "source": "x", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "tiny.train", "config": "tiny",
                               "traffic": "train.tiny", "chips": 1,
                               "why": "x"})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "BENCH", str(root / "bench"))
    ctx = harness.Run("tiny.train", 5, 0.5, 0, torch.device("cpu"), 0.0)
    assert ctx.mix["seq"] == 8 and ctx.model["d_model"] == 128
    res = harness.execute(ctx)
    assert res["correct"] and "train_tok_s" not in res["metrics"]


def test_the_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
