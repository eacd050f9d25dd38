"""On the card only (skips without one): the command runs a cell at its
own size and prints one result line.  Run on the chip with
``PYTHONPATH=src python -m pytest bench/tests -m cuda``."""

import json
import os
import subprocess
import sys

import pytest

from bench import harness

pytestmark = pytest.mark.cuda


def test_the_command_prints_a_correct_result_line(cuda_dev):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"),
         "--workload", "dsmoe.train.2x1024", "--seed", "3",
         "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
        cwd=harness.ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", ["control", "half_batch", "frozen"])
def test_the_control_and_faults_are_not_correct_at_the_cell_size(
        cuda_dev, name):
    from bench.tools import planted

    with planted.in_place(name):
        res = harness.execute(harness.Run(
            "dsmoe.train.2x1024", 2 ** 31 + 11, 2.0, 0, cuda_dev, 0.0))
    assert not res["correct"], res["checks"]
