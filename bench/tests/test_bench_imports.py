"""Nothing ``bench/run.py`` runs, nor the reference, loads ``jax`` or the
JAX package; the reference loads nothing of the program.  Modules are
compared by their whole top-level name (``repro_torch`` is not
``repro``)."""

import os
import subprocess
import sys

from bench import harness

CHECK = """
import sys, time
sys.path[:0] = [{src!r}, {root!r}]
import torch
{body}
bad = sorted({{m.split('.')[0] for m in sys.modules}} & set({forbidden!r}))
print(','.join(bad))
"""


def _loaded(body: str, forbidden) -> str:
    code = CHECK.format(src=os.path.join(harness.ROOT, "src"),
                        root=harness.ROOT, body=body, forbidden=forbidden)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


def test_a_run_loads_no_jax():
    body = """
from bench.tests.smoke import smoke_run
from bench import harness
for w in [c["name"] for c in harness.benchmark()["workloads"]]:
    harness.execute(smoke_run(w))
import bench.run, bench.tools.readings
"""
    assert _loaded(body, harness.FORBIDDEN) == ""


def test_the_reference_loads_nothing_of_the_program():
    body = """
import bench.reference.model, bench.reference.optim
"""
    assert _loaded(body, harness.FORBIDDEN + ("repro_torch",)) == ""


def test_top_level_names_are_compared_whole():
    sys.modules.setdefault("repro_torch", sys.modules.get("repro_torch"))
    assert "repro" not in [m for m in harness.forbidden_modules()
                           if m == "repro_torch"]
    assert "repro" in harness.FORBIDDEN and "repro_torch" not in \
        harness.FORBIDDEN
