"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` never
import ``jax`` or the JAX package ``repro``.

* a fresh interpreter imports every ``repro_torch`` module and
  ``chip_smoke`` and must end with neither ``jax`` nor ``repro`` (nor a
  ``repro.*`` module) in ``sys.modules``;
* an AST scan of every source finds no such import statement, including
  imports inside functions (which the first check cannot reach).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
need = {"repro_torch.kernels.acdc_bwd", "repro_torch.kernels.acdc_cascade_bwd",
        "repro_torch.optim.optimizers", "repro_torch.optim.schedules",
        "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
        "repro_torch.launch.train", "repro_torch.dist.steps"}
missing = sorted(need - set(names))
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), "modules;", "forbidden:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""


def test_import_everything_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
