"""``scripts/placed_multi_card.py`` on the CPU at SMOKE width, for
``test_torch_placed_checks.py``.

    RANK=0 WORLD_SIZE=1 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_placed_script_runner.py LOSS_RTOL ARGS...

Loads the script as a module with ``DEVICE = "cpu"``, every config at its
SMOKE width, the card's memory calls and ``nvidia-smi`` stubbed and
``POD_LOSS_RTOL`` set to LOSS_RTOL, then exits with ``main``'s status.
"""

import importlib.util
import sys
from pathlib import Path

import torch

from repro_torch.configs import registry

ROOT = Path(__file__).resolve().parents[1]


def load():
    spec = importlib.util.spec_from_file_location(
        "placed_multi_card", ROOT / "scripts" / "placed_multi_card.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    mod.DEVICE = "cpu"
    mod.smi = lambda: "CPU"
    return mod


if __name__ == "__main__":
    torch.set_num_threads(1)
    registry.get_config = registry.get_smoke_config
    for name, value in (("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0),
                        ("memory_allocated", 0), ("synchronize", None),
                        ("empty_cache", None)):
        setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)
    mod = load()
    mod.POD_LOSS_RTOL = float(sys.argv[1])
    sys.argv = [sys.argv[0]] + sys.argv[2:]
    sys.exit(mod.main())
