"""Smoke-size copies of the cells' configurations and mixes, run
through the harness's functions on the CPU (the command itself refuses
to run without a card)."""

import dataclasses
import os
import time

import torch

#: the program's SMOKE widths of each cell's configuration
SMOKE_ARCH = {"seamless_m4t_large_v2": "seamless_m4t_large_v2",
              "deepseek_moe_16b-stage7": "deepseek_moe_16b"}
#: smoke-size mixes a CPU run holds
SMOKE_MIX = {"train": dict(rows=2, seq=16, frames=8)}


def smoke_model(config_name: str, dtype: str = "bfloat16") -> dict:
    from repro_torch.configs import registry

    c = registry.with_sell(
        registry.get_smoke_config(SMOKE_ARCH[config_name]), "acdc",
        method="pallas")
    d = dataclasses.asdict(dataclasses.replace(c, dtype=dtype))
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def smoke_run(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 1.0,
              dtype: str = "bfloat16"):
    """A :class:`bench.harness.Run` of ``workload`` at smoke size on the
    CPU."""
    from bench import harness

    bench = harness.benchmark()
    cell = harness.find(bench["workloads"], workload, "workload")
    mix = harness.load_json(os.path.join(
        harness.BENCH, "traffic", f"{cell['traffic']}.json"))
    mix.update(SMOKE_MIX[mix["kind"]])
    if mix["kind"] == "train" and "seamless" not in cell["config"]:
        mix["frames"] = 0
    return harness.Run(workload, seed, seconds, 0, torch.device("cpu"),
                       time.perf_counter(), bench=bench,
                       model=smoke_model(cell["config"], dtype), mix=mix)
