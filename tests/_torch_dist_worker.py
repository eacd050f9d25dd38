"""One data rank of the port's train step over gloo, for
``test_torch_dist_train.py``.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_dist_worker.py IN.npz OUT_PREFIX COMPRESS

Reads the initial state and the batches that ``_jax_compressed_steps.py``
wrote, trains this rank's rows of each batch with the port's
``make_train_step`` (smoke Qwen3-1.7B, ``acdc`` on ``pallas``, fp32, the
reference's optimizer), and writes ``OUT_PREFIX<rank>.npz``: the final
state (this rank's ``grad_error`` row), the per-step metrics, and what
its quantizer saw each step: the int8 levels, the block scales and the
quotient before rounding (``q<s>/<path>``, ``scale<s>/<path>``,
``x<s>/<path>``).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.dist import compression, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.train import SELL_GROUPS
from repro_torch.models import get_model
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim import schedules

METRICS = ("loss", "grad_norm", "update_norm")
OPT = opt_mod.OptimizerConfig(kind="adamw", lr=3e-3, groups=SELL_GROUPS)
SCHEDULE = schedules.cosine_schedule(OPT.lr, 1, 6)
ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(n: int, argv: list, **popen) -> list:
    """Start ``n`` processes of ``argv`` as ranks 0..n-1 of one gloo group,
    with ``torchrun``'s variables and one thread each."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT / "src"))
        procs.append(subprocess.Popen([sys.executable, "-u", *argv],
                                      cwd=ROOT, env=env, **popen))
    return procs


def spy_levels(records: dict, now: dict):
    """Record what the quantizer sees of every leaf into ``records``;
    returns a function that undoes the spy."""
    reduce_tree = compression.compressed_all_reduce_tree

    def spy(grads, errors, group=None):
        paths, leaves = opt_mod.tree_flatten(grads)
        for path, g, e in zip(paths, leaves, opt_mod.tree_flatten(errors)[1]):
            flat = g.float().reshape(-1) + e.reshape(-1)
            flat = torch.where(torch.isfinite(flat), flat, 0.0)
            q, scale = compression.quantize_int8(flat)
            pad = q.numel() - flat.numel()
            blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(q.shape)
            x = blocks / torch.clamp_min(scale, 1e-30)
            for name, t in (("q", q), ("scale", scale), ("x", x)):
                records[f"{name}{now['step']}/{path}"] = t.numpy().copy()
        return reduce_tree(grads, errors, group)

    compression.compressed_all_reduce_tree = spy
    return lambda: setattr(compression, "compressed_all_reduce_tree",
                           reduce_tree)


def run_steps(arrays, group=None, rank: int = 0, size: int = 1,
              compress: bool = True, levels: Optional[dict] = None):
    """(final flat state, metrics) of the reference's batches in
    ``arrays``, this rank's rows of each; the quantizer's view of every
    step goes to ``levels`` when given."""
    cfg = registry.with_sell(registry.get_smoke_config("qwen3_1_7b"),
                             "acdc", method="pallas")
    model = get_model(cfg)
    opt = opt_mod.make_optimizer(OPT, SCHEDULE)
    init = {k[len("init/"):]: arrays[k] for k in arrays.files
            if k.startswith("init/")}
    init = {k: v[rank:rank + 1] if k.startswith("grad_error/") else v
            for k, v in init.items()
            if compress or not k.startswith("grad_error/")}
    state = bridge.state_to_torch(init, "cpu")
    step = steps.make_train_step(model, cfg, opt, group=group,
                                 compress=compress)
    metrics = {k: [] for k in METRICS}
    n_steps = len(arrays["loss"])
    now = {"step": 0}
    undo = spy_levels(levels, now) if levels is not None else None
    for s in range(n_steps):
        now["step"] = s
        batch = {k.split("/")[1]: torch.from_numpy(arrays[k])
                 for k in arrays.files if k.startswith(f"batch{s}/")}
        per = batch["tokens"].shape[0] // size
        rows = {k: t[rank * per:(rank + 1) * per] for k, t in batch.items()}
        state, met = step(state, rows)
        for k in METRICS:
            metrics[k].append(float(met[k]))
    if undo is not None:
        undo()
    return bridge.state_to_numpy(state), metrics


def main(src: str, out_prefix: str, compress: bool) -> None:
    torch.set_num_threads(1)
    mesh = mesh_mod.make_host_mesh(1, "cpu")
    try:
        rank = mesh.get_local_rank("data")
        levels = {}
        flat, metrics = run_steps(np.load(src), mesh.get_group("data"),
                                  rank, mesh.shape[0], compress, levels)
        np.savez(f"{out_prefix}{rank}.npz", **flat, **levels,
                 **{k: np.array(v) for k, v in metrics.items()})
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    assert "RANK" in os.environ, "start one process a rank (torchrun's env)"
    main(sys.argv[1], sys.argv[2], sys.argv[3] == "1")
