"""Training launcher: config -> model -> AdamW with the paper's SELL
parameter groups -> train state -> train step -> synthetic data ->
checkpoints (async, atomic, keep-3).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b \\
        --smoke --sell acdc --sell-method pallas --device cpu --steps 2

Prints ``step N loss ... |g| ... ms`` lines (every ``--log-every`` steps
and the last), ``resumed from step N`` when ``--resume`` finds a
checkpoint, ``[straggler]`` lines for steps a ``StragglerMonitor`` flags,
and ``done.``.  The step loss, tokens/s, step time and every cascade's
diagonal norms go to the process-global obs registry; ``--metrics-jsonl
PATH`` appends its snapshot on the ``--log-every`` cadence.  Weights are random (seed 0), batches
synthetic (:class:`repro_torch.data.SyntheticLM`).  Runs on ``--device
cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import steps as steps_mod
from repro_torch.dist.elastic import StragglerMonitor
from repro_torch.models import get_model
from repro_torch.obs import REGISTRY, JsonlExporter
from repro_torch.optim import (OptimizerConfig, cosine_schedule,
                               make_optimizer)
from repro_torch.optim.optimizers import tree_flatten

# The paper's per-group treatment of the SELL diagonals (section 6.2):
# lr x24 on A, x12 on D, no weight decay on either; norms/bias undecayed.
SELL_GROUPS = (
    (r"sell/a$", {"lr_mult": 24.0, "weight_decay": 0.0}),
    (r"sell/d$", {"lr_mult": 12.0, "weight_decay": 0.0}),
    (r"sell/", {"weight_decay": 0.0}),
    (r"norm|scale$|bias$", {"weight_decay": 0.0}),
)

#: default checkpoint root: build/train_ckpt at the repository root
#: (``build/`` is not committed)
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_ckpt")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_1_7b", choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small smoke configuration")
    ap.add_argument("--sell", default="dense",
                    help="SELL kind for the target projections: dense | "
                         "low_rank | circulant | fastfood | acdc (afdf, "
                         "complex-valued, is core-level only)")
    ap.add_argument("--sell-method", default="auto",
                    choices=["auto", "fft", "matmul", "pallas"],
                    help="transform backend of --sell acdc: auto (the "
                         "reference's default: matmul at N <= 4096, fft "
                         "above) | fft (torch.fft) | matmul (the explicit "
                         "matrices) | pallas (the hand-written kernels)")
    ap.add_argument("--sell-transform", default="acdc",
                    help="transform family of --sell acdc cascades "
                         "(acdc | circulant | hadamard)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append registry snapshots (JSON lines) to PATH "
                         "on the --log-every cadence; off when unset")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def build(args: argparse.Namespace, **overrides):
    """(cfg, model, opt, train_step, pipeline) for the launcher flags;
    ``overrides`` replace fields of the config (e.g. ``sell_k=1``)."""
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = registry.with_sell(cfg, args.sell, method=args.sell_method,
                             transform=args.sell_transform)
    cfg = dataclasses.replace(cfg, **overrides)
    model = get_model(cfg)
    opt = make_optimizer(
        OptimizerConfig(kind="adamw", lr=args.lr, groups=SELL_GROUPS),
        cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps))
    train_step = steps_mod.make_train_step(model, cfg, opt, args.accum_steps)
    pipeline = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, frontend=cfg.frontend,
        n_frontend_tokens=(cfg.n_frontend_tokens
                           or (args.seq_len // 4 if cfg.frontend == "audio"
                               else 0)),
        d_model=cfg.d_model))
    return cfg, model, opt, train_step, pipeline


def init_or_resume(args, cfg, model, opt, ckpt: CheckpointManager):
    """(state, start step): the latest checkpoint under ``--resume``, else
    a fresh state from seed 0 on ``--device``."""
    gen = torch.Generator(device=args.device).manual_seed(0)
    state = steps_mod.init_state(model, cfg, opt, gen, args.device)
    latest = ckpt.latest_step() if args.resume else None
    if latest is None:
        return state, 0
    state = ckpt.restore(latest, state)
    print(f"resumed from step {latest}", flush=True)
    return state, latest


def batch_on(pipeline: SyntheticLM, step: int, device) -> dict:
    return {k: t.to(device) for k, t in pipeline.batch_at(step).items()}


def _train_metrics() -> dict:
    """Training diagnostics in the process-global registry (names as in
    the ``repro_torch/obs/__init__.py`` glossary)."""
    return {
        "loss": REGISTRY.gauge("train_step_loss", "last step loss"),
        "tps": REGISTRY.gauge("train_tokens_per_s",
                              "last step token throughput"),
        "step_s": REGISTRY.histogram("train_step_seconds",
                                     "step wall time (incl. the first "
                                     "step's set-up)"),
        "diag": REGISTRY.gauge("train_cascade_diag_norm",
                               "per-cascade SELL diagonal l2 norm",
                               labels=("param", "cascade")),
    }


def _emit_diag_norms(gauge, params) -> None:
    """Per-cascade ||A||_2 / ||D||_2 gauges, labelled by the parameter
    path: the paper's init/depth sensitivity lives in these diagonals."""
    for path, leaf in zip(*tree_flatten(params)):
        for suffix in ("a", "d"):
            if path.endswith(f"sell/{suffix}"):
                cascade = path[: -len(f"/sell/{suffix}")]
                gauge.labels(param=suffix, cascade=cascade).set(
                    float(torch.linalg.vector_norm(leaf.float())))


def run(args: argparse.Namespace, cfg, model, opt, train_step, pipeline):
    """The training loop over ``build``'s pieces; returns (state, one dict
    per step of its metrics as floats and its wall time ``ms``)."""
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    state, start = init_or_resume(args, cfg, model, opt, ckpt)
    cuda = torch.device(args.device).type == "cuda"
    monitor = StragglerMonitor()
    obs = _train_metrics()
    exporter = (JsonlExporter(args.metrics_jsonl, REGISTRY,
                              every=args.log_every, clock=time.time)
                if args.metrics_jsonl else None)
    history = []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch_on(pipeline, step,
                                                    args.device))
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        history.append({**{k: float(v) for k, v in metrics.items()},
                        "ms": dt * 1e3})
        obs["loss"].set(history[-1]["loss"])
        obs["tps"].set(args.global_batch * args.seq_len / max(dt, 1e-9))
        obs["step_s"].observe(dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {history[-1]['loss']:.4f} "
                  f"|g| {history[-1]['grad_norm']:.3f} {dt * 1e3:.0f}ms",
                  flush=True)
            _emit_diag_norms(obs["diag"], state["params"])
            if exporter is not None:
                exporter.export(step)
        # the first step pays the set-up (kernel loads, allocator growth):
        # seeding the EWMA with it would mask real stragglers
        if step > start and monitor.observe(step, dt):
            print(f"[straggler] step {step} exceeded {monitor.factor}x "
                  f"EWMA", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, state, extra={"arch": args.arch})
    ckpt.wait()
    ckpt.save(args.steps, state, extra={"arch": args.arch})
    if exporter is not None:
        exporter.close()
        print(f"[obs] metrics jsonl -> {args.metrics_jsonl} "
              f"({exporter.exports} snapshots)", flush=True)
    print("done.")
    return state, history


def main(argv=None):
    """Train; returns ``run``'s (state, history)."""
    args = parse_args(argv)
    return run(args, *build(args))


if __name__ == "__main__":
    main()
