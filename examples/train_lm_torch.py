"""End-to-end example on PyTorch: train a ~100M-parameter LM for a few
hundred steps, dense vs ACDC projections, on the synthetic Markov-Zipf
stream (the port of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py --sell acdc --steps 200

The same launcher code (``repro_torch.launch.train``) the full-width runs
use -- config, data, AdamW, checkpointing, straggler monitor -- at ~100M
scale: Qwen3's architecture at reduced depth and width.  The checkpoints
go to ``build/train_lm_ckpt`` in the repository unless ``--ckpt-dir``
says otherwise.
"""

import argparse
import dataclasses
from pathlib import Path

from repro_torch import DEFAULT_DEVICE
from repro_torch.configs import registry
from repro_torch.launch import train as train_mod
from repro_torch.models import get_model

DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[1] / "build"
                       / "train_lm_ckpt")


def config():
    """The ~100M variant: the full Qwen3 architecture at 6 layers, d 512."""
    return dataclasses.replace(
        registry.get_config("qwen3_1_7b"),
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=32000, dtype="float32",
    )


def param_count(cfg) -> int:
    """Parameters of ``cfg``'s model, counted on ``meta`` (no storage)."""
    import torch
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 "meta")
    return sum(t.numel() for t in _leaves(params))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None):
    """Train; returns the launcher's (state, history)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sell", default="dense", choices=["dense", "acdc",
                                                        "fastfood",
                                                        "circulant",
                                                        "low_rank"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = config()
    print(f"model: {param_count(cfg) / 1e6:.1f}M params ({args.sell} "
          f"projections)")

    # the launcher resolves --smoke through the registry: hand it the
    # ~100M config instead
    orig = registry.get_smoke_config
    registry.get_smoke_config = lambda arch: cfg
    try:
        return train_mod.main([
            "--arch", "qwen3_1_7b", "--smoke",
            "--sell", args.sell,
            "--steps", str(args.steps),
            "--seq-len", str(args.seq_len),
            "--global-batch", str(args.global_batch),
            "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", "100",
            "--log-every", "10",
            "--device", args.device,
        ])
    finally:
        registry.get_smoke_config = orig


if __name__ == "__main__":
    main()
