"""Serving launcher: the continuous-batching engine over the port's models.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
        --sell acdc --sell-method pallas [--paged] [--smoke]

Each request gets a random ragged-length prompt (``--prompt-len`` is the
longest); the engine admits them into ``--slots`` batch slots with one
prefill each, advances all active slots with one decode step per tick,
and evicts finished requests so the batch stays full.  ``--paged
--block-size 16 [--blocks N]`` serves from the paged KV pool.  Weights
are random, drawn from ``--seed``.  Runs on ``--device cuda`` (the
default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.configs import registry
from repro_torch.models import get_model
from repro_torch.serving import Engine
from repro_torch.serving.request import make_ragged_requests


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_1_7b", choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small smoke configuration")
    ap.add_argument("--sell", default="dense",
                    help="SELL kind for the target projections (dense|acdc)")
    ap.add_argument("--sell-method", default="pallas",
                    choices=["auto", "fft", "matmul", "pallas"],
                    help="transform backend; only 'pallas' (the hand-written "
                         "kernels) is ported")
    ap.add_argument("--sell-transform", default="acdc",
                    help="transform family (acdc | circulant | hadamard)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--sample", default="greedy", choices=["greedy", "temp"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--paged", action="store_true",
                    help="paged block KV cache (one global page pool)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="token positions per KV page (paged mode)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="pool size in pages; default = dense parity")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the sampler")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def build(args: argparse.Namespace, **overrides):
    """(cfg, model, params) for the launcher flags; ``overrides`` replace
    fields of the resulting config (e.g. ``sell_k=1``)."""
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = registry.with_sell(cfg, args.sell, method=args.sell_method,
                             transform=args.sell_transform)
    cfg = dataclasses.replace(cfg, **overrides)
    model = get_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = model.init(gen, cfg, args.device)
    return cfg, model, params


def serve(args: argparse.Namespace, cfg, model, params):
    """Run the engine over the synthetic request stream; returns
    (engine, requests, wall seconds)."""
    eng = Engine(model, cfg, params, n_slots=args.slots,
                 max_len=args.prompt_len + args.gen + 1,
                 max_prompt_len=args.prompt_len, sample=args.sample,
                 temperature=args.temperature, top_k=args.top_k,
                 top_p=args.top_p, seed=args.seed, paged=args.paged,
                 block_size=args.block_size, n_blocks=args.blocks)
    reqs = make_ragged_requests(cfg.vocab_size, args.requests,
                                args.prompt_len, args.gen, seed=args.seed)
    t0 = time.perf_counter()
    eng.run(reqs, max_ticks=4 * args.requests * (args.prompt_len + args.gen)
            + 64)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, reqs, time.perf_counter() - t0


def report(eng: Engine, reqs, dt: float) -> None:
    s = eng.stats
    toks = s["tokens_out"]
    print(f"[engine] {len(reqs)} ragged requests | "
          f"{s['prefill_dispatches']} prefills in {s['prefill_s']:.3f}s | "
          f"{s['decode_ticks']} decode ticks in {s['decode_s']:.3f}s | "
          f"{toks} tokens in {dt:.3f}s ({toks / max(dt, 1e-9):.1f} tok/s)")
    if eng.paged:
        print(f"[paged] block_size={eng.block_size} "
              f"peak {eng.allocator.peak_in_use}/{eng.allocator.n_blocks} "
              f"blocks | {s['stalled_slot_ticks']} stalled slot-ticks | "
              f"cache {eng.cache_bytes / 1e6:.2f} MB")
    ttft = [r.t_first_token - r.t_submit for r in reqs
            if r.t_first_token is not None]
    if ttft:
        print(f"[engine] ttft p50 {np.median(ttft):.3f}s "
              f"max {max(ttft):.3f}s")
    for r in reqs[:2]:
        print(f"   rid={r.rid} len={r.prompt_len} "
              f"finish={r.finish_reason}: {r.generated[:16]}")


def main(argv=None):
    args = parse_args(argv)
    cfg, model, params = build(args)
    print(f"arch={cfg.name} sell={cfg.sell_kind}/{cfg.sell_method} "
          f"slots={args.slots} paged={args.paged} device={args.device}")
    eng, reqs, dt = serve(args, cfg, model, params)
    report(eng, reqs, dt)
    return eng, reqs


if __name__ == "__main__":
    main()
