"""Serving launcher: the continuous-batching engine over the port's models.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
        --sell acdc [--sell-method auto|fft|matmul|pallas] [--paged] [--smoke]

Each request gets a random ragged-length prompt (``--prompt-len`` is the
longest); the engine admits them into ``--slots`` batch slots with one
prefill each, advances all active slots with one decode step per tick,
and evicts finished requests so the batch stays full.  ``--paged
--block-size 16 [--blocks N]`` serves from the paged KV pool.
``--static`` runs one batched prefill and a lockstep decode instead (no
slot reuse), for A/B runs.  ``--spec [--spec-k 4] [--draft-depth K/2]
[--spec-skip-layers J]`` turns on speculative decoding: the target's own
truncated ACDC cascades draft ``--spec-k`` tokens a tick and one verify
pass scores them all, so each slot advances by its accepted length a
target pass (greedy streams equal the non-speculative engine's in fp32;
in bf16 the verify's and the decode's matmuls round apart and a stream
can depart).
Weights are random, drawn from ``--seed``.  Runs on ``--device cuda``
(the default) or ``cpu``.  The banner names the model family and its
decode cache a slot (K/V, SSM state, or both for the hybrid); the ssm
family (``--arch mamba2_1_3b``) has no paged cache and serves dense.
``--frontend`` gives every request of a config with a vision frontend
(``--arch llava_next_34b``) a stub patch prefix: ``n_frontend_tokens``
placeholder positions before its prompt, whose embeddings the request
carries (standard normal, fp32, drawn from ``--seed`` and its id).  An
encoder-decoder (``--arch seamless_m4t_large_v2``) needs no flag: every
request, and every row of ``--static``, carries stub audio frames
(``n_frontend_tokens or 16`` of them, drawn the same way) for its
encoder.

Overload and observability (engine path only): ``--deadline-s S`` gives
a ``--deadline-frac`` share of the requests a latency SLO (admission turns
earliest-deadline-first, expired requests finish as ``timeout``),
``--priorities N`` draws priority bands, ``--wall-clock-limit-s`` bounds
the serve loop, ``--metrics-jsonl PATH`` appends registry snapshots every
``--metrics-every`` ticks, ``--trace-out PATH`` writes per-request spans
as Chrome trace JSON, and ``--profile-ticks A:B`` captures a
``torch.profiler`` window over engine ticks A..B into
``--profile-logdir`` (default ``build/profile``, not committed).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.configs import registry
from repro_torch.core import acdc as acdc_mod
from repro_torch.dist import steps as steps_mod
from repro_torch.models import get_model, linear
from repro_torch.models import mlp as mlp_mod
from repro_torch.obs import (REGISTRY, JsonlExporter, Observability, Prof,
                             ProfileWindow, Registry, SpanTracer,
                             set_global_tracer)
from repro_torch.serving import Engine, sampler as sampler_mod
from repro_torch.serving.request import make_ragged_requests

#: default profile capture directory: build/profile at the repository
#: root (``build/`` is not committed)
DEFAULT_PROFILE_DIR = str(Path(__file__).resolve().parents[3] / "build"
                          / "profile")


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
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--sample", default="greedy", choices=["greedy", "temp"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--frontend", action="store_true",
                    help="give each request a stub patch prefix of the "
                         "config's n_frontend_tokens (vision frontends)")
    ap.add_argument("--static", action="store_true",
                    help="batched prefill + lockstep decode, no slot reuse")
    ap.add_argument("--paged", action="store_true",
                    help="paged block KV cache (one global page pool)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="token positions per KV page (paged mode)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="pool size in pages; default = dense parity")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding: truncated-cascade "
                         "self-draft + one batched k-token verify per tick "
                         "(greedy streams as without it in fp32; in bf16 "
                         "they can depart)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative tick")
    ap.add_argument("--draft-depth", type=int, default=None,
                    help="cascade layers the draft keeps "
                         "(default sell_k // 2)")
    ap.add_argument("--spec-skip-layers", type=int, default=0,
                    help="also drop this many top transformer blocks "
                         "from the draft")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="give a fraction of requests this latency SLO; "
                         "admission turns earliest-deadline-first and "
                         "requests past the deadline finish as timeouts")
    ap.add_argument("--deadline-frac", type=float, default=0.5,
                    help="fraction of requests carrying --deadline-s")
    ap.add_argument("--priorities", type=int, default=1,
                    help="priority bands drawn uniformly per request "
                         "(ties in deadline order; shed order under "
                         "overload)")
    ap.add_argument("--wall-clock-limit-s", type=float, default=None,
                    help="hard bound on the serve loop's real time; exits "
                         "with partial results instead of hanging")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append periodic registry snapshots (JSON lines) "
                         "to PATH; off when unset")
    ap.add_argument("--metrics-every", type=int, default=50,
                    help="ticks between --metrics-jsonl snapshots")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write per-request span tracing as Chrome "
                         "trace-event JSON to PATH; off when unset")
    ap.add_argument("--profile-ticks", default=None, metavar="A:B",
                    help="capture a torch.profiler window across engine "
                         "ticks A..B inclusive (see --profile-logdir)")
    ap.add_argument("--profile-logdir", default=DEFAULT_PROFILE_DIR,
                    help="destination of the --profile-ticks capture")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the sampler")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    if args.paged and args.static:
        ap.error("--paged applies to the engine path, not --static")
    if args.spec and args.static:
        ap.error("--spec applies to the engine path, not --static")
    if args.frontend and args.static:
        ap.error("--frontend applies to the engine path, not --static")
    if args.static and (args.metrics_jsonl or args.trace_out
                        or args.profile_ticks or args.deadline_s):
        ap.error("--metrics-jsonl/--trace-out/--profile-ticks/--deadline-s "
                 "apply to the engine path, not --static")
    return args


def config(args: argparse.Namespace, **overrides):
    """The model config of the launcher flags; ``overrides`` replace its
    fields (e.g. ``sell_k=1``)."""
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = registry.with_sell(cfg, args.sell, method=args.sell_method,
                             transform=args.sell_transform)
    return dataclasses.replace(cfg, **overrides)


def build(args: argparse.Namespace, **overrides):
    """(cfg, model, params) for the launcher flags; ``overrides`` replace
    fields of the resulting config (e.g. ``sell_k=1``)."""
    cfg = config(args, **overrides)
    model = get_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = model.init(gen, cfg, args.device)
    return cfg, model, params


def build_obs(args: argparse.Namespace) -> Observability:
    """The observability bundle of the launcher flags:
    ``Observability.off()`` (the engine's no-op path) when none is set.
    The JSON-lines exporter merges in the process-global ``REGISTRY`` so
    the kernels' dispatch counters ride along; a tracer is also installed
    as the global one (allocator audits, straggler flags)."""
    if not (args.metrics_jsonl or args.trace_out or args.profile_ticks):
        return Observability.off()
    reg = Registry()
    tracer = None
    if args.trace_out:
        # clock=None: the tracer adopts the engine's clock at attach
        tracer = SpanTracer()
        set_global_tracer(tracer)
    exporter = None
    if args.metrics_jsonl:
        exporter = JsonlExporter(args.metrics_jsonl, reg,
                                 every=args.metrics_every, clock=time.time,
                                 extra_snapshots=(REGISTRY.snapshot,))
    window = prof = None
    if args.profile_ticks:
        window = ProfileWindow(args.profile_ticks, args.profile_logdir,
                               device=args.device)
        prof = Prof(enabled=True)
    return Observability(registry=reg, tracer=tracer, exporter=exporter,
                         prof=prof, window=window)


def _make_frontend(cfg, gen: torch.Generator, batch: int):
    """Stub frontend inputs, standard normal fp32 on the CPU: an
    encoder-decoder's audio frames (batch, n_frontend_tokens or 16,
    d_model), a vision frontend's patch embeddings (batch,
    n_frontend_tokens, d_model); None for a config without either."""
    if cfg.family == "encdec":
        frames = cfg.n_frontend_tokens or 16
    elif cfg.frontend == "vision" and cfg.n_frontend_tokens:
        frames = cfg.n_frontend_tokens
    else:
        return None
    return torch.randn((batch, frames, cfg.d_model), generator=gen)


def frontend_prefix(args: argparse.Namespace, cfg) -> int:
    """Placeholder positions ``--frontend`` puts before every prompt."""
    if not args.frontend:
        return 0
    if cfg.frontend != "vision" or not cfg.n_frontend_tokens:
        raise ValueError(f"{cfg.name} has no vision frontend")
    return cfg.n_frontend_tokens


def serve(args: argparse.Namespace, cfg, model, params, fault=None):
    """Run the engine over the synthetic request stream (deadlines and
    priorities from the flags; ``fault`` a ``FaultPlan``; with
    ``--frontend`` a stub patch prefix a request, and an
    encoder-decoder's requests their stub frames); then flush the
    observability bundle and write the trace.  Returns (engine, requests,
    wall seconds)."""
    obs = build_obs(args)
    prefix = frontend_prefix(args, cfg)
    eng = Engine(model, cfg, params, n_slots=args.slots,
                 max_len=prefix + args.prompt_len + args.gen + 1,
                 max_prompt_len=prefix + args.prompt_len, sample=args.sample,
                 temperature=args.temperature, top_k=args.top_k,
                 top_p=args.top_p, seed=args.seed, paged=args.paged,
                 block_size=args.block_size, n_blocks=args.blocks,
                 spec_k=args.spec_k if args.spec else 0,
                 draft_depth=args.draft_depth,
                 draft_skip_layers=args.spec_skip_layers,
                 fault=fault, obs=obs)
    if args.spec:
        print(f"[spec] k={eng.spec_k} draft={type(eng.draft).__name__} "
              f"depth={getattr(eng.draft, 'depth', '-')} "
              f"skip_layers={getattr(eng.draft, 'skip_layers', 0)}")
    deadline_range = None
    if args.deadline_s is not None:
        deadline_range = (args.deadline_s, args.deadline_s)
    reqs = make_ragged_requests(cfg.vocab_size, args.requests,
                                args.prompt_len, args.gen, seed=args.seed,
                                deadline_range=deadline_range,
                                deadline_frac=args.deadline_frac,
                                n_priorities=args.priorities)
    for req in reqs if prefix or cfg.family == "encdec" else ():
        req.prompt = [0] * prefix + list(req.prompt)
        req.frontend_embeds = _make_frontend(
            cfg, torch.Generator().manual_seed(args.seed * 1_000_003
                                               + req.rid), 1)
    t0 = time.perf_counter()
    eng.run(reqs, max_ticks=4 * args.requests * (args.prompt_len + args.gen)
            + 64, wall_clock_limit_s=args.wall_clock_limit_s)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    obs.close()
    if obs.tracer is not None:
        obs.tracer.write(args.trace_out)
        set_global_tracer(None)
    return eng, reqs, dt


def report(eng: Engine, reqs, dt: float, trace_out=None) -> None:
    s = eng.stats
    toks = s["tokens_out"]
    if eng.wall_clock_exceeded:
        print(f"[engine] wall clock limit hit after {dt:.3f}s: partial "
              f"results")
    print(f"[engine] {len(reqs)} ragged requests | "
          f"{s['prefill_dispatches']} prefills in {s['prefill_s']:.3f}s | "
          f"{s['decode_ticks']} decode ticks in {s['decode_s']:.3f}s | "
          f"{toks} tokens in {dt:.3f}s ({toks / max(dt, 1e-9):.1f} tok/s)")
    if eng.paged:
        print(f"[paged] block_size={eng.block_size} "
              f"peak {eng.allocator.peak_in_use}/{eng.allocator.n_blocks} "
              f"blocks | {s['stalled_slot_ticks']} stalled slot-ticks | "
              f"{s['preempted']} preempted | cache "
              f"{eng.cache_bytes / 1e6:.2f} MB")
    if (s["requeued"] or s["timeout"] or s["rejected"]
            or s["degrade_down"]):
        print(f"[resilience] {s['requeued']} requeued "
              f"({s['deadline_preempts']} for deadlines) | "
              f"{s['timeout']} timed out | {s['rejected']} shed | "
              f"ladder down/up {s['degrade_down']}/{s['degrade_up']} "
              f"(now {eng.degrade_level})")
    if eng.spec_k:
        print(f"[spec] {s['accepted']}/{s['drafted']} drafts accepted "
              f"(rate {s['acceptance_rate']:.3f}) | {s['decode_ticks']} "
              f"verify dispatches for {toks} tokens "
              f"({toks / max(s['decode_ticks'], 1):.2f} tok/dispatch)")
    ttft = [r.t_first_token - r.t_submit for r in reqs
            if r.t_first_token is not None]
    if ttft:
        print(f"[engine] ttft p50 {np.median(ttft):.3f}s "
              f"max {max(ttft):.3f}s")
    for r in reqs[:2]:
        print(f"   rid={r.rid} len={r.prompt_len} "
              f"finish={r.finish_reason}: {r.generated[:16]}")
    obs = eng.obs
    if obs.tracer is not None:
        print(f"[obs] chrome trace -> {trace_out} (load in "
              f"chrome://tracing or ui.perfetto.dev)")
    if obs.exporter is not None:
        print(f"[obs] metrics jsonl -> {obs.exporter.path} "
              f"({obs.exporter.exports} snapshots)")
    if obs.window is not None:
        sm = obs.window.summary
        print(f"[obs] profiler capture -> {obs.window.logdir} (ticks "
              f"{obs.window.start_tick}:{obs.window.stop_tick})"
              + (f" | device busy {sm['device_busy_share']:.1%}, host "
                 f"{sm['host_s_per_step'] * 1e3:.2f} ms a tick, "
                 f"{sm['kernels_per_step']:.0f} kernels a tick"
                 if sm else ""))


def run_static(args: argparse.Namespace, cfg, model, params):
    """Batched prefill of ``--slots`` prompts of ``--prompt-len`` tokens
    (an encoder-decoder's rows with their stub frames), then ``--gen - 1``
    lockstep decode steps (no slot reuse); returns (tokens (slots, gen),
    prefill seconds, decode seconds)."""
    dev = torch.device(args.device)
    b, p, g = args.slots, args.prompt_len, args.gen
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (b, p), generator=gen,
                            device=dev, dtype=torch.int32)
    cache = model.init_cache(cfg, b, p + g + 1, dev)
    prefill = steps_mod.make_prefill_step(model, cfg)
    serve_step = steps_mod.make_serve_step(
        model, cfg, sample=args.sample, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fe = None
    if cfg.family == "encdec":
        fe = _make_frontend(cfg, torch.Generator().manual_seed(args.seed),
                            b).to(dev)
    t0 = time.perf_counter()
    lengths = torch.full((b,), p, dtype=torch.int32, device=dev)
    last, cache = prefill(params, cache, prompts, lengths, fe)
    tok = sampler_mod.sample(last, method=args.sample,
                             temperature=args.temperature, top_k=args.top_k,
                             top_p=args.top_p, generator=gen)
    sync()
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(g - 1):
        pos = torch.full((b,), p + i, dtype=torch.int32, device=dev)
        tok, cache = serve_step(params, cache, tok, pos, gen)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    toks = torch.stack(out, dim=1).cpu()
    print(f"[static] prefill {p}x{b} tokens in one call: {t_prefill:.3f}s | "
          f"decode {g - 1} steps: {t_decode:.3f}s "
          f"({b * (g - 1) / max(t_decode, 1e-9):.1f} tok/s)")
    for row in toks[: min(b, 2)]:
        print("  ", row[:16].tolist())
    return toks, t_prefill, t_decode


def projections(cfg) -> list:
    """``(role, n_in, n_out, count)`` of every projection of ``cfg``'s
    stack that can be a SELL layer and runs at each decode step,
    ``count`` its instances (layers, or the shared block's
    applications).  An encoder-decoder's decoder layer adds the
    cross-attention's query and output projections; its encoder and the
    cross K/V projections run once a request, at prefill, at the same
    sizes."""
    from repro_torch.models import mamba2, zamba2

    d, dh = cfg.d_model, cfg.head_dim_
    out = []
    if cfg.family in ("ssm", "hybrid"):
        out += [("ssm_in", d, mamba2._proj_out(cfg), cfg.n_layers),
                ("ssm_out", mamba2._dims(cfg)[0], d, cfg.n_layers)]
    n_attn = (len(zamba2._n_groups(cfg)) if cfg.family == "hybrid"
              else cfg.n_layers if cfg.family in ("decoder", "encdec")
              else 0)
    if cfg.family == "hybrid":
        out.append(("shared_in", 2 * d, d, n_attn))
    if n_attn:
        out += [("attn_qkv", d, cfg.n_heads * dh, n_attn),
                ("attn_qkv", d, cfg.n_kv_heads * dh, 2 * n_attn),
                ("attn_out", cfg.n_heads * dh, d, n_attn)]
        if cfg.family == "encdec":
            out += [("attn_qkv", d, cfg.n_heads * dh, n_attn),
                    ("attn_out", cfg.n_heads * dh, d, n_attn)]
        # the MLP, or the experts and the shared expert (mlp roles too)
        for d_ff in ([cfg.d_ff] + ([cfg.d_ff * cfg.n_shared_experts]
                                   if cfg.n_experts and cfg.n_shared_experts
                                   else [])):
            out += [("mlp_in", d, d_ff, n_attn), ("mlp_out", d_ff, d, n_attn)]
    return out


def sell_routes(cfg) -> str:
    """The method each SELL operating size of ``cfg`` runs, ``auto``
    resolved by the reference's size rule (e.g. ``N=2048 matmul, N=6144
    fft``); empty unless the projections are ``acdc`` cascades."""
    if cfg.sell_kind != "acdc":
        return ""
    sizes = sorted({linear._sell_cfg(cfg, n_in, n_out).n_op
                    for role, n_in, n_out, _ in projections(cfg)
                    if linear.uses_sell(cfg, role)})
    return ", ".join(f"N={n} {acdc_mod._resolve_method(n, cfg.sell_method)}"
                     for n in sizes)


def cache_kind(cfg, model, max_len: int) -> str:
    """The family and its decode cache a slot: the recurrent SSM/conv
    state (O(1) in length) and the K/V (``max_len`` positions)."""
    leaves = model.init_cache(cfg, 1, max_len, "meta")
    rec = set(model.recurrent_keys)

    def mb(keys):
        return sum(t.numel() * t.element_size()
                   for k, t in leaves.items() if k in keys) / 1e6

    parts = []
    if rec:
        parts.append(f"SSM state {mb(rec):.2f} MB a slot")
    kv = set(leaves) - rec
    if kv:
        parts.append(f"K/V {mb(kv):.2f} MB a slot at {max_len} positions")
    return f"family={cfg.family} | " + " + ".join(parts)


def moe_shape(cfg, args: argparse.Namespace) -> str:
    """The MoE layer's shape and each expert's capacity at this batch (a
    decode tick routes ``--slots`` tokens, an admission ``--prompt-len``,
    a speculative verify ``slots * (k + 1)``); empty for a dense MLP."""
    if not cfg.n_experts:
        return ""
    ticks = [("decode", args.slots), ("prefill", args.prompt_len)]
    if args.spec:
        ticks.append(("verify", args.slots * (args.spec_k + 1)))
    caps = ", ".join(f"{name} {mlp_mod.capacity(cfg, t)} ({t} tokens)"
                     for name, t in ticks)
    return (f"E={cfg.n_experts} top-{cfg.top_k} shared="
            f"{cfg.n_shared_experts} (d_ff {cfg.d_ff} / "
            f"{cfg.d_ff * cfg.n_shared_experts}) | capacity {caps}")


def main(argv=None):
    args = parse_args(argv)
    cfg, model, params = build(args)
    routes = sell_routes(cfg)
    print(f"arch={cfg.name} sell={cfg.sell_kind}/{cfg.sell_method}"
          + (f" ({routes})" if routes else "")
          + f" slots={args.slots} paged={args.paged} static={args.static} "
          f"device={args.device}")
    max_len = frontend_prefix(args, cfg) + args.prompt_len + args.gen + 1
    print(f"[cache] {cache_kind(cfg, model, max_len)}")
    if cfg.n_experts:
        print(f"[moe] {moe_shape(cfg, args)}")
    if args.static:
        return run_static(args, cfg, model, params)
    eng, reqs, dt = serve(args, cfg, model, params)
    report(eng, reqs, dt, args.trace_out)
    return eng, reqs


if __name__ == "__main__":
    main()
