#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails):

1. no CUDA device -> fail at once; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build every kernel in ``src/repro_torch/csrc/`` with nvcc (one process
   per source, all at once) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and time kernel, plain version and (where one
   PyTorch call computes the same function) the library call;
4. serve full-width Qwen3-1.7B with ACDC projections (``--sell acdc
   --sell-method pallas``) through the launcher's functions, dense then
   paged, counting kernel launches; compare one prefill's and one decode
   step's logits with the plain path on the card, and record each side's
   drift from an fp64-summed path and two controls (TF32 on; the
   diagonals dropped, which must exceed the limit);
5. serve the smoke width (fp32) dense, paged and with K=1 cascades;
   greedy streams must be identical with the kernels and with the plain
   versions;
6. print ``{"kernels": [...]}``, then the final
   ``{"ok": true, "device": {...}}`` line.

Details go to ``chiprun_out/chip_smoke.json``.  Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and fp32
#: (non-tensor-core) FLOP/s -- the kernels use fp32 FMAs only
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

#: logits of the full-width model, kernels vs plain versions on the card.
#: Both round to bf16 at the same places but sum in fp32 in other orders,
#: so a bf16 rounding can flip by one ulp (2^-8 relative); with random
#: weights the residual stream grows to max |x| ~ 1.6e4 over 28 layers
#: (``residual_by_layer`` in the report) and such flips compound.  The
#: bound on the relative L2 error of the logits is checked to sit above
#: what the fp32 orders give and below a faulty path that drops the
#: diagonals (``compare_full_width_logits``)
BF16_LOGIT_REL_L2 = 0.1


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = flops / FP32_FLOP_S * 1e3
    return (max(tb, tf), "bytes" if tb >= tf else "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rel_close(got, want, rtol: float, atol: float) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(dev):
    import torch

    from repro_torch.core import families
    from repro_torch.kernels import acdc_cascade_fused as cascade_mod
    from repro_torch.kernels import acdc_fused as fused_mod
    from repro_torch.kernels import paged_attn as pa_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import scaled_matmul as smm_mod

    g = torch.Generator(device=dev).manual_seed(1234)
    results = {"scaled_matmul": [], "acdc_cascade": [], "acdc_fused": [],
               "paged_attn": []}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # scaled_matmul: the two-call ACDC layer at N = 2048 (attn_out) and
    # 6144 (mlp), M = 4 (decode, 4 slots) and 64 (prefill window), bf16 x
    for n in (2048, 6144):
        c, _ = families.get_family("acdc").matrices(n, torch.float32, dev)
        for m in (4, 64):
            x = randn(m, n, dtype=torch.bfloat16)
            pre = 1.0 + 0.061 * randn(n)
            got = smm_mod.scaled_matmul(x, c, pre=pre)
            want = ref.scaled_matmul_ref(x, c, pre=pre)
            torch.cuda.synchronize()
            # bf16 output: different fp32 summation orders may round one
            # bf16 ulp (2^-8 relative) apart
            if not rel_close(got, want, rtol=2 ** -7, atol=1e-2):
                _fail(f"scaled_matmul N={n} M={m}: max err "
                      f"{max_err(got, want)}")
            xf = x.float()
            # each side's fp32 summation error against fp64 on fp32 x
            # (no bf16 output rounding to hide it), relative to max |y|
            y64 = (xf.double() * pre.double()) @ c.double()
            scale = float(y64.abs().max())
            acc_err = {side: float((fn(xf, c, pre=pre).double() - y64)
                                   .abs().max()) / scale
                       for side, fn in (("kernel", smm_mod.scaled_matmul),
                                        ("plain", ref.scaled_matmul_ref))}
            ms = time_ms(lambda: smm_mod.scaled_matmul(x, c, pre=pre))
            pms = time_ms(lambda: ref.scaled_matmul_ref(x, c, pre=pre))
            lms = time_ms(lambda: torch.matmul(xf, c))
            nbytes = m * n * 2 + n * n * 4 + n * 4 + m * n * 2
            b, by = bound_ms(nbytes, 2.0 * m * n * n)
            results["scaled_matmul"].append(dict(
                shape=f"M={m} K=N={n} bf16 x", max_abs_err=max_err(got, want),
                ms=ms, plain_ms=pms, library_ms=lms, bound_ms=b,
                bound_by=by, fp32_err_vs_fp64=acc_err))

    # cascade: K=2 with the riffle folded in, N = 128 / 256 (smoke
    # attn_out / mlp) and 1024 (the largest N the fused route takes);
    # M = 4 (decode) and 64 (prefill), fp32 as the smoke model
    fam = families.get_family("acdc")
    for n in (128, 256, 1024):
        c, ct = fam.matrices(n, torch.float32, dev)
        perm = torch.as_tensor(fam.riffle(n), dtype=torch.long, device=dev)
        ct_mid = ct[:, perm].contiguous()
        for m in (4, 64):
            x = randn(m, n)
            a = 1.0 + 0.061 * randn(2, n)
            d = 1.0 + 0.061 * randn(2, n)
            got = cascade_mod.acdc_cascade(x, a, d, None, c, ct, ct_mid)
            want = ref.acdc_cascade_ref(x, a, d, None, c, ct, ct_mid)
            torch.cuda.synchronize()
            if not rel_close(got, want, rtol=1e-3, atol=2e-4):
                _fail(f"acdc_cascade N={n} M={m}: max err "
                      f"{max_err(got, want)}")
            ms = time_ms(lambda: cascade_mod.acdc_cascade(
                x, a, d, None, c, ct, ct_mid))
            pms = time_ms(lambda: ref.acdc_cascade_ref(
                x, a, d, None, c, ct, ct_mid))
            nbytes = 2 * m * n * 4 + 2 * 2 * n * 4 + 3 * n * n * 4
            b, by = bound_ms(nbytes, 2 * 4.0 * m * n * n)
            results["acdc_cascade"].append(dict(
                shape=f"M={m} N={n} K=2 riffle fp32",
                max_abs_err=max_err(got, want), ms=ms, plain_ms=pms,
                library_ms=None, bound_ms=b, bound_by=by))

    # acdc_fused (K=1 branch) at N = 256, with and without bias
    n = 256
    c, ct = fam.matrices(n, torch.float32, dev)
    for m in (4, 64):
        for with_bias in (False, True):
            x = randn(m, n)
            a = 1.0 + 0.061 * randn(n)
            d = 1.0 + 0.061 * randn(n)
            bias = 0.1 * randn(n) if with_bias else None
            got = fused_mod.acdc_fused(x, a, d, bias, c, ct)
            b2 = None if bias is None else bias[None]
            want = ref.acdc_cascade_ref(x, a[None], d[None], b2, c, ct,
                                        None)
            torch.cuda.synchronize()
            if not rel_close(got, want, rtol=1e-3, atol=2e-4):
                _fail(f"acdc_fused N={n} M={m} bias={with_bias}: max err "
                      f"{max_err(got, want)}")
            ms = time_ms(lambda: fused_mod.acdc_fused(x, a, d, bias, c, ct))
            pms = time_ms(lambda: ref.acdc_cascade_ref(
                x, a[None], d[None], b2, c, ct, None))
            nbytes = 2 * m * n * 4 + (3 if with_bias else 2) * n * 4 \
                + 2 * n * n * 4
            b, by = bound_ms(nbytes, 4.0 * m * n * n)
            results["acdc_fused"].append(dict(
                shape=f"M={m} N={n} bias={with_bias} fp32",
                max_abs_err=max_err(got, want), ms=ms, plain_ms=pms,
                library_ms=None, bound_ms=b, bound_by=by))

    # paged attention: qwen3 heads (16 q / 8 kv, Dh 128), 16-token pages,
    # bf16 pools, 4 slots at ragged positions (one parked), T = 1 and 5
    hq, hkv, dh, bs, mb, bsz = 16, 8, 128, 16, 6, 4
    nb = bsz * mb
    virtual = mb * bs
    for t in (1, 5):
        tables = torch.arange(nb, dtype=torch.int32,
                              device=dev).reshape(bsz, mb)
        tables[0, 3:] = -1          # unmapped tail beyond the frontier
        positions = torch.tensor([5, 37, 63 - t, virtual],
                                 dtype=torch.int32, device=dev)
        q = randn(bsz, t, hq, dh, dtype=torch.bfloat16)
        kn = randn(bsz, t, hkv, dh, dtype=torch.bfloat16)
        vn = randn(bsz, t, hkv, dh, dtype=torch.bfloat16)
        kp = randn(nb + 1, bs, hkv, dh, dtype=torch.bfloat16)
        vp = randn(nb + 1, bs, hkv, dh, dtype=torch.bfloat16)
        kp2, vp2 = kp.clone(), vp.clone()
        got = pa_mod.paged_attention(q, kn, vn, kp, vp, tables, positions,
                                     0, softcap=0.0)
        want = ref.paged_attention_ref(q, kn, vn, kp2, vp2, tables,
                                       positions, 0, 0.0)
        torch.cuda.synchronize()
        # bf16 output: fp32 online softmax in another order than the
        # plain version's softmax; one bf16 ulp of |out| <= ~4.  Every
        # row is held, the parked one (which attends to its new tokens
        # only) too
        if not rel_close(got, want, rtol=2 ** -7, atol=2e-2):
            _fail(f"paged_attn T={t}: max err {max_err(got, want)}")
        # the page writes must be the same writes (trash page excluded:
        # parked rows race to it by design and nothing reads it)
        if not (torch.equal(kp[:-1], kp2[:-1])
                and torch.equal(vp[:-1], vp2[:-1])):
            _fail(f"paged_attn T={t}: pool writes differ")
        ms = time_ms(lambda: pa_mod.paged_attention(
            q, kn, vn, kp, vp, tables, positions, 0, softcap=0.0))
        pms = time_ms(lambda: ref.paged_attention_ref(
            q, kn, vn, kp2, vp2, tables, positions, 0, 0.0), reps=5)
        streamed = sum(int(p) for p in positions.tolist() if p < virtual)
        attended = sum((int(p) if p < virtual else 0) + t
                       for p in positions.tolist())
        item = 2
        nbytes = (2 * bsz * t * hq * dh * item        # q in, out
                  + 4 * bsz * t * hkv * dh * item     # new k/v in, written
                  + 2 * streamed * hkv * dh * item)   # streamed k/v
        flops = 4.0 * attended * t * hq * dh
        b, by = bound_ms(nbytes, flops)
        results["paged_attn"].append(dict(
            shape=f"B={bsz} T={t} Hq={hq} Hkv={hkv} Dh={dh} bs={bs} bf16",
            max_abs_err=max_err(got, want), ms=ms, plain_ms=pms,
            library_ms=None, bound_ms=b, bound_by=by))
    return results


# ---------------------------------------------------------------------------
# Phases 4-5: serving through the launcher's functions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version (so the same model
    code runs the plain path on the card) -- for comparisons only."""
    from repro_torch.kernels import acdc_cascade_fused as cascade_mod
    from repro_torch.kernels import acdc_fused as fused_mod
    from repro_torch.kernels import paged_attn as pa_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import scaled_matmul as smm_mod

    saved = (smm_mod.scaled_matmul, fused_mod.acdc_fused,
             cascade_mod.acdc_cascade, pa_mod.paged_attention)

    def fused_plain(x, a, d, bias, c, ct):
        b2 = None if bias is None else bias.reshape(1, -1)
        return ref.acdc_cascade_ref(x, a.reshape(1, -1), d.reshape(1, -1),
                                    b2, c, ct, None)

    def cascade_plain(x, a, d, bias, c, ct, ct_mid, relu=False):
        return ref.acdc_cascade_ref(x, a, d, bias, c, ct, ct_mid, relu)

    def paged_plain(q, kn, vn, kp, vp, tables, position, window, softcap):
        return ref.paged_attention_ref(q, kn.to(kp.dtype), vn.to(vp.dtype),
                                       kp, vp, tables, position, int(window),
                                       float(softcap))

    smm_mod.scaled_matmul = ref.scaled_matmul_ref
    fused_mod.acdc_fused = fused_plain
    cascade_mod.acdc_cascade = cascade_plain
    pa_mod.paged_attention = paged_plain
    try:
        yield
    finally:
        (smm_mod.scaled_matmul, fused_mod.acdc_fused,
         cascade_mod.acdc_cascade, pa_mod.paged_attention) = saved


KERNEL_MODULES = ("scaled_matmul", "acdc_cascade", "acdc_fused",
                  "paged_attn")


def _modules():
    from repro_torch.kernels import acdc_cascade_fused, acdc_fused
    from repro_torch.kernels import paged_attn, scaled_matmul

    return {"scaled_matmul": scaled_matmul,
            "acdc_cascade": acdc_cascade_fused,
            "acdc_fused": acdc_fused, "paged_attn": paged_attn}


def reset_counts() -> None:
    for mod in _modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in _modules().items()}


def serve_path(label, argv, params_cache, totals, require, sell_k=2):
    """Drive the launcher's engine once with counts reset just before and
    read just after; ``require`` names kernels that must have launched."""
    import torch

    from repro_torch.launch import serve

    args = serve.parse_args(argv)
    key = (args.smoke, sell_k)
    if key not in params_cache:
        params_cache[key] = serve.build(args, sell_k=sell_k)
    cfg, model, params = params_cache[key]
    reset_counts()
    eng, reqs, dt = serve.serve(args, cfg, model, params)
    counts = read_counts()
    for name in require:
        if counts[name] == 0:
            _fail(f"{label}: kernel {name} never launched on this path")
    for name, n in counts.items():
        totals[name] += n
    s = eng.stats
    streams = [list(r.generated) for r in reqs]
    if any(r.finish_reason is None for r in reqs):
        _fail(f"{label}: unfinished requests")
    info = dict(path=label, argv=argv, tokens=s["tokens_out"], wall_s=dt,
                tok_per_s=s["tokens_out"] / dt, prefill_s=s["prefill_s"],
                decode_s=s["decode_s"], decode_ticks=s["decode_ticks"],
                prefills=s["prefill_dispatches"], launches=counts,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[serve] {label}: {s['tokens_out']} tokens in {dt:.3f}s "
          f"({info['tok_per_s']:.1f} tok/s) | prefill {s['prefill_s']:.3f}s "
          f"({s['prefill_dispatches']}) | decode {s['decode_s']:.3f}s "
          f"({s['decode_ticks']} ticks) | launches {counts}", flush=True)
    return info, streams


def scaled_matmul_fp64(x, w, pre=None, post=None, bias=None):
    """The plain scaled_matmul with fp64 products and sums: rounds to x's
    dtype at the same place, so it shows each side's fp32 drift."""
    h = x.double()
    if pre is not None:
        h = h * pre.double()
    y = h @ w.double()
    if post is not None:
        y = y * post.double()
    if bias is not None:
        y = y + bias.double()
    return y.to(x.dtype)


def scaled_matmul_without_pre(x, w, pre=None, post=None, bias=None):
    """A deliberately faulty scaled_matmul that drops ``pre`` (so every
    ACDC layer loses its diagonals): a control for the logit limit."""
    from repro_torch.kernels import ref

    return ref.scaled_matmul_ref(x, w, None, post, bias)


@contextlib.contextmanager
def scaled_matmul_as(fn):
    from repro_torch.kernels import scaled_matmul as smm_mod

    saved = smm_mod.scaled_matmul
    smm_mod.scaled_matmul = fn
    try:
        yield
    finally:
        smm_mod.scaled_matmul = saved


@contextlib.contextmanager
def plain_with_tf32():
    """The plain path with TF32 fp32 matmuls: a lower-precision control."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with plain_kernels():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _rel_l2(got, want) -> float:
    import torch

    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def compare_full_width_logits(params_cache, dev):
    """One prefill's and one decode step's logits, kernels vs plain, gated
    at ``BF16_LOGIT_REL_L2``.  Beside it, each side against an fp64-summed
    path (which side drifts), every layer's residual stream, and two
    controls read against the same limit: the plain path with TF32 and a
    faulty path that drops the diagonals."""
    import numpy as np
    import torch

    from repro_torch.models import transformer

    cfg, model, params = params_cache[(False, 2)]
    rs = np.random.RandomState(3)
    plen, window = 41, 64
    toks = np.zeros((1, window), np.int32)
    toks[0, :plen] = rs.randint(0, cfg.vocab_size, size=plen)
    toks_t = torch.from_numpy(toks).to(dev)
    lengths = torch.tensor([plen], dtype=torch.int32, device=dev)
    next_tok = torch.tensor([rs.randint(0, cfg.vocab_size)],
                            dtype=torch.int32, device=dev)
    template = model.init_cache(cfg, 1, 96, dev)
    ffn = transformer._ffn

    def run():
        residuals = []

        def ffn_recording(layer, x, cfg_):
            y = ffn(layer, x, cfg_)
            residuals.append(y[0, :plen].float())
            return y

        transformer._ffn = ffn_recording
        try:
            logits, cache = model.prefill(params, template, toks_t, cfg,
                                          lengths)
        finally:
            transformer._ffn = ffn
        pos = torch.tensor([plen], dtype=torch.int32, device=dev)
        dlog, _ = model.decode_step(params, cache, next_tok, pos, cfg)
        return {"prefill": logits[0, plen - 1].float(),
                "decode": dlog[0].float(), "residuals": residuals}

    runs = {"kernel": run()}
    for name, ctx in (("plain", plain_kernels),
                      ("fp64", lambda: scaled_matmul_as(scaled_matmul_fp64)),
                      ("plain_tf32", plain_with_tf32),
                      ("no_diagonals",
                       lambda: scaled_matmul_as(scaled_matmul_without_pre))):
        with ctx():
            runs[name] = run()
    torch.cuda.synchronize()
    pairs = (("kernel", "plain"), ("kernel", "fp64"), ("plain", "fp64"),
             ("plain_tf32", "plain"), ("no_diagonals", "plain"))
    out = {"limit_rel_l2": BF16_LOGIT_REL_L2}
    for where in ("prefill", "decode"):
        rels = {f"{a}_vs_{b}": _rel_l2(runs[a][where], runs[b][where])
                for a, b in pairs}
        got, want = runs["kernel"][where], runs["plain"][where]
        out[where] = dict(rel_l2=rels, max_abs_err=max_err(got, want),
                          max_abs=float(want.abs().max()))
        print(f"[logits] full width {where}: rel L2 " + ", ".join(
            f"{k} {v:.3e}" for k, v in rels.items())
            + f" (|logit| <= {out[where]['max_abs']:.2f}; limit "
            f"{BF16_LOGIT_REL_L2} on kernel_vs_plain)", flush=True)
        if not rels["kernel_vs_plain"] <= BF16_LOGIT_REL_L2:
            _fail(f"full-width {where} logits: rel L2 "
                  f"{rels['kernel_vs_plain']} > {BF16_LOGIT_REL_L2}")
        if not rels["no_diagonals_vs_plain"] > BF16_LOGIT_REL_L2:
            _fail(f"full-width {where} logits: the limit "
                  f"{BF16_LOGIT_REL_L2} does not catch the faulty control "
                  f"(rel L2 {rels['no_diagonals_vs_plain']})")
    layers = []
    for i in range(cfg.n_layers):
        row = {f"{a}_vs_{b}": _rel_l2(runs[a]["residuals"][i],
                                      runs[b]["residuals"][i])
               for a, b in pairs[:3]}
        row["max_abs"] = float(runs["plain"]["residuals"][i].abs().max())
        layers.append(row)
        if i % 9 == 0 or i == cfg.n_layers - 1:
            print(f"[residual] layer {i}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in row.items()), flush=True)
    out["residual_by_layer"] = layers
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"[device] {smi} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(logs)} libraries in {build_s:.1f}s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    report["build_s"] = build_s

    kern = check_kernels(dev)
    for name, rows in kern.items():
        for r in rows:
            print(f"[kernel] {name} {r['shape']}: err {r['max_abs_err']:.2e}"
                  f" | {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']})", flush=True)
    report["kernels"] = kern
    totals = {name: 0 for name in KERNEL_MODULES}

    params_cache = {}
    paths = []
    base = ["--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method",
            "pallas", "--slots", "4", "--prompt-len", "64",
            "--device", "cuda"]
    full = base + ["--gen", "16", "--requests", "8"]
    # warm-up: one short request so the timed runs do not pay the
    # first-call set-up of the libraries (not a main-path run)
    serve_path("warm-up", base + ["--gen", "2", "--requests", "1"],
               params_cache, {k: 0 for k in KERNEL_MODULES}, ())
    for paged in (False, True):
        label = "full width " + ("paged" if paged else "dense")
        info, _ = serve_path(
            label, full + (["--paged"] if paged else []), params_cache,
            totals, ("scaled_matmul",) + (("paged_attn",) if paged
                                         else ()))
        paths.append(info)
    report["full_width_logits"] = compare_full_width_logits(
        params_cache, dev)
    del params_cache[(False, 2)]
    torch.cuda.empty_cache()

    smoke = ["--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
             "--sell-method", "pallas", "--slots", "4", "--prompt-len",
             "12", "--gen", "8", "--requests", "8", "--device", "cuda"]
    for label, extra, sell_k, need in (
            ("smoke dense", [], 2, ("acdc_cascade",)),
            ("smoke paged", ["--paged", "--block-size", "4"], 2,
             ("acdc_cascade", "paged_attn")),
            ("smoke K=1", [], 1, ("acdc_fused",))):
        info, streams = serve_path(label, smoke + extra, params_cache,
                                   totals, need, sell_k)
        with plain_kernels():
            _, plain_streams = serve_path(
                label + " (plain)", smoke + extra, params_cache,
                {k: 0 for k in KERNEL_MODULES}, (), sell_k)
        if streams != plain_streams:
            _fail(f"{label}: greedy streams differ between kernels and "
                  f"plain versions")
        info["streams_identical_to_plain"] = True
        paths.append(info)
    report["paths"] = paths
    report["launches"] = totals

    sources = {"scaled_matmul": ("src/repro_torch/csrc/scaled_matmul.cu",
                                 "src/repro/kernels/scaled_matmul.py:59", 2),
               "acdc_cascade": ("src/repro_torch/csrc/acdc_cascade.cu",
                                "src/repro/kernels/acdc_cascade_fused.py:104",
                                3),
               "acdc_fused": ("src/repro_torch/csrc/acdc_cascade.cu",
                              "src/repro/kernels/acdc_fused.py:64", 0),
               "paged_attn": ("src/repro_torch/csrc/paged_attn.cu",
                              "src/repro/kernels/paged_attn.py:225", 0)}
    line = []
    for name, (src, replaces, pick) in sources.items():
        r = kern[name][pick]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": totals[name],
                     "shape": r["shape"], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(smi_line())
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
