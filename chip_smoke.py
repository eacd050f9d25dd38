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
   ``scaled_matmul`` at M = 4, 16, 64 (bf16 x) and the M = 512 fp32
   backward triple, N = 2048 and 6144: also bitwise repeat, its fp32
   error against fp64 within 2 x cuBLAS fp32's, every time warm and with
   L2 flushed, a tensor-core bound beside the fp32 one, and both of its
   regimes timed at M = 4, 16, 32, 64 (the regime boundary);
   ``acdc_cascade`` / ``acdc_fused`` / ``acdc_cascade_bwd`` / ``acdc_bwd``:
   also bitwise repeat and their fp32 error against an fp64 cascade (and
   fp64 gradients) within 2 x the plain version's, timed by device time
   (launches queued behind a ``torch.cuda._sleep``) beside the call time
   and the host's us a call, with each row's cluster plan (and
   ``cudaOccupancyMaxActiveClusters``); the forward's library call is one
   fp32 ``torch.matmul`` with the cascade's composed dense matrix;
   ``paged_attn`` at the main path's decode and verify rows (L2 flushed
   too) and at long rows a - d (67 MB of K/V each: 4 x 4096, 16 x 1024,
   1 x 16384 keys at T = 1, 4 x 4096 at T = 5), bitwise on a repeat, its
   split plan recorded, the T = 1 long rows beside one
   ``scaled_dot_product_attention`` call over a contiguous cache;
4. serve full-width Qwen3-1.7B with ACDC projections (``--sell acdc
   --sell-method pallas``) through the launcher's functions, dense then
   paged, counting kernel launches; compare one prefill's and one decode
   step's logits with the plain path on the card, and record each side's
   drift from an fp64-summed path and two controls (TF32 on; the
   diagonals dropped, which must exceed the limit); and hold
   ``scaled_matmul``'s fp32 error on the prefill's own inputs within 2 x
   cuBLAS fp32's;
5. serve the smoke width (fp32) dense, paged and with K=1 cascades;
   greedy streams must be identical with the kernels and with the plain
   versions;
6. train full-width Qwen3-1.7B (bf16 compute, fp32 masters, ``--sell acdc
   --sell-method pallas``, global batch 4 x 128 tokens) through the train
   launcher's functions: one warm-up and two timed AdamW steps with an
   exact ``scaled_matmul`` launch count, a finite loss, s/step, tokens/s
   and peak memory; one step's loss and grads against the plain versions
   (bf16 reported, fp32 held to a limit) and a faulty backward (d dropped
   from dh1) that must read over it;
7. train the smoke width (fp32) with K=2 and K=1, 5 steps each, losses
   against the plain versions, ``acdc_cascade_bwd`` / ``acdc_bwd`` launched
   12 times a step, and a checkpoint-and-resume run that continues the
   uninterrupted one;
8. print ``{"kernels": [...]}`` (six kernels), then the final
   ``{"ok": true, "device": {...}}`` line.

Details go to ``chiprun_out/chip_smoke.json``.  Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32
#: (non-tensor-core) FLOP/s, and dense TF32 tensor-core FLOP/s (the
#: 3xTF32 regime of scaled_matmul runs three TF32 products per fp32 one)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12

#: the H100's L2 is 50 MB: a write of this many bytes between two timed
#: launches evicts what the first left there
L2_FLUSH_BYTES = 128 * 2 ** 20

#: logits of the full-width model, kernels vs plain versions on the card.
#: Both round to bf16 at the same places but sum in fp32 in other orders,
#: so a bf16 rounding can flip by one ulp (2^-8 relative); with random
#: weights the residual stream grows to max |x| ~ 1.6e4 over 28 layers
#: (``residual_by_layer`` in the report) and such flips compound.  The
#: bound on the relative L2 error of the logits is checked to sit above
#: what the fp32 orders give and below a faulty path that drops the
#: diagonals (``compare_full_width_logits``)
BF16_LOGIT_REL_L2 = 0.1

#: one full-width train step's gradients, kernels vs plain versions on the
#: card, relative L2 per parameter group, held in fp32 compute.  In bf16
#: compute the random-init gradient is chaotic: one-ulp bf16 flips between
#: the two sides move it by 0.16-0.21 while a backward that drops d from
#: dh1 moves it by 0.21-0.33 (measured on an H100 80GB HBM3 at 700 W),
#: so no bf16 limit tells a fault from rounding; those readings are
#: reported only.  In fp32 the two sides differ by summation order alone (~1e-7 a
#: sum), amplified ~50x as the bf16 noise is (4e-3 -> 0.2), i.e. ~1e-5;
#: the limit leaves 100x above that, and the faulty control must read
#: over it
FP32_GRAD_REL_L2 = 1e-3

#: smoke-width training in fp32, kernels vs plain versions: per-step loss
#: relative difference.  Every product is fp32 on both sides in other
#: summation orders (~1e-6 relative per op); five AdamW steps amplify
#: that, so the bound sits well above it and far below a real fault
FP32_LOSS_RTOL = 1e-4


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


#: GPU clock cycles of the ``torch.cuda._sleep`` preamble of
#: :func:`device_ms` (~10 ms at the H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 20_000_000


def device_ms(fn, reps: int = 20, warmup: int = 3):
    """``(device ms, host us)`` a call of ``fn``: the ``reps`` calls are
    queued behind a ``torch.cuda._sleep`` preamble, so the events between
    them time the device alone, back to back, however slowly the host
    enqueues them; the host's enqueue time a call is returned beside it.
    The preamble doubles until it outlasts the enqueue."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        # the sleep lasted cycles / 2e9 s at most; the enqueue must end
        # well inside it, or the device idled between calls
        if host_s < 0.5 * cycles / 2.0e9 or cycles >= 64 * SLEEP_CYCLES:
            return start.elapsed_time(end) / reps, host_s / reps * 1e6
        cycles *= 4


def time_cold_ms(fn, reps: int = 10) -> float:
    """Median device time of single launches of ``fn``, each after an
    ``L2_FLUSH_BYTES`` write, so ``fn`` finds its inputs in HBM as a
    caller that touched other data in between does (and drains the
    write's dirty lines from L2 as it runs)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def bound_ms(nbytes: float, flops: float, flop_s: float = FP32_FLOP_S):
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = flops / flop_s * 1e3
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

    from repro_torch.kernels import paged_attn as pa_mod
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(1234)
    results = {"scaled_matmul": [], "acdc_cascade": [], "acdc_fused": [],
               "paged_attn": [], "acdc_bwd": [], "acdc_cascade_bwd": []}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    sweep = check_scaled_matmul(dev, randn, results)

    check_cascade_forward(dev, randn, results)

    check_paged_attn(dev, randn, results)
    return results, check_backward_kernels(dev, randn, results), sweep


#: paged attention rows: qwen3 heads (16 q / 8 kv, Dh 128), 16-token
#: pages, bf16 pools.  (label, slots, position of each, T): the main
#: path's decode and verify rows (4 slots at ragged positions, one
#: parked, tables of 6 pages: the full-width paged server's 81-token
#: rows), then the long rows a - d, each streaming the same 67.1 MB of
#: K/V at another parallelism
PAGED_ROWS = (("main T=1", 4, None, 1), ("main T=5", 4, None, 5),
              ("a", 4, 4096, 1), ("b", 16, 1024, 1), ("c", 1, 16384, 1),
              ("d", 4, 4096, 5))


def paged_case(dev, randn, bsz, length, t, dtype=None, seed=0):
    """Inputs of one paged row: q, new k/v, pools, tables, positions.
    ``length`` None: the main path's 6-page tables, slot 0's tail
    unmapped beyond its frontier, positions 5, 37, 63 - T and parked;
    else every slot at ``length`` with just enough pages, its pages
    scattered over the pool as an allocator leaves them."""
    import torch

    dtype = dtype or torch.bfloat16
    hq, hkv, dh, bs = 16, 8, 128, 16
    mb = 6 if length is None else -(-(length + t) // bs)
    nb = bsz * mb
    if length is None:
        tables = torch.arange(nb, dtype=torch.int32,
                              device=dev).reshape(bsz, mb)
        tables[0, 3:] = -1          # unmapped tail beyond the frontier
        positions = torch.tensor([5, 37, 63 - t, mb * bs],
                                 dtype=torch.int32, device=dev)
    else:
        gen = torch.Generator().manual_seed(seed)
        tables = torch.randperm(nb, generator=gen).to(
            device=dev, dtype=torch.int32).reshape(bsz, mb)
        positions = torch.full((bsz,), length, dtype=torch.int32,
                               device=dev)
    q = randn(bsz, t, hq, dh, dtype=dtype)
    kn = randn(bsz, t, hkv, dh, dtype=dtype)
    vn = randn(bsz, t, hkv, dh, dtype=dtype)
    kp = randn(nb + 1, bs, hkv, dh, dtype=dtype)
    vp = randn(nb + 1, bs, hkv, dh, dtype=dtype)
    return q, kn, vn, kp, vp, tables, positions


def paged_bytes_flops(q, kp, tables, positions):
    """Bytes a paged call must move (q in, out, new K/V in and written,
    the streamed prefix's K/V read once) and its flops (q.k and p.v over
    every attended key)."""
    bsz, t, hq, dh = q.shape
    hkv, bs, item = kp.shape[2], kp.shape[1], kp.element_size()
    virtual = tables.shape[1] * bs
    pos = [int(p) for p in positions.tolist()]
    streamed = sum(p for p in pos if p < virtual)
    attended = sum((p if p < virtual else 0) + t for p in pos)
    nbytes = (2 * bsz * t * hq * dh * item        # q in, out
              + 4 * bsz * t * hkv * dh * item     # new k/v in, written
              + 2 * streamed * hkv * dh * item)   # streamed k/v
    return nbytes, 4.0 * attended * t * hq * dh, 2 * streamed * hkv * dh * item


def sdpa_library(q, kp, vp, tables, positions, kn, vn):
    """One ``scaled_dot_product_attention`` call over a contiguous cache
    holding the same keys and values as the paged call (prefix plus the
    new token; T = 1, every slot at one position), ``enable_gqa``, no
    mask: the library's time for the attention without the paging.
    Returns (the call, its inputs gathered outside it)."""
    import torch
    import torch.nn.functional as F

    bsz, t, hq, dh = q.shape
    bs = kp.shape[1]
    length = int(positions[0])
    kpos = torch.arange(length, device=q.device)
    pages = tables.long()[:, kpos // bs]                  # (B, L)
    kc = torch.cat([kp[pages, kpos % bs], kn], dim=1)     # (B, L+1, Hkv, Dh)
    vc = torch.cat([vp[pages, kpos % bs], vn], dim=1)
    qs = q.transpose(1, 2).contiguous()                   # (B, Hq, 1, Dh)
    kc = kc.transpose(1, 2).contiguous()
    vc = vc.transpose(1, 2).contiguous()

    def call():
        return F.scaled_dot_product_attention(qs, kc, vc, enable_gqa=True)

    return call


def check_paged_attn(dev, randn, results):
    """paged_attn at ``PAGED_ROWS``: against the plain version (every row,
    the parked one too; pool writes equal, trash page excluded), timed by
    device time beside the call time and the host's us a call, the main
    rows also with L2 flushed (the long rows' 67 MB exceed the 50 MB L2),
    the T = 1 long rows beside one SDPA call over a contiguous cache."""
    import torch

    from repro_torch.kernels import paged_attn as pa_mod
    from repro_torch.kernels import ref

    for label, bsz, length, t in PAGED_ROWS:
        q, kn, vn, kp, vp, tables, positions = paged_case(
            dev, randn, bsz, length, t)
        kp2, vp2 = kp.clone(), vp.clone()

        def kernel():
            return pa_mod.paged_attention(q, kn, vn, kp, vp, tables,
                                          positions, 0, softcap=0.0)

        def plain():
            return ref.paged_attention_ref(q, kn, vn, kp2, vp2, tables,
                                           positions, 0, 0.0)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        shape = (f"{label}: B={bsz} T={t} pos="
                 f"{'5/37/' + str(63 - t) + '/parked' if length is None else length}"
                 f" Hq=16 Hkv=8 Dh=128 bs=16 bf16")
        # bf16 output: fp32 online softmax in another order than the
        # plain version's softmax; one bf16 ulp of |out| <= ~4.  Every
        # row is held, the parked one (which attends to its new tokens
        # only) too
        if not rel_close(got, want, rtol=2 ** -7, atol=2e-2):
            _fail(f"paged_attn {shape}: max err {max_err(got, want)}")
        # the page writes must be the same writes (trash page excluded:
        # parked rows race to it by design and nothing reads it)
        if not (torch.equal(kp[:-1], kp2[:-1])
                and torch.equal(vp[:-1], vp2[:-1])):
            _fail(f"paged_attn {shape}: pool writes differ")
        if not torch.equal(got, kernel()):
            _fail(f"paged_attn {shape}: two runs differ in bits")
        nbytes, flops, streamed = paged_bytes_flops(q, kp, tables,
                                                    positions)
        b, by = bound_ms(nbytes, flops)
        ms, host_us = device_ms(kernel)
        pms, phost_us = device_ms(plain, reps=3, warmup=1)
        row = dict(shape=shape, max_abs_err=max_err(got, want), ms=ms,
                   host_us=host_us, call_ms=time_ms(kernel), plain_ms=pms,
                   plain_host_us=phost_us, library_ms=None, bound_ms=b,
                   bound_by=by, bytes=nbytes, streamed_bytes=streamed,
                   bitwise_repeat=True)
        row["plan"] = dataclasses.asdict(pa_mod.plan_of(q, kp, tables))
        if length is None:
            row["ms_cold"] = time_cold_ms(kernel)
        elif t == 1:
            lib = sdpa_library(q, kp, vp, tables, positions, kn, vn)
            row["library_ms"] = device_ms(lib)[0]
            row["library_max_abs_err"] = max_err(
                lib().transpose(1, 2), got)
        results["paged_attn"].append(row)
        print(f"[paged_attn] {shape}: device {ms:.4f} ms ({host_us:.1f} us "
              f"host), call {row['call_ms']:.4f}, bound {b:.4f} ({by}), "
              f"{streamed / ms / 1e6:.0f} GB/s streamed"
              + (f", L2 flushed {row['ms_cold']:.4f}" if "ms_cold" in row
                 else "")
              + f"; plain {pms:.4f}; library {row['library_ms']}",
              flush=True)
        del q, kn, vn, kp, vp, kp2, vp2
        torch.cuda.empty_cache()


def cascade_fp64(x, a, d, bias, c, ct, ct_mid, relu=False):
    """The order-K cascade of ``ref.acdc_cascade_ref`` in fp64: each
    side's fp32 drift is measured against it."""
    k = a.shape[0]
    h, c64, ct64 = x.double(), c.double(), ct.double()
    mid = ct64 if ct_mid is None else ct_mid.double()
    for i in range(k):
        h = ((h * a[i].double()) @ c64) * d[i].double()
        if bias is not None:
            h = h + bias[i].double()
        h = h @ (ct64 if i == k - 1 else mid)
        if relu and i < k - 1:
            h = h.clamp_min(0.0)
    return h


def cascade_bwd_fp64(x, g, a, d, bias, c, ct, ct_mid, relu=False):
    """``ref.acdc_cascade_bwd_ref`` in fp64: (dx, da, dd, db)."""
    import torch

    k, n = a.shape
    c64, ct64 = c.double(), ct.double()
    mid = ct64 if ct_mid is None else ct_mid.double()
    a64, d64 = a.double(), d.double()
    xf = x.double()
    stash, h = [], xf
    for i in range(k - 1):
        h3 = ((h * a64[i]) @ c64) * d64[i]
        if bias is not None:
            h3 = h3 + bias[i].double()
        h = h3 @ mid
        if relu:
            h = h.clamp_min(0.0)
        stash.append(h)
    da = torch.zeros((k, n), dtype=torch.float64, device=x.device)
    dd, db = torch.zeros_like(da), torch.zeros_like(da)
    gcur = g.double()
    for i in range(k - 1, -1, -1):
        h_i = stash[i - 1] if i > 0 else xf
        if i < k - 1 and relu:
            gcur = torch.where(stash[i] > 0, gcur, torch.zeros_like(gcur))
        gc = gcur @ c64 if (i == k - 1 or ct_mid is None) else gcur @ mid.T
        db[i] = gc.sum(0)
        dd[i] = (((h_i * a64[i]) @ c64) * gc).sum(0)
        dh1 = (gc * d64[i]) @ ct64
        da[i] = (h_i * dh1).sum(0)
        gcur = a64[i] * dh1
    return gcur, da, dd, (db if bias is not None else None)


def composed_matrix(a, d, c, ct, ct_mid):
    """The dense N x N matrix of a cascade without ReLU (fp64, rounded to
    fp32): ``x @ W`` is the cascade's function without bias, the paper's
    yardstick of a dense layer of the same width."""
    k = a.shape[0]
    c64, ct64 = c.double(), ct.double()
    mid = ct64 if ct_mid is None else ct_mid.double()
    w = None
    for i in range(k):
        layer = (a[i].double()[:, None] * c64 * d[i].double()[None, :]) \
            @ (ct64 if i == k - 1 else mid)
        w = layer if w is None else w @ layer
    return w.float()


def drift(got, want64) -> float:
    """max |got - want| / max |want| (0 for an all-zero want)."""
    scale = float(want64.abs().max())
    return float((got.double() - want64).abs().max()) / scale \
        if scale > 0 else 0.0


def grads_drift(got, want64) -> float:
    """:func:`drift` over (dx, da, dd, db), the worst of them."""
    return max(drift(u, w) for u, w in zip(got, want64)
               if u is not None and w is not None)


def timed_row(shape, p, clusters, fn, plain, library, got, want, err,
              nbytes, flops, extra=None):
    """One kernels row: device time of kernel / plain / library (ms, with
    the host's enqueue us a call), the call time back to back as PR 13
    timed it, and the bound."""
    ms, host_us = device_ms(fn)
    pms, phost_us = device_ms(plain)
    b, by = bound_ms(nbytes, flops)
    row = dict(shape=shape, plan=dataclasses.asdict(p),
               max_clusters=clusters, max_abs_err=max_err(got, want),
               ms=ms, host_us=host_us, call_ms=time_ms(fn), plain_ms=pms,
               plain_host_us=phost_us, plain_call_ms=time_ms(plain),
               library_ms=None if library is None else device_ms(
                   library)[0],
               bound_ms=b, bound_by=by, fp32_err_vs_fp64=err,
               bitwise_repeat=True)
    row.update(extra or {})
    return row


def fp32_gate(name, label, err):
    if not err["kernel"] <= 2 * err["plain"]:
        _fail(f"{name} {label}: fp32 error vs fp64 {err['kernel']} > 2 x "
              f"the plain version's {err['plain']}")


def check_cascade_forward(dev, randn, results):
    """acdc_cascade (K=2 with the riffle, fp32 as the smoke model) at N =
    128 / 256 (smoke attn_out / mlp) and 1024 (the largest N the fused
    route takes), M = 4 (decode) and 64 (prefill), plus the smoke train
    step's M = 256 at N = 256 and M = 512 at N = 1024; acdc_fused (the
    K=1 kernel) at N = 256, M = 4 / 64, with and without bias.  Each
    against its plain version, repeated for identical bits, its fp32
    error against an fp64 cascade within 2 x the plain version's, timed
    by device time beside the library call: one fp32 ``torch.matmul`` of
    x with the cascade's composed N x N matrix (``addmm`` with a bias)."""
    import torch

    from repro_torch.core import families
    from repro_torch.kernels import acdc_cascade_fused as cascade_mod
    from repro_torch.kernels import acdc_fused as fused_mod
    from repro_torch.kernels import ref

    fam = families.get_family("acdc")
    shapes = [(m, n) for n in (128, 256, 1024) for m in (4, 64)]
    shapes += [(256, 256), (512, 1024)]
    for m, n in shapes:
        c, ct = fam.matrices(n, torch.float32, dev)
        perm = torch.as_tensor(fam.riffle(n), dtype=torch.long, device=dev)
        ct_mid = ct[:, perm].contiguous()
        x = randn(m, n)
        a = 1.0 + 0.061 * randn(2, n)
        d = 1.0 + 0.061 * randn(2, n)
        label = f"M={m} N={n} K=2 riffle fp32"

        def kernel():
            return cascade_mod.acdc_cascade(x, a, d, None, c, ct, ct_mid)

        def plain():
            return ref.acdc_cascade_ref(x, a, d, None, c, ct, ct_mid)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not rel_close(got, want, rtol=1e-3, atol=2e-4):
            _fail(f"acdc_cascade {label}: max err {max_err(got, want)}")
        if not torch.equal(got, kernel()):
            _fail(f"acdc_cascade {label}: two runs differ in bits")
        y64 = cascade_fp64(x, a, d, None, c, ct, ct_mid)
        err = {"kernel": drift(got, y64), "plain": drift(want, y64)}
        fp32_gate("acdc_cascade", label, err)
        w = composed_matrix(a, d, c, ct, ct_mid)
        p = cascade_mod.plan(m, n, 2, True)
        results["acdc_cascade"].append(timed_row(
            label, p, cascade_mod.max_clusters(p, m, 2, True), kernel,
            plain, lambda: torch.matmul(x, w), got, want, err,
            2 * m * n * 4 + 2 * 2 * n * 4 + 3 * n * n * 4,
            2 * 4.0 * m * n * n))

    n = 256
    c, ct = fam.matrices(n, torch.float32, dev)
    for m in (4, 64):
        for with_bias in (False, True):
            x = randn(m, n)
            a = 1.0 + 0.061 * randn(n)
            d = 1.0 + 0.061 * randn(n)
            bias = 0.1 * randn(n) if with_bias else None
            b2 = None if bias is None else bias[None]
            label = f"M={m} N={n} bias={with_bias} fp32"

            def kernel():
                return fused_mod.acdc_fused(x, a, d, bias, c, ct)

            def plain():
                return ref.acdc_cascade_ref(x, a[None], d[None], b2, c, ct,
                                            None)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if not rel_close(got, want, rtol=1e-3, atol=2e-4):
                _fail(f"acdc_fused {label}: max err {max_err(got, want)}")
            if not torch.equal(got, kernel()):
                _fail(f"acdc_fused {label}: two runs differ in bits")
            y64 = cascade_fp64(x, a[None], d[None], b2, c, ct, None)
            err = {"kernel": drift(got, y64), "plain": drift(want, y64)}
            fp32_gate("acdc_fused", label, err)
            w = composed_matrix(a[None], d[None], c, ct, None)
            bvec = None if bias is None else (bias.double()
                                              @ ct.double()).float()

            def library():
                return (torch.matmul(x, w) if bvec is None
                        else torch.addmm(bvec, x, w))

            p = cascade_mod.plan(m, n, 1, False)
            results["acdc_fused"].append(timed_row(
                label, p, cascade_mod.max_clusters(p, m, 1, False), kernel,
                plain, library, got, want, err,
                2 * m * n * 4 + (3 if with_bias else 2) * n * 4
                + 2 * n * n * 4, 4.0 * m * n * n))


def check_scaled_matmul(dev, randn, results):
    """scaled_matmul at the main path's shapes: the two-call layer's
    products at N = 2048 (attn_out) and 6144 (mlp) with bf16 x at M = 4
    (decode, 4 slots), 16 (the weight stream's largest M) and 64 (the
    prefill window), and the two-call backward's three fp32 products at
    the full-width training M = 512.  Each against its plain version, run
    twice for identical bits, its fp32 error against fp64 held within
    2 x the plain version's (cuBLAS fp32), and timed warm and with L2
    flushed; then both regimes timed at M = 4, 16, 32, 64 (N = 6144), the
    times that set ``STREAM_MAX_M``."""
    import torch

    from repro_torch.core import families
    from repro_torch.kernels import ref
    from repro_torch.kernels import scaled_matmul as smm_mod

    fam = families.get_family("acdc")

    def fp32_err(fn, x, w, pre, y64, scale):
        return float((fn(x, w, pre=pre).double() - y64).abs().max()) / scale

    def gate(label, err, bits_same):
        if not err["kernel"] <= 2 * err["plain"]:
            _fail(f"scaled_matmul {label}: fp32 error vs fp64 {err['kernel']}"
                  f" > 2 x the plain version's {err['plain']}")
        if not bits_same:
            _fail(f"scaled_matmul {label}: two runs differ in bits")

    def row(label, p, m, n, nbytes, flops, fn, plain, library, err, got,
            want, reps=20):
        simt, simt_by = bound_ms(nbytes, flops)
        tc, tc_by = bound_ms(nbytes, 3 * flops, TF32_FLOP_S)
        own, own_by = (tc, tc_by) if p.regime == "tc" else (simt, simt_by)
        return dict(
            shape=label, plan=dataclasses.asdict(p),
            max_abs_err=max_err(got, want), ms=time_ms(fn, reps=reps),
            ms_cold=time_cold_ms(fn), plain_ms=time_ms(plain, reps=reps),
            plain_ms_cold=time_cold_ms(plain),
            library_ms=time_ms(library, reps=reps),
            library_ms_cold=time_cold_ms(library), bound_ms=own,
            bound_by=own_by, bound_simt_ms=simt, bound_tc_ms=tc,
            bound_tc_by=tc_by, fp32_err_vs_fp64=err, bitwise_repeat=True)

    for n in (2048, 6144):
        c, ct = fam.matrices(n, torch.float32, dev)
        for m in (4, 16, 64):
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
            err = {side: fp32_err(fn, xf, c, pre, y64, scale)
                   for side, fn in (("kernel", smm_mod.scaled_matmul),
                                    ("plain", ref.scaled_matmul_ref))}
            label = f"M={m} K=N={n} bf16 x"
            gate(label, err, torch.equal(
                got, smm_mod.scaled_matmul(x, c, pre=pre)))
            results["scaled_matmul"].append(row(
                label, smm_mod.plan(m, n, n, x.dtype), m, n,
                m * n * 2 + n * n * 4 + n * 4 + m * n * 2, 2.0 * m * n * n,
                lambda: smm_mod.scaled_matmul(x, c, pre=pre),
                lambda: ref.scaled_matmul_ref(x, c, pre=pre),
                lambda: torch.matmul(xf, c), err, got, want))

        # the two-call backward at the full-width training shape: three
        # fp32 launches (gc = g C, h2 = (x a) C, dh1 = (gc d) C^T)
        m = 512
        x, g = randn(m, n), randn(m, n)
        a, d = 1.0 + 0.061 * randn(n), 1.0 + 0.061 * randn(n)

        def three(fn):
            gc = fn(g, c)
            fn(x, c, pre=a)
            return fn(gc, ct, pre=d)

        def three_library():
            gc = torch.matmul(g, c)
            torch.matmul(x * a, c)
            return torch.matmul(gc * d, ct)

        got, want = three(smm_mod.scaled_matmul), three(ref.scaled_matmul_ref)
        torch.cuda.synchronize()
        label = f"M={m} K=N={n} fp32, x3 (two-call backward)"
        if not rel_close(got, want, rtol=1e-3, atol=2e-4 * float(
                want.abs().max())):
            _fail(f"scaled_matmul {label}: max err {max_err(got, want)}")
        y64 = (x.double() * a.double()) @ c.double()
        scale = float(y64.abs().max())
        err = {side: fp32_err(fn, x, c, a, y64, scale)
               for side, fn in (("kernel", smm_mod.scaled_matmul),
                                ("plain", ref.scaled_matmul_ref))}
        gate(label, err, torch.equal(got, three(smm_mod.scaled_matmul)))
        results["scaled_matmul"].append(row(
            label, smm_mod.plan(m, n, n, x.dtype), m, n,
            3 * (m * n * 4 + n * n * 4 + m * n * 4) + 2 * n * 4,
            3 * 2.0 * m * n * n, lambda: three(smm_mod.scaled_matmul),
            lambda: three(ref.scaled_matmul_ref), three_library, err, got,
            want, reps=5))

    # the regime boundary: both designs at M = 4 .. 64, N = 6144, bf16 x
    n = 6144
    c, _ = fam.matrices(n, torch.float32, dev)
    pre = 1.0 + 0.061 * randn(n)
    sweep = []
    for m in (4, 16, 32, 64):
        x = randn(m, n, dtype=torch.bfloat16)
        entry = dict(m=m, n=n, stream_max_m=smm_mod.STREAM_MAX_M)
        for name, planner in (("stream", smm_mod.plan_stream),
                              ("tc", smm_mod.plan_tc)):
            p = planner(m, n, n, x.dtype)

            def run():
                return smm_mod.launch(x, c, pre, None, None, p)

            entry[name] = dict(plan=dataclasses.asdict(p), ms=time_ms(run),
                               ms_cold=time_cold_ms(run))
        sweep.append(entry)
        print(f"[regime] M={m} N={n}: stream {entry['stream']['ms']:.4f} / "
              f"{entry['stream']['ms_cold']:.4f} ms, tensor cores "
              f"{entry['tc']['ms']:.4f} / {entry['tc']['ms_cold']:.4f} ms "
              f"(warm / L2 flushed)", flush=True)
    return sweep


def _grads_err(got, want):
    """max |got - want| over (dx, da, dd, db), and whether every one is
    within tolerance: dx at fp32 atol 2e-4 / rtol 1e-3; the diagonal
    grads are fp32 row sums over M, held with atol relative to their
    largest entry."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        if g is None or w is None:
            ok &= g is None and w is None
            continue
        err = max(err, max_err(g, w))
        scale = max(float(w.float().abs().max()), 1.0)
        ok &= rel_close(g, w, rtol=1e-3, atol=2e-4 * scale)
    return err, ok


def _same_bits(a, b) -> bool:
    import torch

    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def relu_margin_input(z, a0, d0, b0, c, mid):
    """x whose first-layer output ((x a0) C d0 + b0) mid equals ``z``,
    solved in fp64 through the orthogonal C and mid.  With z drawn at
    least a margin from 0, the ReLU mask after layer 0 cannot flip between
    the kernel and the plain version, whose fp32 sums run in other orders:
    a flip changes one cotangent element by its whole value, a real
    difference of the two computations that no tolerance tells from a
    fault."""
    h = z.double() @ mid.double().T
    if b0 is not None:
        h = h - b0.double()
    return ((h / d0.double()) @ c.double().T / a0.double()).float()


def margin_draw(randn, m, n, margin=0.05):
    """(M, N) normal draws pushed at least ``margin`` away from 0."""
    u = randn(m, n)
    return u.sign() * (margin + u.abs())


def check_acdc_bwd(dev, randn, results):
    """acdc_bwd at the smoke K=1 train step's shapes (M = 256, N = 128 /
    256), ragged M with bias, and N = 1024 at the full-width M = 512:
    against its plain version, bitwise on a repeat, its fp32 error against
    fp64 gradients within 2 x the plain version's; timed by device time
    beside the call time, the host's us a call and with L2 flushed."""
    import torch

    from repro_torch.core import families
    from repro_torch.kernels import acdc_bwd as bwd_mod
    from repro_torch.kernels import ref

    fam = families.get_family("acdc")
    for m, n, bias in ((256, 128, False), (256, 256, False),
                       (37, 256, True), (512, 1024, False)):
        c, ct = fam.matrices(n, torch.float32, dev)
        x, g = randn(m, n), randn(m, n)
        a, d = 1.0 + 0.061 * randn(n), 1.0 + 0.061 * randn(n)
        label = f"M={m} N={n} bias={bias} fp32"

        def kernel():
            return bwd_mod.acdc_bwd(x, g, a, d, c, ct, with_bias=bias)

        def plain():
            return ref.acdc_bwd_ref(x, g, a, d, c, ct, bias)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = _grads_err(got, want)
        if not ok:
            _fail(f"acdc_bwd {label}: max err {err}")
        if not _same_bits(got, kernel()):
            _fail(f"acdc_bwd {label}: two runs differ in bits")
        # one layer is the K = 1 cascade: its fp64 gradients (db from a
        # zero bias, whose value the backward never reads)
        bb = torch.zeros(1, n, device=dev) if bias else None
        w64 = cascade_bwd_fp64(x, g, a[None], d[None], bb, c, ct, None)
        w64 = (w64[0], w64[1][0], w64[2][0],
               None if w64[3] is None else w64[3][0])
        ferr = {"kernel": grads_drift(got, w64),
                "plain": grads_drift(want, w64)}
        fp32_gate("acdc_bwd", label, ferr)
        nbytes = 3 * m * n * 4 + 2 * n * 4 + 2 * n * n * 4 \
            + (3 if bias else 2) * n * 4
        b, by = bound_ms(nbytes, 6.0 * m * n * n)
        ms, host_us = device_ms(kernel)
        pms, phost_us = device_ms(plain)
        row = dict(shape=label, max_abs_err=err, ms=ms, host_us=host_us,
                   call_ms=time_ms(kernel), ms_cold=time_cold_ms(kernel),
                   plain_ms=pms, plain_host_us=phost_us,
                   plain_ms_cold=time_cold_ms(plain), library_ms=None,
                   bound_ms=b, bound_by=by, fp32_err_vs_fp64=ferr,
                   bitwise_repeat=True)
        row["plan"] = dataclasses.asdict(bwd_mod.plan(m, n))
        results["acdc_bwd"].append(row)
        print(f"[acdc_bwd] {label}: device {ms:.4f} ms ({host_us:.1f} us "
              f"host), call {row['call_ms']:.4f}, L2 flushed "
              f"{row['ms_cold']:.4f}; plain {pms:.4f} (flushed "
              f"{row['plain_ms_cold']:.4f}); bound {b:.4f} ({by}); fp32 err "
              f"vs fp64 {ferr['kernel']:.2e} (plain {ferr['plain']:.2e})",
              flush=True)


def check_backward_kernels(dev, randn, results):
    """acdc_bwd and acdc_cascade_bwd against their plain versions at the
    smoke train step's shapes (M = 4 x 64 rows, N = 128 / 256, K = 2 with
    the riffle, bias and ReLU on and off, ragged M; K = 3) and at N = 1024
    with the full-width step's M = 512; each run twice for identical bits.
    A ReLU cascade gets inputs from ``relu_margin_input`` (K = 2).
    Then the per-layer cascade backward on the card (N = 1024, K = 24:
    only the backward gate fails; its report is returned)."""
    import torch

    from repro_torch.core import families
    from repro_torch.kernels import acdc_bwd as bwd_mod
    from repro_torch.kernels import acdc_cascade_bwd as cbwd_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    fam = families.get_family("acdc")
    check_acdc_bwd(dev, randn, results)
    for m, n, k, relu, bias in ((256, 128, 2, False, False),
                                (256, 256, 2, False, False),
                                (37, 256, 2, True, True),
                                (256, 256, 3, False, False),
                                (512, 1024, 2, False, False)):
        c, ct = fam.matrices(n, torch.float32, dev)
        perm = torch.as_tensor(fam.riffle(n), dtype=torch.long, device=dev)
        ct_mid = ct[:, perm].contiguous()
        x, g = randn(m, n), randn(m, n)
        a, d = 1.0 + 0.061 * randn(k, n), 1.0 + 0.061 * randn(k, n)
        bb = 0.1 * randn(k, n) if bias else None
        if relu:
            x = relu_margin_input(margin_draw(randn, m, n), a[0], d[0],
                                  None if bb is None else bb[0], c, ct_mid)
        label = f"M={m} N={n} K={k} riffle relu={relu} bias={bias} fp32"

        def kernel():
            return cbwd_mod.acdc_cascade_bwd(x, g, a, d, bb, c, ct, ct_mid,
                                             relu=relu)

        def plain():
            return ref.acdc_cascade_bwd_ref(x, g, a, d, bb, c, ct, ct_mid,
                                            relu)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = _grads_err(got, want)
        if not ok:
            _fail(f"acdc_cascade_bwd M={m} N={n} K={k}: max err {err}")
        if not _same_bits(got, kernel()):
            _fail(f"acdc_cascade_bwd M={m} N={n}: two runs differ in bits")
        w64 = cascade_bwd_fp64(x, g, a, d, bb, c, ct, ct_mid, relu)
        ferr = {"kernel": grads_drift(got, w64),
                "plain": grads_drift(want, w64)}
        fp32_gate("acdc_cascade_bwd", label, ferr)
        p = cbwd_mod.plan_bwd(m, n, k, True)
        stash_shape, part_shape = cbwd_mod.workspaces(p, m, n, k)
        diags = 3 if bias else 2
        row = timed_row(
            label, p, cbwd_mod.max_clusters(p, m, k, True), kernel, plain,
            None, got[0], want[0], ferr,
            3 * m * n * 4 + 2 * diags * k * n * 4 + 3 * n * n * 4,
            2.0 * m * n * n * (5 * k - 2),
            dict(workspace_bytes=4 * (math.prod(stash_shape or (0,))
                                      + math.prod(part_shape))))
        row["max_abs_err"] = err
        results["acdc_cascade_bwd"].append(row)

    # the per-layer cascade backward where only the backward gate fails
    # (no ReLU: 23 masks of 64 x 1024 could flip, see relu_margin_input)
    n, k = 1024, 24
    if not (ops.cascade_fits(n, k, permute=True, bias=False)
            and not ops.cascade_bwd_fits(n, k, permute=True, bias=False)):
        _fail("N=1024 K=24 no longer splits the forward and backward gates")
    leaves = [randn(64, n), 1.0 + 0.061 * randn(k, n),
              1.0 + 0.061 * randn(k, n)]
    gy = randn(64, n)
    grads, counts = {}, {}
    for side in ("kernel", "plain"):
        ctx = plain_kernels if side == "plain" else contextlib.nullcontext
        with ctx():
            before = dict(ops.CASCADE_BWD_DISPATCHES)
            nb = bwd_mod.launches
            ts = [t.clone().requires_grad_() for t in leaves]
            ops.acdc_cascade_op(*ts, permute=True).backward(gy)
            grads[side] = [t.grad for t in ts]
            counts[side] = (ops.CASCADE_BWD_DISPATCHES["per_layer_scan"]
                            - before["per_layer_scan"],
                            bwd_mod.launches - nb)
    torch.cuda.synchronize()
    err, ok = _grads_err(grads["kernel"], grads["plain"])
    if not ok or counts["kernel"] != (1, k):
        _fail(f"per-layer cascade backward N={n} K={k}: max err {err}, "
              f"(per_layer_scan, acdc_bwd launches) {counts['kernel']}")
    per_layer = dict(
        shape=f"M=64 N={n} K={k} riffle fp32", max_abs_err=err,
        per_layer_scan=counts["kernel"][0], acdc_bwd_launches=k)

    return per_layer


# ---------------------------------------------------------------------------
# Phases 4-5: serving through the launcher's functions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version (so the same model
    code runs the plain path on the card) -- for comparisons only."""
    from repro_torch.kernels import acdc_bwd as bwd_mod
    from repro_torch.kernels import acdc_cascade_bwd as cbwd_mod
    from repro_torch.kernels import acdc_cascade_fused as cascade_mod
    from repro_torch.kernels import acdc_fused as fused_mod
    from repro_torch.kernels import paged_attn as pa_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import scaled_matmul as smm_mod

    saved = (smm_mod.scaled_matmul, fused_mod.acdc_fused,
             cascade_mod.acdc_cascade, pa_mod.paged_attention,
             bwd_mod.acdc_bwd, cbwd_mod.acdc_cascade_bwd)

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

    def bwd_plain(x, g, a, d, c, ct, with_bias=True):
        return ref.acdc_bwd_ref(x, g, a, d, c, ct, with_bias)

    def cascade_bwd_plain(x, g, a, d, bias, c, ct, ct_mid, relu=False):
        return ref.acdc_cascade_bwd_ref(x, g, a, d, bias, c, ct, ct_mid,
                                        relu)

    smm_mod.scaled_matmul = ref.scaled_matmul_ref
    fused_mod.acdc_fused = fused_plain
    cascade_mod.acdc_cascade = cascade_plain
    pa_mod.paged_attention = paged_plain
    bwd_mod.acdc_bwd = bwd_plain
    cbwd_mod.acdc_cascade_bwd = cascade_bwd_plain
    try:
        yield
    finally:
        (smm_mod.scaled_matmul, fused_mod.acdc_fused,
         cascade_mod.acdc_cascade, pa_mod.paged_attention,
         bwd_mod.acdc_bwd, cbwd_mod.acdc_cascade_bwd) = saved


KERNEL_MODULES = ("scaled_matmul", "acdc_cascade", "acdc_fused",
                  "paged_attn", "acdc_bwd", "acdc_cascade_bwd")


def _modules():
    from repro_torch.kernels import acdc_bwd, acdc_cascade_bwd
    from repro_torch.kernels import acdc_cascade_fused, acdc_fused
    from repro_torch.kernels import paged_attn, scaled_matmul

    return {"scaled_matmul": scaled_matmul,
            "acdc_cascade": acdc_cascade_fused,
            "acdc_fused": acdc_fused, "paged_attn": paged_attn,
            "acdc_bwd": acdc_bwd, "acdc_cascade_bwd": acdc_cascade_bwd}


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
def stream_regime_only():
    """The kernel path with scaled_matmul's weight stream at every M: as
    accurate a path as the kernel's own, summed in another order -- a
    control for how far the logits move on the order of the sums alone."""
    from repro_torch.kernels import scaled_matmul as smm_mod

    saved = smm_mod.plan
    smm_mod.plan = smm_mod.plan_stream
    try:
        yield
    finally:
        smm_mod.plan = saved


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
    faulty path that drops the diagonals; and, reported only, the kernel
    path with the weight stream at every M.  Then scaled_matmul's own fp32
    error on the prefill's first inputs (``real_input_errors``)."""
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

    # the kernel prefill's first scaled_matmul calls, inputs kept: each
    # side's fp32 error on the model's own activations (below)
    from repro_torch.kernels import scaled_matmul as smm_mod

    recorded = []
    kernel_fn = smm_mod.scaled_matmul

    def recording(x, w, pre=None, post=None, bias=None):
        if len(recorded) < REAL_INPUT_CALLS:
            recorded.append((x.float(), w, pre, post, bias))
        return kernel_fn(x, w, pre, post, bias)

    with scaled_matmul_as(recording):
        runs = {"kernel": run()}
    for name, ctx in (("plain", plain_kernels),
                      ("kernel_stream_only", stream_regime_only),
                      ("fp64", lambda: scaled_matmul_as(scaled_matmul_fp64)),
                      ("plain_tf32", plain_with_tf32),
                      ("no_diagonals",
                       lambda: scaled_matmul_as(scaled_matmul_without_pre))):
        with ctx():
            runs[name] = run()
    torch.cuda.synchronize()
    pairs = (("kernel", "plain"), ("kernel", "fp64"), ("plain", "fp64"),
             ("kernel_stream_only", "plain"), ("plain_tf32", "plain"),
             ("no_diagonals", "plain"))
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
    out["scaled_matmul_on_prefill_inputs"] = real_input_errors(recorded)
    return out


#: scaled_matmul calls of the full-width prefill whose inputs are kept
#: (layers 0-3: the 16 projections' two-call forwards)
REAL_INPUT_CALLS = 64


def real_input_errors(recorded) -> dict:
    """Each side's fp32 error against fp64 on the prefill's own
    scaled_matmul inputs (fp32 x, the bf16 rounding of h2 not applied):
    max |err| / max |y| and rel. L2, the median and the worst over the
    calls.  The kernel's worst must stay within 2 x cuBLAS fp32's, as on
    the random inputs of phase 3."""
    import statistics

    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import scaled_matmul as smm_mod

    if not recorded:
        _fail("the full-width prefill made no scaled_matmul call")
    errs = {"kernel": [], "plain": []}
    for x, w, pre, post, bias in recorded:
        y64 = scaled_matmul_fp64(x.double(), w, pre, post, bias)
        scale = float(y64.abs().max())
        for side, fn in (("kernel", smm_mod.scaled_matmul),
                         ("plain", ref.scaled_matmul_ref)):
            d = fn(x, w, pre, post, bias).double() - y64
            errs[side].append((float(d.abs().max()) / scale,
                               float(torch.linalg.vector_norm(d)
                                     / torch.linalg.vector_norm(y64))))
    out = {"calls": len(recorded)}
    for side, rows in errs.items():
        out[side] = {f"{stat}_{name}": fn(r[i] for r in rows)
                     for i, name in enumerate(("max_err", "rel_l2"))
                     for stat, fn in (("median", lambda v: statistics.median(
                         list(v))), ("worst", max))}
    print(f"[logits] scaled_matmul on the prefill's {len(recorded)} first "
          f"inputs, fp32 vs fp64: " + "; ".join(
              f"{side} rel L2 median {v['median_rel_l2']:.2e} worst "
              f"{v['worst_rel_l2']:.2e}, max err worst "
              f"{v['worst_max_err']:.2e}" for side, v in out.items()
              if side != "calls"), flush=True)
    if not (out["kernel"]["worst_max_err"]
            <= 2 * out["plain"]["worst_max_err"]):
        _fail("scaled_matmul on the prefill's inputs: fp32 error "
              f"{out['kernel']['worst_max_err']} > 2 x the plain version's "
              f"{out['plain']['worst_max_err']}")
    return out


# ---------------------------------------------------------------------------
# Phases 6-7: training through the train launcher's functions
# ---------------------------------------------------------------------------

#: parameter groups whose gradients are compared, by path regex
GRAD_GROUPS = (("sell/a", r"sell/a$"), ("sell/d", r"sell/d$"),
               ("dense w", r"/w$"), ("embed", r"^embed/"))


def group_rel_l2(got: dict, want: dict) -> dict:
    """Relative L2 distance of two gradient trees over each group of
    ``GRAD_GROUPS`` (the group's leaves taken as one vector)."""
    import torch

    from repro_torch.optim.optimizers import tree_flatten

    paths, g = tree_flatten(got)
    _, w = tree_flatten(want)
    out = {}
    for name, rx in GRAD_GROUPS:
        idx = [i for i, p in enumerate(paths) if re.search(rx, p)]
        if not idx:
            _fail(f"no parameter matches gradient group {name!r}")
        num = sum(float(torch.sum((g[i].double() - w[i].double()) ** 2))
                  for i in idx)
        den = sum(float(torch.sum(w[i].double() ** 2)) for i in idx)
        out[name] = math.sqrt(num / den)
    return out


@contextlib.contextmanager
def backward_without_d():
    """A deliberately faulty ACDC layer backward that drops d from
    dh1 = (gc * d) C^T: a control for the gradient limit."""
    import torch

    from repro_torch.kernels import ops

    saved = ops._layer_bwd

    def faulty(x2, a, d, g2, with_bias, family):
        return saved(x2, a, torch.ones_like(d), g2, with_bias, family)

    ops._layer_bwd = faulty
    try:
        yield
    finally:
        ops._layer_bwd = saved


def smm_launches_per_step(cfg) -> int:
    """scaled_matmul launches of one full-width train step: every SELL
    projection (attn_out and the three MLP ones per layer) is a per-layer
    cascade of K two-call ACDC layers (N > MAX_FUSED_N); each layer is 2
    launches forward, 2 more when remat recomputes the forward in the
    backward, and 3 in its backward (the two-call backward)."""
    acdc_layers = cfg.n_layers * 4 * cfg.sell_k
    return acdc_layers * (2 + (2 if cfg.remat else 0) + 3)


def compare_grads(model, cfg, params, batch) -> dict:
    """One step's loss and gradients with the kernels, the plain versions
    and the faulty backward, at ``cfg``'s compute dtype; rel. L2 per
    group against the plain versions."""
    import torch

    from repro_torch.dist import steps as steps_mod

    runs = {}
    for name, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", plain_kernels),
                      ("no_d_in_dh1", backward_without_d)):
        with ctx():
            runs[name] = steps_mod.loss_and_grads(model, cfg, params, batch)
    torch.cuda.synchronize()
    out = dict(loss_kernel=float(runs["kernel"][0]),
               loss_plain=float(runs["plain"][0]),
               rel_l2={f"{a}_vs_plain": group_rel_l2(runs[a][1],
                                                     runs["plain"][1])
                       for a in ("kernel", "no_d_in_dh1")})
    del runs
    torch.cuda.empty_cache()
    print(f"[grads] full width {cfg.dtype}, one step: loss kernel "
          f"{out['loss_kernel']:.6f} plain {out['loss_plain']:.6f} | rel L2 "
          + "; ".join(f"{k}: " + ", ".join(f"{g} {v:.3e}"
                                           for g, v in r.items())
                      for k, r in out["rel_l2"].items()), flush=True)
    return out


def train_full_width(dev, totals):
    """Full-width Qwen3-1.7B training: one step's loss and grads against
    the plain versions and a faulty control, then the main path, one
    warm-up and two timed AdamW steps with exact launch counts."""
    import torch

    from repro_torch.dist import steps as steps_mod
    from repro_torch.launch import train

    args = train.parse_args([
        "--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method", "pallas",
        "--global-batch", "4", "--seq-len", "128", "--steps", "3",
        "--device", str(dev)])
    cfg, model, opt, train_step, pipeline = train.build(args)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_state(model, cfg, opt, gen, dev)
    tokens = args.global_batch * args.seq_len
    batch = train.batch_on(pipeline, 0, dev)

    grads = {}
    for dtype in ("bfloat16", "float32"):
        grads[dtype] = compare_grads(model, dataclasses.replace(
            cfg, dtype=dtype), state["params"], batch)
    loss_k = grads["bfloat16"]["loss_kernel"]
    loss_p = grads["bfloat16"]["loss_plain"]
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p)
            <= 1e-2 * abs(loss_p)):
        _fail(f"full-width loss: kernel {loss_k} vs plain {loss_p}")
    rel = grads["float32"]["rel_l2"]
    worst = max(rel["kernel_vs_plain"].values())
    if not worst <= FP32_GRAD_REL_L2:
        _fail(f"full-width fp32 grads: rel L2 {worst} > {FP32_GRAD_REL_L2}")
    control = min(rel["no_d_in_dh1_vs_plain"].values())
    if not control > FP32_GRAD_REL_L2:
        _fail(f"full-width fp32 grads: the limit {FP32_GRAD_REL_L2} does "
              f"not catch the faulty backward (rel L2 {control})")

    want = smm_launches_per_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = []
    for step in range(args.steps):
        before = read_counts()
        t0 = time.perf_counter()
        state, metrics = train_step(state, train.batch_on(pipeline, step,
                                                          dev))
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        after = read_counts()
        delta = {k: after[k] - before[k] for k in after}
        loss = float(metrics["loss"])
        print(f"[train] full width step {step}: loss {loss:.4f} |g| "
              f"{float(metrics['grad_norm']):.3f} {dt:.3f}s | launches "
              f"{delta}", flush=True)
        if not math.isfinite(loss):
            _fail(f"full-width step {step}: loss {loss}")
        if delta["scaled_matmul"] != want or sum(delta.values()) != want:
            _fail(f"full-width step {step}: launches {delta}, want "
                  f"{want} scaled_matmul and nothing else")
        steps.append(dict(loss=loss, grad_norm=float(metrics["grad_norm"]),
                          s=dt, launches=delta))
    counts = read_counts()
    for name, n in counts.items():
        totals[name] += n
    timed = [st["s"] for st in steps[1:]]
    s_step = sum(timed) / len(timed)
    info = dict(config="qwen3_1_7b full width, bf16 compute, fp32 masters",
                global_batch=args.global_batch, seq_len=args.seq_len,
                steps=steps, s_per_step=s_step, tokens_per_s=tokens / s_step,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                smm_launches_per_step=want, launches=counts,
                grads=grads, fp32_limit_rel_l2=FP32_GRAD_REL_L2)
    print(f"[train] full width: {s_step:.3f} s/step, "
          f"{info['tokens_per_s']:.1f} tokens/s, peak "
          f"{info['peak_mem_gb']:.2f} GB, {want} scaled_matmul launches a "
          f"step", flush=True)
    del state
    torch.cuda.empty_cache()
    return info


def train_smoke(totals, device="cuda"):
    """Smoke-width training in fp32, K=2 and K=1, 5 steps each through the
    launcher's ``build``/``run``: losses against the plain versions, the
    backward kernel launched 12 times a step, and (K=2) a run cut after
    step 2 and resumed that continues the uninterrupted losses."""
    from repro_torch.launch import train

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    out = []
    for label, sell_k, kernel in (("smoke train K=2", 2, "acdc_cascade_bwd"),
                                  ("smoke train K=1", 1, "acdc_bwd")):
        def args_for(side, *extra):
            return train.parse_args([
                "--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
                "--sell-method", "pallas", "--global-batch", "4",
                "--seq-len", "64", "--steps", "5", "--log-every", "1",
                "--ckpt-every", "2", "--device", device, "--ckpt-dir",
                str(root / f"k{sell_k}_{side}"), *extra])

        args = args_for("kernel")
        pieces = train.build(args, sell_k=sell_k)
        reset_counts()
        _, hist = train.run(args, *pieces)
        counts = read_counts()
        want = 12 * args.steps
        if counts[kernel] != want:
            _fail(f"{label}: {kernel} launched {counts[kernel]} times, "
                  f"want {want} (12 a step)")
        for name, n in counts.items():
            totals[name] += n
        with plain_kernels():
            pargs = args_for("plain")
            _, plain = train.run(pargs, *train.build(pargs, sell_k=sell_k))
        rel = [abs(h["loss"] - p["loss"]) / abs(p["loss"])
               for h, p in zip(hist, plain)]
        if not max(rel) <= FP32_LOSS_RTOL:
            _fail(f"{label}: losses differ from the plain versions by "
                  f"{max(rel)} (limit {FP32_LOSS_RTOL})")
        info = dict(path=label, launches=counts,
                    losses=[h["loss"] for h in hist],
                    plain_losses=[p["loss"] for p in plain],
                    max_rel_loss_diff=max(rel),
                    ms_per_step=[h["ms"] for h in hist])
        if sell_k == 2:
            # cut the run after step 2 and resume it
            ckdir = root / "k2_kernel"
            for st in (4, 5):
                shutil.rmtree(ckdir / f"step_{st:010d}")
            rargs = args_for("kernel", "--resume")
            _, resumed = train.run(rargs, *train.build(rargs,
                                                       sell_k=sell_k))
            rrel = [abs(r["loss"] - h["loss"]) / abs(h["loss"])
                    for r, h in zip(resumed, hist[2:])]
            if len(resumed) != 3 or not max(rrel) <= FP32_LOSS_RTOL:
                _fail(f"{label}: the resumed run's losses {resumed} do not "
                      f"continue {hist[2:]}")
            info["resumed_losses"] = [r["loss"] for r in resumed]
            info["resume_max_rel_diff"] = max(rrel)
        print(f"[train] {label}: losses {info['losses']} | plain max rel "
              f"diff {info['max_rel_loss_diff']:.2e} | launches {counts}",
              flush=True)
        out.append(info)
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

    kern, per_layer, sweep = check_kernels(dev)
    for name, rows in kern.items():
        if name in ("paged_attn", "acdc_bwd"):
            continue    # printed as they were measured
        for r in rows:
            dev_t = (f" | device {r['ms']:.4f} ms ({r['host_us']:.1f} us "
                     f"host), call {r['call_ms']:.4f}; plain call "
                     f"{r['plain_call_ms']:.4f}; fp32 err vs fp64 "
                     f"{r['fp32_err_vs_fp64']['kernel']:.2e} (plain "
                     f"{r['fp32_err_vs_fp64']['plain']:.2e}); clusters "
                     f"{r['max_clusters']}" if "call_ms" in r else "")
            cold = (f" | L2 flushed {r['ms_cold']:.4f} ms (plain "
                    f"{r['plain_ms_cold']:.4f}, library "
                    f"{r['library_ms_cold']:.4f}), fp32 err vs fp64 "
                    f"{r['fp32_err_vs_fp64']['kernel']:.2e} (plain "
                    f"{r['fp32_err_vs_fp64']['plain']:.2e})"
                    if "ms_cold" in r else "")
            print(f"[kernel] {name} {r['shape']}: err {r['max_abs_err']:.2e}"
                  f" | {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}){cold}{dev_t}", flush=True)
    report["kernels"] = kern
    report["scaled_matmul_regimes"] = sweep
    report["per_layer_backward"] = per_layer
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
    report["train_full_width"] = train_full_width(dev, totals)
    report["train_smoke"] = train_smoke(totals)
    report["launches"] = totals

    sources = {"scaled_matmul": ("src/repro_torch/csrc/scaled_matmul.cu",
                                 "src/repro/kernels/scaled_matmul.py:59",
                                 "M=4 K=N=6144 bf16 x"),
               "acdc_cascade": ("src/repro_torch/csrc/acdc_cascade.cu",
                                "src/repro/kernels/acdc_cascade_fused.py:104",
                                "M=64 N=256 K=2 riffle fp32"),
               "acdc_fused": ("src/repro_torch/csrc/acdc_cascade.cu",
                              "src/repro/kernels/acdc_fused.py:64",
                              "M=4 N=256 bias=False fp32"),
               "paged_attn": ("src/repro_torch/csrc/paged_attn.cu",
                              "src/repro/kernels/paged_attn.py:225", 0),
               "acdc_bwd": ("src/repro_torch/csrc/acdc_cascade_bwd.cu",
                            "src/repro/kernels/acdc_bwd.py:102", 1),
               "acdc_cascade_bwd": ("src/repro_torch/csrc/acdc_cascade_bwd.cu",
                                    "src/repro/kernels/acdc_cascade_bwd.py:179",
                                    "M=256 N=256 K=2 riffle relu=False "
                                    "bias=False fp32")}
    line = []
    for name, (src, replaces, pick) in sources.items():
        r = (next(r for r in kern[name] if r["shape"] == pick)
             if isinstance(pick, str) else kern[name][pick])
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
