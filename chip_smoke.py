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
               "paged_attn": [], "acdc_bwd": [], "acdc_cascade_bwd": []}

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
    return results, check_backward_kernels(dev, randn, results)


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


def check_backward_kernels(dev, randn, results):
    """acdc_bwd and acdc_cascade_bwd against their plain versions at the
    smoke train step's shapes (M = 4 x 64 rows, N = 128 / 256, K = 2 with
    the riffle, bias and ReLU on and off, ragged M; K = 3) and at N = 1024
    with the full-width step's M = 512; each run twice for identical bits.
    A ReLU cascade gets inputs from ``relu_margin_input`` (K = 2).
    Then the per-layer cascade backward on the card (N = 1024, K = 24:
    only the backward gate fails; its report is returned) and the two-call
    backward's three fp32 scaled_matmul products at the full-width
    training shape."""
    import torch

    from repro_torch.core import families
    from repro_torch.kernels import acdc_bwd as bwd_mod
    from repro_torch.kernels import acdc_cascade_bwd as cbwd_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import scaled_matmul as smm_mod

    fam = families.get_family("acdc")
    for m, n, bias in ((256, 128, False), (256, 256, False),
                       (37, 256, True), (512, 1024, False)):
        c, ct = fam.matrices(n, torch.float32, dev)
        x, g = randn(m, n), randn(m, n)
        a, d = 1.0 + 0.061 * randn(n), 1.0 + 0.061 * randn(n)
        got = bwd_mod.acdc_bwd(x, g, a, d, c, ct, with_bias=bias)
        want = ref.acdc_bwd_ref(x, g, a, d, c, ct, bias)
        torch.cuda.synchronize()
        err, ok = _grads_err(got, want)
        if not ok:
            _fail(f"acdc_bwd M={m} N={n} bias={bias}: max err {err}")
        if not _same_bits(got, bwd_mod.acdc_bwd(x, g, a, d, c, ct,
                                                with_bias=bias)):
            _fail(f"acdc_bwd M={m} N={n}: two runs differ in bits")
        ms = time_ms(lambda: bwd_mod.acdc_bwd(x, g, a, d, c, ct,
                                              with_bias=bias))
        pms = time_ms(lambda: ref.acdc_bwd_ref(x, g, a, d, c, ct, bias))
        nbytes = 3 * m * n * 4 + 2 * n * 4 + 2 * n * n * 4 \
            + (3 if bias else 2) * n * 4
        b, by = bound_ms(nbytes, 6.0 * m * n * n)
        results["acdc_bwd"].append(dict(
            shape=f"M={m} N={n} bias={bias} fp32", max_abs_err=err, ms=ms,
            plain_ms=pms, library_ms=None, bound_ms=b, bound_by=by,
            bitwise_repeat=True))

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
        got = cbwd_mod.acdc_cascade_bwd(x, g, a, d, bb, c, ct, ct_mid,
                                        relu=relu)
        want = ref.acdc_cascade_bwd_ref(x, g, a, d, bb, c, ct, ct_mid, relu)
        torch.cuda.synchronize()
        err, ok = _grads_err(got, want)
        if not ok:
            _fail(f"acdc_cascade_bwd M={m} N={n} K={k}: max err {err}")
        if not _same_bits(got, cbwd_mod.acdc_cascade_bwd(
                x, g, a, d, bb, c, ct, ct_mid, relu=relu)):
            _fail(f"acdc_cascade_bwd M={m} N={n}: two runs differ in bits")
        ms = time_ms(lambda: cbwd_mod.acdc_cascade_bwd(
            x, g, a, d, bb, c, ct, ct_mid, relu=relu))
        pms = time_ms(lambda: ref.acdc_cascade_bwd_ref(
            x, g, a, d, bb, c, ct, ct_mid, relu))
        diags = 3 if bias else 2
        nbytes = 3 * m * n * 4 + 2 * diags * k * n * 4 + 3 * n * n * 4
        b, by = bound_ms(nbytes, 2.0 * m * n * n * (5 * k - 2))
        results["acdc_cascade_bwd"].append(dict(
            shape=f"M={m} N={n} K={k} riffle relu={relu} bias={bias} fp32",
            max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
            bound_ms=b, bound_by=by, bitwise_repeat=True,
            workspace_bytes=4 * (k - 1) * m * n
            + 12 * k * n * -(-m // (32 if n <= 256 else 16))))

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

    # the two-call backward at the full-width training shape: three fp32
    # scaled_matmul launches (gc = g C, h2 = (x a) C, dh1 = (gc d) C^T)
    m, n = 512, 6144
    c, ct = fam.matrices(n, torch.float32, dev)
    x, g = randn(m, n), randn(m, n)
    a, d = 1.0 + 0.061 * randn(n), 1.0 + 0.061 * randn(n)

    def three_kernel():
        gc = smm_mod.scaled_matmul(g, c)
        smm_mod.scaled_matmul(x, c, pre=a)
        return smm_mod.scaled_matmul(gc, ct, pre=d)

    def three_plain():
        gc = ref.scaled_matmul_ref(g, c)
        ref.scaled_matmul_ref(x, c, pre=a)
        return ref.scaled_matmul_ref(gc, ct, pre=d)

    def three_library():
        gc = torch.matmul(g, c)
        torch.matmul(x * a, c)
        return torch.matmul(gc * d, ct)

    got, want = three_kernel(), three_plain()
    torch.cuda.synchronize()
    if not rel_close(got, want, rtol=1e-3, atol=2e-4 * float(
            want.abs().max())):
        _fail(f"two-call backward M={m} N={n}: max err {max_err(got, want)}")
    nbytes = 3 * (m * n * 4 + n * n * 4 + m * n * 4) + 2 * n * 4
    b, by = bound_ms(nbytes, 3 * 2.0 * m * n * n)
    results["scaled_matmul"].append(dict(
        shape=f"M={m} K=N={n} fp32, x3 (two-call backward)",
        max_abs_err=max_err(got, want), ms=time_ms(three_kernel, reps=5),
        plain_ms=time_ms(three_plain, reps=5),
        library_ms=time_ms(three_library, reps=5), bound_ms=b, bound_by=by))
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

    kern, per_layer = check_kernels(dev)
    for name, rows in kern.items():
        for r in rows:
            print(f"[kernel] {name} {r['shape']}: err {r['max_abs_err']:.2e}"
                  f" | {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']})", flush=True)
    report["kernels"] = kern
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
                                 "src/repro/kernels/scaled_matmul.py:59", 2),
               "acdc_cascade": ("src/repro_torch/csrc/acdc_cascade.cu",
                                "src/repro/kernels/acdc_cascade_fused.py:104",
                                3),
               "acdc_fused": ("src/repro_torch/csrc/acdc_cascade.cu",
                              "src/repro/kernels/acdc_fused.py:64", 0),
               "paged_attn": ("src/repro_torch/csrc/paged_attn.cu",
                              "src/repro/kernels/paged_attn.py:225", 0),
               "acdc_bwd": ("src/repro_torch/csrc/acdc_bwd.cu",
                            "src/repro/kernels/acdc_bwd.py:102", 1),
               "acdc_cascade_bwd": ("src/repro_torch/csrc/acdc_cascade_bwd.cu",
                                    "src/repro/kernels/acdc_cascade_bwd.py:179",
                                    1)}
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
