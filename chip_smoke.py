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
   1 x 16384 keys at T = 1, 4 x 4096 at T = 5), and past one 16-row
   block at the dense configs' heads (DeepSeek-67B's verify, 40 rows a
   KV head; ChatGLM3-6B's decode and verify, 16 and 80; Gemma3-27B's
   1024 window over 4096 keys), bitwise on a repeat, its split plan
   recorded, every row beside one ``scaled_dot_product_attention`` call
   over a contiguous cache (with a boolean mask where slots differ, T > 1
   or a window binds); the grouped ``scaled_matmul`` at DeepSeekMoE-16B's
   expert shapes (64 experts' diagonals over M = 64, 448, 3840 rows of
   K = N = 2048) beside a loop of 64 ungrouped calls and one
   ``torch.matmul`` of the pre-scaled operand;
3b. ``autotune`` (``kernels/autotune.py``): from here on every cascade
   kernel call through ``kernels.ops`` and every ``paged_attention`` call
   takes its launch plan from an on-card sweep of the cost model's
   candidates at its key's first call (phase 3's paged rows swept
   theirs already; phase 3's cascade rows are the cost model's plans,
   launched without one).  The phase starts from an empty
   ``build/autotune_cache.json`` and sweeps path J's full-width keys
   (``acdc_cascade`` at N = 1024, K = 2, riffle, M = 4, 16, 20, 64, 128,
   512; ``acdc_cascade_bwd`` at M = 128, 512; the depth-1 draft's
   ``acdc_fused``; ``paged_attn`` group 1, Dh 64), Qwen3's paged
   attention (group 2, Dh 128, T = 1, 3, 5) and the smoke width's keys
   (N = 128 / 256 / 640, K = 1 / 2: phases 5 and 7, the drain drill, the
   smoke Mamba2); one line a key: its candidates, the cost model's plan
   and the winner with their device times and the sweep's seconds; each
   winner held against the plain version (fp32 atol 2e-4, rtol 1e-3,
   bitwise on a repeat, the cascades' fp32 error against fp64 within 2 x
   the plain version's).  Every later engine resolves its keys when it is
   built (``plans_at_engine_build``); a sweep inside a recorded tick or a
   profiled window fails; each phase's sweeps and their seconds go to
   ``report["autotune"]``; at the end every plan the memo holds is held
   against the plain version again (``hold_memo``);
4. serve full-width Qwen3-1.7B with ACDC projections (``--sell acdc
   --sell-method pallas``) through the launcher's functions, dense then
   paged, counting kernel launches; compare one prefill's and one decode
   step's logits with the plain path on the card, in bf16 and in fp32
   compute, and record each side's drift from an fp64-summed path and two
   controls (TF32 on; the diagonals dropped, which must exceed the
   limit); and hold ``scaled_matmul``'s fp32 error on every call of the
   prefill within 2 x cuBLAS fp32's (the first call where it passes 2 x
   the plain version's is recorded); then serve its first 4 requests
   speculatively (``--spec --spec-k 4``, the default depth-1
   truncated-cascade draft), dense and paged: every tick's kernel launches exact (the verify's
   ``scaled_matmul`` on the tensor cores at M = 20, the draft passes in
   the weight stream at M = 4, ``paged_attn`` at T = 5), s/tick,
   tokens/s, tokens a tick and the acceptance rate; the bf16 streams
   against the non-speculative ones reported, and in fp32 compute any
   difference must be a near-tie (the two tokens' fp64 logit gap below
   the two regimes' measured drift);
5. serve the smoke width (fp32) dense, paged and with K=1 cascades;
   greedy streams must be identical with the kernels and with the plain
   versions; then speculatively (``--spec-k 4``), dense and paged, the
   main path at the default depth and the un-riffled K=4 target at depth
   2 with one block skipped: every tick's launches exact, the streams
   identical with the kernels, with the plain versions and without
   speculation, the acceptance rate recorded;
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
8. overload at full width (8 of Qwen3's 28 layers: ``CUT_DEPTH``; paged,
   16-token pages) through the serve
   launcher's functions: deadlines on half the requests, two priority
   bands, metrics JSONL and a span trace, under a ``FaultPlan`` (corrupt
   ticks, denied pages, slow ticks): every request terminal, the pool
   clean, corrupt ticks healed by requeue, the ladder stepped down, the
   normal finishes' streams equal segment by segment to a fault-free
   run's, one terminal a request in the trace, the last JSONL snapshot
   equal to the stats;
8b. the same speculative (``--spec --spec-k 4``) in fp32 compute, with
   more slow ticks: the ladder must walk down ``spec_half``,
   ``spec_off``, ``shed`` and back to ``full``, every segment again
   exactly a fault-free speculative run's;
9. ``torch.profiler`` windows at full width (2 decode ticks dense and
   paged and 1 speculative tick paged through
   ``obs.prof.ProfileWindow``, one prefill admission, one train step):
   device busy share, host time and kernels a step, the ten kernels with
   the most device time; the window must hold kernels, its trace every
   kernel launch of the window with its device record (a session opens
   with a primer: ``obs.prof.start_profiler``), and
   ``scaled_matmul`` (by regime in the windows of ticks) / ``paged_attn``
   kernels in the trace must equal the wrappers' counts;
10. print ``{"kernels": [...]}`` (six kernels), then the final
   ``{"ok": true, "device": {...}}`` line.

Paths A - D hold the reference's default method (``--sell-method auto``:
matmul at N <= 4096, fft above) and the other SELL routes, none of which
launches a SELL kernel; they run inside that order (D after 3, A after 4,
C after 5, B after 6):

A. serve full-width Qwen3-1.7B at ``--sell-method auto`` (matmul at
   N = 2048, fft at N = 6144), dense then paged, with phase 4's requests
   and weights: every tick's launches exact (no SELL kernel, one
   ``paged_attn`` a layer paged), s/tick, tok/s, prefill s/admission; one
   prefill's and
   one decode step's logits against the ``pallas`` route, fp32
   (``auto``, ``fft``, ``matmul``) within ``FP32_METHOD_REL_L2`` and the
   bf16 decode step within ``BF16_LOGIT_REL_L2`` (the bf16 prefill
   reported: ``compare_methods_logits``), each route's drift from an
   fp64 evaluation beside it and a faulty route over each limit;
B. train full width at ``auto`` (3 AdamW steps, batch 4 x 128): s/step,
   tokens/s, peak memory, no kernel launched; one step's fp32 loss and
   per-group grads against the ``pallas`` route within
   ``FP32_GRAD_REL_L2``;
C. serve the smoke width with ``--sell low_rank``, ``circulant``,
   ``fastfood`` and ``--sell acdc`` at ``fft`` and ``matmul`` for each
   transform family (one of them paged): launches exact, greedy streams
   equal to the same model with its SELL projections in fp64 or differing
   at a near-tie;
D. the paper's Figure 2: one ACDC layer (K = 1, fp32, 128 rows) at N =
   128 .. 8192 and 6144 on the ``fft``, ``matmul`` and ``pallas`` routes
   and a dense ``x @ W``, by device time beside each bound and fp32 error
   against fp64 (the ACDC routes' within 2 x the ``matmul`` route's).

Paths E - I hold the dense decoder configs, the MoE layer, the
recurrent families and the vision frontend; they run after phase 9
(``[phase]`` lines give every phase's seconds):

E. Gemma3-27B (paged, 16-token pages), ChatGLM3-6B (paged, then
   ``--spec --spec-k 4``: 80 verify rows a KV head through ``paged_attn``)
   and DeepSeek-67B (dense layout) at full width, ``--sell acdc
   --sell-method pallas``, bf16: every tick's launches exact, s/tick,
   tok/s, prefill s/admission and peak memory beside the reckoned fp32
   masters; one decode step's logits against the plain versions within
   ``BF16_DECODE_REL_L2`` with the diagonals-dropped control over it (the
   prefill's reported); Gemma3-27B at ``auto`` in fp32 with a 1280-token
   prompt through the paged admission and one paged decode step: the
   ``paged_attn`` kernel against the plain paged attention within
   ``FP32_METHOD_REL_L2``, the same model with every layer global over
   it (the 1024 window binds); then the smoke width of all three (fp32)
   dense, paged and speculative paged: launches exact, streams identical
   with the kernels, the plain versions and without speculation, and 3
   train steps each against the plain versions;
F. DeepSeekMoE-16B at full width (8 of its 28 layers) served dense and
   paged (bf16, 8
   requests, 16 new tokens): launches exact, one grouped
   ``scaled_matmul`` a projection call for all 64 experts; one prefill's
   and one decode step's logits against the plain versions in fp32
   compute within ``FP32_METHOD_REL_L2`` (every expert given expert 0's
   diagonals reads over it), bf16 reported with the share of expert
   choices that agree; trained 3 AdamW steps (batch 4 x 128) on
   ``pallas`` (exact grouped launch count, fp32 grads per group against
   the plain versions within ``FP32_GRAD_REL_L2``, the no-d control over
   it) and on ``auto``; then the smoke width of DeepSeekMoE-16B and
   Moonshot-v1-16B-A3B (fp32) dense, paged and speculative paged, streams
   identical with kernels and plain versions, 5 train steps each;
G. Mamba2-1.3B (the ssm family: SSM/conv state a slot, no paged cache) at
   full width (12 of its 48 layers), ``--sell acdc --sell-method
   pallas``, bf16, dense: 4
   requests x 16 new tokens, then ``--spec --spec-k 4`` (the truncated
   draft; the verify re-selects each slot's state at its accepted length
   from the T + 1 snapshots): every tick's launches exact (8
   ``scaled_matmul`` a layer a decode tick), s/tick beside the tick's weight-read
   floor, tok/s, prefill s/admission, peak memory beside the reckoned fp32
   masters; the bf16 speculative streams against the non-speculative ones
   reported; one prefill's and one decode step's logits with the kernels,
   the plain versions, every ``scaled_matmul`` summed in fp64 and the
   diagonals dropped: in fp32 the kernels' drift from the fp64-summed
   path within ``DRIFT_RATIO`` x the plain versions' and the faulty
   path's over that, in bf16 reported (these untrained recurrent models
   amplify summation order far more than Qwen3: no fixed limit on
   kernels vs plain tells a fault from the plain version's own rounding);
   3 AdamW steps at 2 x 256 tokens (the SSD's 256-token chunk): s/step,
   peak memory, exact launches, fp32 grads held by drift the same way
   with the no-d control over it;
H. Zamba2-1.2B (hybrid: 12 of its 38 mamba layers, the shared attention
   block applied after every 6th) the same, with 16-token pages
   (``paged_attn`` once a shared block a tick), and its fp32 paged decode's logits against the dense one
   within ``FP32_METHOD_REL_L2`` (a rolled block table over it);
I. LLaVA-NeXT-34B's backbone at full width (20 of its 60 layers), paged:
   2 requests whose
   first 576 positions are the stub patch prefix (``--frontend``),
   ``max_prompt_len`` 640, 8 new tokens each; the decode step's logits
   after a prefixed probe against the plain versions within
   ``BF16_DECODE_REL_L2``, the diagonals-dropped control and the same
   probe with the prefix zeroed both over it; then the smoke width of
   all three (fp32): served dense, paged where the family has a paged
   cache, and speculatively, launches exact, streams identical with the
   kernels, the plain versions and without speculation; 3 train steps
   each against the plain versions (LLaVA on its frontend batches).

J. Seamless-M4T-large-v2 at full width, dense, paged and speculative,
   and trained (after path I), then its smoke width, on the autotuned
   plans (decode tick, prefill and s/step printed beside the last ones
   measured on the cost model's plans, PERF.md);
K. data-parallel training (right after phase 6): a world-of-one NCCL
   process group (``file://`` rendezvous under ``build/``) and
   ``launch.mesh.make_host_mesh()``; full-width Qwen3-1.7B (8 of its 28
   layers) through the train launcher with ``--compress-grads`` (4 x 128 tokens): on one
   seeded state and batch, every gradient leaf's int8 bound
   |ghat - (g + e)| <= scale / 2 and the identity ghat + new_e = g + e
   (atol 1e-5, the reference's) on a carried residual, ``quantize_int8``
   on the card against the CPU (entries that differ counted), equal
   step-0 losses with and without compression; three compressed steps
   and three uncompressed ones from that state (finite losses, SELL
   launches exactly ``train_launches_per_step``: compression launches no
   SELL kernel; s/step, peak memory, wire and raw bytes); the
   accumulated transmitted gradient within half a quantization step of
   the true sum over three steps, and over one step with the feedback
   dropped (the faulty control); then the drain drill: the launcher at
   smoke width under ``torchrun --standalone --nproc-per-node 1``
   (``--compress-grads``, cascade kernels at N = 128 / 256) gets SIGTERM
   after step 2, must drain (``[preempt]``, ``done.``) to a checkpoint
   at or above step 3, and ``--resume`` must finish; each worker is this
   script's ``--drill-worker`` mode, which reports the kernel launches of
   its process: exactly ``train_launches_per_step`` at smoke width for
   every step it ran (24 ``acdc_cascade`` and 12 ``acdc_cascade_bwd``),
   added to the launch totals; both read this process's autotune file
   (``REPRO_AUTOTUNE_CACHE_PATH``) and must sweep nothing and hold its
   winners for their keys.  On the CPU the
   launcher runs the same path over gloo (``torchrun ... --device cpu``).
   The compressed state is placed at rest on the (1, 1) mesh.
L. placement at rest (right after path K, on its world-of-one group):
   full-width Qwen3-1.7B (8 of its 28 layers), 3 steps with the state
   placed by the sharding
   rules (each layer gathered inside its checkpointed function, each
   gradient reduce-scattered by its gather's backward, the mesh-wide
   norm) beside 3 replicated steps from the same seed and batches:
   losses, grad and update norms and every param and moment bitwise
   equal, ``scaled_matmul`` launched ``train_launches_per_step`` times a
   step on both sides, peak memory and s/step of each; the faulty control (layer 0's gather
   served stale after step 0) must differ; then one placed smoke step
   (cascade kernels at N = 128 / 256) bitwise against a replicated one.

M. the dry run and placed serving (right after path L, on its group):
   full-width Qwen3-1.7B (bf16, ``--sell-method pallas``): a placed
   ``full_logits`` prefill of 4 prompts (64 positions, ragged) and 8
   greedy decode steps on the (1, 1) mesh, params placed by
   ``param_specs`` and the cache by ``cache_specs``, beside the unplaced
   steps: logits, cache and streams bitwise equal, ``scaled_matmul``
   launched as often on each side; the faulty control (layer 0's K cut
   from the wrong rows) must read unequal.  Then the dry run's reckoning
   of the same prefill and decode, and of a 4 x 1024 prefill, on
   ``auto`` at (1, 1), traced on meta tensors in a subprocess with its
   own fake group (``launch/dryrun.py --reckon``), against the same
   cells run on the card under the same counters: FLOPs, collectives by
   kind and argument and output bytes exactly equal, the predicted peak
   above the arguments within ``dryrun.PEAK_REL`` of
   ``torch.cuda.max_memory_allocated``'s.

N. the PyTorch examples (last): each ``examples/*_torch.py`` ``main`` in
   this process -- the quickstart whole (its one ``acdc_fused`` launch,
   section [4], counted exactly and held against the plain version),
   linear recovery at K = 1, 4, 16 with both inits, the convnet on
   ``acdc`` and ``dense`` (each loss must fall), the ~100M LM 20 steps
   (finite losses, a checkpoint written) and serving at the example's
   default argv and on ``--sell acdc --sell-method pallas``;
   ``scripts/chip_examples.py`` runs it alone.

Phase 9 profiles 4 requests (was 8) and path A no longer profiles: both
cut to keep the whole run within its time with paths G - I added.  For
the same reason phase 9's windows hold 2 decode ticks and 1 speculative
tick, phase 4's speculative serve takes one wave of 4 requests, and
phases 8, 8b and paths F - L run their full-width configs at the depth
of ``CUT_DEPTH`` (``cut_depth``): every width the published one, the
layers cut.

Details go to ``chiprun_out/chip_smoke.json``.  Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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

#: the dense decoder configs' bf16 DECODE step (path E), kernels vs plain
#: versions: 0.1 cannot tell a fault there -- the faulty path that drops
#: the diagonals read 0.092 (DeepSeek-67B) and 0.097 (ChatGLM3-6B) on the
#: decode step, where kernels vs plain read 8.7e-4 - 3.3e-3 over the five
#: configs served at full width (measured on an H100 80GB HBM3 at 700 W, PERF.md), so the step
#: is held 9 x above that and under every control
BF16_DECODE_REL_L2 = 0.03

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

#: the recurrent families' and Seamless-M4T's fp32 grads are held by
#: drift: the kernel path's distance from an fp64-summed path
#: (``kernels_in_fp64``: fp64 sums, the same roundings) within this many
#: times the plain version's.  At
#: random init Mamba2 and Zamba2 amplify summation order 10 - 400 x more
#: than Qwen3 (fp32 grads kernels vs plain 1.2e-3 / 2.9e-2, where each
#: side's own drift reads 4.4e-4 / 4.7e-3 for the kernels and 9.8e-4 /
#: 3.4e-2 for cuBLAS fp32; bf16 decode logits 0.13 / 0.11 with the plain
#: path 0.17 / 0.08 from the fp64-summed one: measured on an H100 80GB
#: HBM3 at 700 W, PERF.md), so no fixed limit on kernels vs plain tells a
#: fault from the plain version's own rounding; the phase-3 rule for one
#: kernel (within 2 x the plain version's error) holds for the model.
#: Seamless-M4T's 24 + 24 layers: plain fp32 grads 1.2e-3 from fp64,
#: the kernels' 4.3e-4 (``scripts/drift_vs_fp64.py`` on an H100 80GB
#: HBM3 at 700 W, PERF.md §6)
DRIFT_RATIO = 2.0


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
    check_grouped_scaled_matmul(dev, randn, results)

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

#: paged attention rows of the dense decoder configs, past one 16-row
#: block of the kernel: (label, slots, position as in ``PAGED_ROWS``, T,
#: query heads, KV heads, window, head dim): DeepSeek-67B's verify (group
#: 8, T = 5: 40 rows a KV head), ChatGLM3-6B's decode and verify (group
#: 16: 16 and 80 rows), on the main path's ragged 4-slot rows; Gemma3-27B's
#: local window (1024) over 4096-key rows; Zamba2-1.2B's shared attention
#: (group 1, Dh = 64) and its smoke width (Dh = 16) at decode and verify
WIDE_PAGED_ROWS = (("deepseek-67b verify", 4, None, 5, 64, 8, 0, 128),
                   ("chatglm3-6b decode", 4, None, 1, 32, 2, 0, 128),
                   ("chatglm3-6b verify", 4, None, 5, 32, 2, 0, 128),
                   ("gemma3-27b local window", 4, 4096, 1, 32, 16, 1024,
                    128),
                   ("zamba2-1.2b decode", 4, None, 1, 32, 32, 0, 64),
                   ("zamba2-1.2b verify", 4, None, 5, 32, 32, 0, 64),
                   ("zamba2 smoke decode", 4, None, 1, 8, 8, 0, 16),
                   ("zamba2 smoke verify", 4, None, 5, 8, 8, 0, 16))


def paged_case(dev, randn, bsz, length, t, dtype=None, seed=0, hq=16,
               hkv=8, dh=128):
    """Inputs of one paged row (``hq`` / ``hkv`` heads of ``dh`` dims,
    16-token pages): q, new k/v, pools, tables, positions.
    ``length`` None: the main path's 6-page tables, slot 0's tail
    unmapped beyond its frontier, positions 5, 37, 63 - T and parked;
    else every slot at ``length`` with just enough pages, its pages
    scattered over the pool as an allocator leaves them."""
    import torch

    dtype = dtype or torch.bfloat16
    bs = 16
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


def paged_bytes_flops(q, kp, tables, positions, window=0):
    """Bytes a paged call must move (q in, out, new K/V in and written,
    the streamed prefix's K/V read once: inside the ``window`` where one
    binds) and its flops (q.k and p.v over every attended key)."""
    bsz, t, hq, dh = q.shape
    hkv, bs, item = kp.shape[2], kp.shape[1], kp.element_size()
    virtual = tables.shape[1] * bs
    pos = [int(p) for p in positions.tolist()]
    # keys of the prefix inside the window of a slot's last query
    inside = [p if window <= 0 else min(p, window - 1) for p in pos]
    streamed = sum(n for n, p in zip(inside, pos) if p < virtual)
    attended = sum((n if p < virtual else 0) + t
                   for n, p in zip(inside, pos))
    nbytes = (2 * bsz * t * hq * dh * item        # q in, out
              + 4 * bsz * t * hkv * dh * item     # new k/v in, written
              + 2 * streamed * hkv * dh * item)   # streamed k/v
    return nbytes, 4.0 * attended * t * hq * dh, 2 * streamed * hkv * dh * item


def sdpa_library(q, kp, vp, tables, positions, kn, vn, window=0):
    """One ``scaled_dot_product_attention`` call over a contiguous cache
    holding the same keys and values as the paged call: each slot's
    streamed prefix (padded to the longest) then its T new tokens,
    ``enable_gqa``.  Where the slots' prefixes differ, T > 1 or a
    ``window`` binds, a boolean ``attn_mask`` keeps each slot's prefix and
    its new tokens causally (inside the window); a parked slot (which the
    paged call averages over its new tokens) then attends to its new
    tokens causally.  Returns (the call, the rows that compute the paged
    call's function: the slots that are not parked)."""
    import torch
    import torch.nn.functional as F

    bsz, t, hq, dh = q.shape
    bs = kp.shape[1]
    virtual = tables.shape[1] * bs
    pos = [int(p) for p in positions.tolist()]
    prefix = torch.tensor([p if p < virtual else 0 for p in pos],
                          device=q.device)
    lmax = int(prefix.max())
    kpos = torch.arange(lmax, device=q.device)
    valid = kpos[None, :] < prefix[:, None]                    # (B, L)
    idx = torch.where(valid, kpos[None, :], 0)
    pages = tables.long().clamp_min(0).gather(1, idx // bs)   # (B, L)
    kc = torch.cat([kp[pages, idx % bs], kn], dim=1)          # (B, L+T, ..)
    vc = torch.cat([vp[pages, idx % bs], vn], dim=1)
    qs = q.transpose(1, 2).contiguous()                        # (B, Hq, T, Dh)
    kc = kc.transpose(1, 2).contiguous()
    vc = vc.transpose(1, 2).contiguous()
    mask = None
    if t > 1 or window > 0 or not bool(valid.all()):
        causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        mask = torch.cat([valid[:, None, :].expand(bsz, t, lmax),
                          causal[None].expand(bsz, t, t)], dim=2)
        if window > 0:
            qpos = prefix[:, None] + torch.arange(t, device=q.device)
            kall = torch.cat([kpos[None, :].expand(bsz, lmax),
                              qpos], dim=1)                   # (B, L+T)
            mask = mask & (qpos[:, :, None] - kall[:, None, :] < window)
        mask = mask[:, None]

    def call():
        return F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                              enable_gqa=True)

    return call, [b for b, p in enumerate(pos) if p < virtual]


def check_paged_attn(dev, randn, results):
    """paged_attn at ``PAGED_ROWS``: against the plain version (every row,
    the parked one too; pool writes equal, trash page excluded), timed by
    device time beside the call time and the host's us a call, the main
    rows also with L2 flushed (the long rows' 67 MB exceed the 50 MB L2),
    every row beside one SDPA call over a contiguous cache (a boolean
    mask where the slots' prefixes differ or T > 1)."""
    import torch

    from repro_torch.kernels import autotune
    from repro_torch.kernels import paged_attn as pa_mod
    from repro_torch.kernels import ref

    rows = [(label, bsz, length, t, 16, 8, 0, 128)
            for label, bsz, length, t in PAGED_ROWS] + list(WIDE_PAGED_ROWS)
    for label, bsz, length, t, hq, hkv, window, dh in rows:
        q, kn, vn, kp, vp, tables, positions = paged_case(
            dev, randn, bsz, length, t, hq=hq, hkv=hkv, dh=dh)
        kp2, vp2 = kp.clone(), vp.clone()

        def kernel():
            return pa_mod.paged_attention(q, kn, vn, kp, vp, tables,
                                          positions, window, softcap=0.0)

        def plain():
            return ref.paged_attention_ref(q, kn, vn, kp2, vp2, tables,
                                           positions, window, 0.0)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        shape = (f"{label}: B={bsz} T={t} pos="
                 f"{'5/37/' + str(63 - t) + '/parked' if length is None else length}"
                 f" Hq={hq} Hkv={hkv} Dh={dh} bs=16 bf16"
                 + (f" window={window}" if window else "")
                 + f" ({hq // hkv * t} rows a KV head)")
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
                                                    positions, window)
        b, by = bound_ms(nbytes, flops)
        ms, host_us = device_ms(kernel)
        pms, phost_us = device_ms(plain, reps=3, warmup=1)
        row = dict(shape=shape, max_abs_err=max_err(got, want), ms=ms,
                   host_us=host_us, call_ms=time_ms(kernel), plain_ms=pms,
                   plain_host_us=phost_us, library_ms=None, bound_ms=b,
                   bound_by=by, bytes=nbytes, streamed_bytes=streamed,
                   bitwise_repeat=True)
        # the launch the wrapper made (autotuned: swept at this row's first
        # call) beside the cost model's
        row["plan"] = dataclasses.asdict(autotune.autotuned_plan(
            "paged_attn", *pa_mod.plan_dims(q, kp, tables), device=dev))
        row["cost_model_plan"] = dataclasses.asdict(pa_mod.plan_of(
            q, kp, tables))
        if length is None:
            row["ms_cold"] = time_cold_ms(kernel)
        lib, live = sdpa_library(q, kp, vp, tables, positions, kn, vn,
                                 window)
        row["library_ms"] = device_ms(lib)[0]
        row["library_max_abs_err"] = max_err(
            lib().transpose(1, 2)[live], got[live])
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
    128 / 256 (smoke attn_out / mlp), 640 (the smoke Mamba2 and Zamba2
    ssm_in) and 1024 (the largest N the fused route takes: every
    Seamless-M4T attn_out), M = 4 (decode) and 64 (prefill), plus the
    smoke train step's M = 256 at N = 256 and 640, and at N = 1024
    Seamless's encoder prefill (M = 16, 16 frames) and train step
    (M = 512); acdc_fused (the K=1 kernel) at N = 256, M = 4 / 64, with
    and without bias, and at N = 640 and 1024, M = 4 (the smoke
    recurrent drafts, Seamless's depth-1 draft).  Each
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
    shapes = [(m, n) for n in (128, 256, 640, 1024) for m in (4, 64)]
    shapes += [(256, 256), (256, 640), (16, 1024), (512, 1024)]
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

    for n, m, with_bias in ((256, 4, False), (256, 4, True),
                            (256, 64, False), (256, 64, True),
                            (640, 4, False), (1024, 4, False)):
        c, ct = fam.matrices(n, torch.float32, dev)
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


#: scaled_matmul's operating sizes on paths G - J (K = N after the
#: 128-lane padding): (N, M of the bf16 rows, M of the fp32 x 3 training
#: triples): Mamba2's ssm_in (2048 -> 8512) at decode and prefill and in
#: its training step; Zamba2's ssm_in (2048 -> 8384); ssm_out and
#: Zamba2's shared_in (N = 4096); Zamba2's and Seamless-M4T's MLP (8192:
#: Seamless's decode, encoder prefill of 16 frames, 64-token prefill, and
#: its train step's decoder and encoder rows); LLaVA-NeXT-34B's attn_out
#: (7168) and MLP (20480)
SLICE_SMM_SHAPES = ((8576, (4, 64), (512,)), (8448, (4,), ()),
                    (4096, (4,), ()), (8192, (4, 16, 64), (512, 128)),
                    (7168, (4,), ()), (20480, (4,), ()))


def check_scaled_matmul(dev, randn, results):
    """scaled_matmul at the main path's shapes: the two-call layer's
    products at N = 2048 (attn_out) and 6144 (mlp) with bf16 x at M = 4
    (decode, 4 slots), 16 (the weight stream's largest M) and 64 (the
    prefill window), and the two-call backward's three fp32 products at
    the full-width training M = 512.  Each against its plain version, run
    twice for identical bits, its fp32 error against fp64 held within
    2 x the plain version's (cuBLAS fp32), and timed warm and with L2
    flushed; the same at ``SLICE_SMM_SHAPES``; then both regimes timed at
    M = 4, 16, 32, 64 (N = 6144), the times that set ``STREAM_MAX_M``."""
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

    def bf16_row(n, m, c):
        """x bf16 (M, N) through the decode/prefill product."""
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

    def train_rows(n, c, ct, m=512):
        """The two-call backward's three fp32 products."""
        # the two-call backward at the full-width training shape: three
        # fp32 launches (gc = g C, h2 = (x a) C, dh1 = (gc d) C^T)
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

    for n in (2048, 6144):
        c, ct = fam.matrices(n, torch.float32, dev)
        for m in (4, 16, 64):
            bf16_row(n, m, c)
        train_rows(n, c, ct)
    # the recurrent families' and LLaVA's operating sizes
    for n, ms, train_ms in SLICE_SMM_SHAPES:
        c, ct = fam.matrices(n, torch.float32, dev)
        for m in ms:
            bf16_row(n, m, c)
        for m in train_ms:
            train_rows(n, c, ct, m)
        del c, ct
        release_memory()

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


#: the grouped scaled_matmul at DeepSeekMoE-16B's expert shapes (E = 64
#: experts, K = N = 2048): (label, rows a group C, x dtype); C is each
#: expert's capacity max(int(1.25 T 6 / 64), 1) at T routed tokens
GROUPED_SMM_ROWS = (("decode, 4 slots", 1, "bfloat16"),
                    ("64-token admission", 7, "bfloat16"),
                    ("train step, 4 x 128", 60, "float32"))


def check_grouped_scaled_matmul(dev, randn, results):
    """The grouped scaled_matmul (pre (E, K): the experts' diagonals) at
    the MoE shapes of ``GROUPED_SMM_ROWS``: against its plain version,
    bitwise on a repeat, its fp32 error against fp64 within 2 x the plain
    version's (cuBLAS fp32) on fp32 x, timed by device time beside the
    bound, the plain version, the library call (one ``torch.matmul`` of
    the pre-scaled (E C, N) operand) and a loop of E ungrouped calls (what
    grouping replaces)."""
    import torch

    from repro_torch.core import families
    from repro_torch.kernels import ref
    from repro_torch.kernels import scaled_matmul as smm_mod

    e, n = 64, 2048
    c_mat, _ = families.get_family("acdc").matrices(n, torch.float32, dev)
    pre = 1.0 + 0.061 * randn(e, n)
    for label, cap, dtype in GROUPED_SMM_ROWS:
        m = e * cap
        x = randn(m, n, dtype=getattr(torch, dtype))
        got = smm_mod.scaled_matmul(x, c_mat, pre=pre)
        want = ref.scaled_matmul_ref(x, c_mat, pre=pre)
        torch.cuda.synchronize()
        shape = f"grouped {label}: E={e} C={cap} M={m} K=N={n} {dtype} x"
        tol = (dict(rtol=2 ** -7, atol=1e-2) if dtype == "bfloat16" else
               dict(rtol=1e-3, atol=2e-4 * float(want.abs().max())))
        if not rel_close(got, want, **tol):
            _fail(f"scaled_matmul {shape}: max err {max_err(got, want)}")
        if not torch.equal(got, smm_mod.scaled_matmul(x, c_mat, pre=pre)):
            _fail(f"scaled_matmul {shape}: two runs differ in bits")
        xf = x.float()
        rows = ref.per_row(pre, m)
        y64 = (xf.double() * rows.double()) @ c_mat.double()
        scale = float(y64.abs().max())
        err = {side: float((fn(xf, c_mat, pre=pre).double() - y64).abs()
                           .max()) / scale
               for side, fn in (("kernel", smm_mod.scaled_matmul),
                                ("plain", ref.scaled_matmul_ref))}
        if not err["kernel"] <= 2 * err["plain"]:
            _fail(f"scaled_matmul {shape}: fp32 error vs fp64 "
                  f"{err['kernel']} > 2 x the plain version's {err['plain']}")
        p = smm_mod.plan(m, n, n, x.dtype)
        item = x.element_size()
        nbytes = m * n * item + n * n * 4 + e * n * 4 + m * n * item
        flops = 2.0 * m * n * n
        simt, simt_by = bound_ms(nbytes, flops)
        tc, tc_by = bound_ms(nbytes, 3 * flops, TF32_FLOP_S)
        own, own_by = (tc, tc_by) if p.regime == "tc" else (simt, simt_by)
        scaled = xf * rows

        def loop():
            for i in range(e):
                smm_mod.scaled_matmul(x[i * cap:(i + 1) * cap], c_mat,
                                      pre=pre[i])

        ms, host_us = device_ms(
            lambda: smm_mod.scaled_matmul(x, c_mat, pre=pre))
        row = dict(
            shape=shape, plan=dataclasses.asdict(p), groups=e,
            rows_per_group=cap, max_abs_err=max_err(got, want), ms=ms,
            host_us=host_us,
            call_ms=time_ms(lambda: smm_mod.scaled_matmul(x, c_mat,
                                                          pre=pre)),
            ms_cold=time_cold_ms(
                lambda: smm_mod.scaled_matmul(x, c_mat, pre=pre)),
            plain_ms=device_ms(
                lambda: ref.scaled_matmul_ref(x, c_mat, pre=pre))[0],
            library_ms=device_ms(lambda: torch.matmul(scaled, c_mat))[0],
            ungrouped_loop_ms=device_ms(loop, reps=5)[0],
            bound_ms=own, bound_by=own_by, bound_simt_ms=simt,
            bound_tc_ms=tc, fp32_err_vs_fp64=err, bitwise_repeat=True)
        results["scaled_matmul"].append(row)
        print(f"[grouped] scaled_matmul {shape} ({p.regime}): err "
              f"{row['max_abs_err']:.2e} | device {ms:.4f} ms ({host_us:.1f}"
              f" us host), L2 flushed {row['ms_cold']:.4f}, bound "
              f"{own:.4f} ({own_by}); plain {row['plain_ms']:.4f}, library "
              f"{row['library_ms']:.4f}, {e} ungrouped calls "
              f"{row['ungrouped_loop_ms']:.4f}; fp32 err vs fp64 "
              f"{err['kernel']:.2e} (plain {err['plain']:.2e})", flush=True)


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
                       (37, 256, True), (256, 640, False),
                       (512, 1024, False)):
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
    with Seamless-M4T's train step's M = 128 (encoder, 4 x 32 frames) and
    512 (decoder); each run twice for identical bits.
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
                                (256, 640, 2, False, False),
                                (128, 1024, 2, False, False),
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
# Phase 3b: the launch plans swept on the card (``kernels/autotune.py``)
# ---------------------------------------------------------------------------

#: the serving flags of the autotune phase's keys: path J's and phase 4's
#: full-width requests (4 slots, prompts <= 64, 16 new tokens, 16-token
#: pages, ``--spec-k 4``), and the smoke width's (prompts <= 12, 8 new
#: tokens, 4-token pages)
AUTOTUNE_FULL = ["--slots", "4", "--prompt-len", "64", "--gen", "16",
                 "--paged", "--block-size", "16", "--spec", "--spec-k",
                 "4"]
AUTOTUNE_SMOKE = ["--smoke", "--slots", "4", "--prompt-len", "12", "--gen",
                  "8", "--paged", "--block-size", "4", "--spec", "--spec-k",
                  "4"]


def config_of(argv, **overrides):
    """(cfg, args) of the serve launcher's flags ``argv`` (no weights)."""
    from repro_torch.launch import serve

    args = serve.parse_args(argv)
    return serve.config(args, **overrides), args


def sell_requests(cfg, rows: int, enc_rows: int = 0,
                  train: bool = False) -> set:
    """The autotune requests ``(direction, M, N, K, dtype, bias, permute,
    family)`` of one forward of ``cfg`` over ``rows`` rows (and
    ``enc_rows`` encoder frames), with ``train`` its backward's too: each
    SELL projection on the cascade kernels (``sell_projections``; a
    grouped one once a group on its rows), routed as
    ``kernels.ops`` routes it."""
    from repro_torch.core import acdc as acdc_mod
    from repro_torch.kernels import ops

    out = set()
    if cfg.sell_kind != "acdc":
        return out
    k, permute, fam = cfg.sell_k, cfg.sell_permute, cfg.sell_transform
    dt = cfg.compute_dtype
    for n, r, groups, _, _ in sell_projections(cfg, rows, enc_rows):
        if (acdc_mod._resolve_method(n, cfg.sell_method) != "pallas"
                or n > ops.MAX_FUSED_N):
            continue
        m = r // groups
        if ops.cascade_route(n, k, permute=permute, bias=False) == "cascade":
            out.add(("cascade", m, n, k, dt, False, permute, fam))
            if train and ops.cascade_bwd_fits(n, k, permute=permute,
                                              bias=False):
                out.add(("cascade_bwd", m, n, k, dt, False, permute, fam))
            elif train:     # the per-layer re-walk and backward
                out |= {("fwd", m, n, 1, dt, False, False, fam),
                        ("bwd", m, n, 1, dt, False, False, fam)}
        else:
            out.add(("fwd", m, n, 1, dt, False, False, fam))
            if train:
                out.add(("bwd", m, n, 1, dt, False, False, fam))
    return out


def serve_requests(cfg, slots: int, max_prompt_len: int, max_len: int,
                   paged: bool, block_size: int, spec_k: int,
                   draft_cfg=None) -> set:
    """The autotune requests of an engine: its prefill (``max_prompt_len``
    rows and the encoder's frames), its decode and verify steps (``slots``
    x T rows, T = 1 and k + 1 at the ladder's depths) and a draft's
    prefill and single-token passes; paged, one ``paged_attn`` request at
    each T (``paged_attn.plan``'s arguments)."""
    import torch

    ts = {1} | ({spec_k + 1, max(1, spec_k // 2) + 1} if spec_k else set())
    frames = prefill_frames(cfg)
    out = sell_requests(cfg, max_prompt_len, frames)
    for t in ts:
        out |= sell_requests(cfg, slots * t)
    if draft_cfg is not None:
        out |= sell_requests(draft_cfg, max_prompt_len, frames)
        out |= sell_requests(draft_cfg, slots)
    if paged and attention_passes(cfg):
        item = torch.empty((), dtype=cfg.compute_dtype).element_size()
        for t in ts:
            out.add(("paged_attn", slots, cfg.n_kv_heads,
                     -(-max_len // block_size), block_size,
                     cfg.n_heads // cfg.n_kv_heads, t, cfg.head_dim_, item))
    return out


def flag_requests(argv, **overrides) -> set:
    """``serve_requests`` of the serve launcher's flags (the default
    depth-1 truncated-cascade draft with ``--spec``)."""
    from repro_torch.launch import serve

    cfg, args = config_of(argv, **overrides)
    prefix = serve.frontend_prefix(args, cfg)
    spec_k = args.spec_k if args.spec else 0
    draft = (dataclasses.replace(cfg, sell_k=args.draft_depth or 1)
             if spec_k and cfg.sell_kind == "acdc" else None)
    return serve_requests(cfg, args.slots, prefix + args.prompt_len,
                          prefix + args.prompt_len + args.gen + 1,
                          args.paged, args.block_size, spec_k, draft)


def engine_requests(eng) -> set:
    """``serve_requests`` of a built engine."""
    draft = getattr(eng.draft, "cfg", None)
    return serve_requests(eng.cfg, eng.n_slots, eng.max_prompt_len,
                          eng.max_len, eng.paged,
                          getattr(eng, "block_size", 0), eng.spec_k, draft)


def resolve(requests, dev) -> None:
    """Ask for each request's autotuned plan on the card: a key's first
    request sweeps."""
    from repro_torch.kernels import autotune

    for direction, *dims in sorted(requests, key=str):
        if direction == "paged_attn":
            autotune.autotuned_plan(direction, *dims, device=dev)
        else:
            m, n, k, dt, bias, permute, fam = dims
            autotune.autotuned_plan(direction, m, n, k, device=dev,
                                    dtype=dt, bias=bias, permute=permute,
                                    family=fam)


@contextlib.contextmanager
def plans_at_engine_build():
    """Resolve every engine's autotune requests when it is built, so no
    key's first call (its sweep) falls inside a tick."""
    from repro_torch.kernels import autotune
    from repro_torch.serving import Engine

    init = Engine.__init__

    def built(self, *args, **kw):
        init(self, *args, **kw)
        if autotune._backend(self.device) != "cpu":
            resolve(engine_requests(self), self.device)

    Engine.__init__ = built
    try:
        yield
    finally:
        Engine.__init__ = init


@contextlib.contextmanager
def no_sweeps(label):
    """Fail when an autotune sweep runs inside the block (a recorded tick,
    a profiled window)."""
    from repro_torch.kernels import autotune

    before = autotune.totals()[0]
    yield
    swept = autotune.totals()[0] - before
    if swept:
        _fail(f"{label}: {swept} autotune sweeps inside a recorded tick or "
              f"profiled window: {autotune.SWEEPS[-swept:]}")


def autotune_requests() -> list:
    """The autotune phase's requests: path J's full-width cascades at the
    shapes it runs (serving: decode M = 4, encoder prefill 16, verify 20,
    prefill 64; training: 128 encoder and 512 decoder rows, forward and
    reverse sweep; the depth-1 draft's ``acdc_fused``) and its and phase
    4's paged attention (Seamless: group 1, Dh 64; Qwen3: group 2, Dh 128;
    T = 1, 3, 5); the smoke width's keys that the drain drill, phases 5
    and 7 and the smoke Mamba2 hit (N = 128 / 256 / 640, K = 1 / 2)."""
    base = ["--sell", "acdc", "--sell-method", "pallas", "--device", "cuda"]
    reqs = set()
    for arch in ("seamless_m4t_large_v2", "qwen3_1_7b"):
        reqs |= flag_requests(["--arch", arch] + base + AUTOTUNE_FULL)
    cfg, _ = config_of(["--arch", "seamless_m4t_large_v2"] + base)
    reqs |= sell_requests(cfg, 4 * 128, 4 * 32, train=True)
    for arch, over in (("qwen3_1_7b", {}), ("qwen3_1_7b", {"sell_k": 1}),
                       ("mamba2_1_3b", {})):
        argv = ["--arch", arch] + base + AUTOTUNE_SMOKE
        reqs |= flag_requests(argv, **over)
        # the smoke train step (4 x 64 tokens): phase 7, the drill
        reqs |= sell_requests(config_of(argv, **over)[0], 4 * 64,
                              train=True)
    return sorted(reqs, key=str)


def drill_requests(device="cuda") -> set:
    """The drain drill's requests: the smoke train step (4 x 64 tokens)."""
    cfg, _ = config_of(["--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
                        "--sell-method", "pallas", "--device", device])
    return sell_requests(cfg, 4 * 64, train=True)


def hold_plan(key, p, dev, timed: bool = False) -> dict:
    """A memo entry's plan against the plain version at its key's shape
    (the ACDC directions at the M bucket, in fp32: a plan does not depend
    on x's dtype; paged attention in its pools' dtype): fp32 atol 2e-4,
    rtol 1e-3 (bf16 pools: ``check_paged_attn``'s), bitwise on a repeat,
    and the cascades' fp32 error against fp64 within 2 x the plain
    version's.  ``timed`` adds the device times of the plan's launch
    (``ms``), of the plain version and of the library call (SDPA for paged
    attention, one fp32 matmul with the composed matrix for a forward
    cascade without bias or a K = 1 one with it; none for a backward), all
    on these operands (paged: ragged slots, the last parked), and their
    bound, as phase 3 reckons its rows'."""
    import torch

    from repro_torch.core import families
    from repro_torch.kernels import acdc_cascade_bwd as cbwd_mod
    from repro_torch.kernels import acdc_cascade_fused as cascade_mod
    from repro_torch.kernels import paged_attn as pa_mod
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(99)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    label = "|".join(str(v) for v in key)
    if key[0] == "paged_attn":
        b, hkv, mb, bs, group, t, dh, item = key[1:]
        dt = torch.bfloat16 if item == 2 else torch.float32
        nb = b * mb
        q = randn(b, t, hkv * group, dh, dtype=dt)
        kn, vn = randn(b, t, hkv, dh, dtype=dt), randn(b, t, hkv, dh,
                                                        dtype=dt)
        kp, vp = (randn(nb + 1, bs, hkv, dh, dtype=dt) for _ in range(2))
        tables = torch.arange(nb, dtype=torch.int32,
                              device=dev).reshape(b, mb)
        virtual = mb * bs
        # ragged positions, the last slot parked where there are two
        pos = [(37 * i + 5) % (virtual - t + 1) for i in range(b)]
        if b > 1:
            pos[-1] = virtual
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        kp2, vp2 = kp.clone(), vp.clone()
        got = pa_mod.launch(q, kn, vn, kp, vp, tables, pos, 0, 0.0, p)
        want = ref.paged_attention_ref(q, kn, vn, kp2, vp2, tables, pos, 0,
                                       0.0)
        atol, rtol = (2e-2, 2 ** -7) if item == 2 else (2e-4, 1e-3)
        if not rel_close(got, want, rtol=rtol, atol=atol) or not (
                torch.equal(kp[:-1], kp2[:-1])
                and torch.equal(vp[:-1], vp2[:-1])):
            _fail(f"autotune {label}: plan {p} against the plain version: "
                  f"max err {max_err(got, want)}")
        if not torch.equal(got, pa_mod.launch(q, kn, vn, kp, vp, tables,
                                              pos, 0, 0.0, p)):
            _fail(f"autotune {label}: plan {p}: two runs differ in bits")
        out = dict(max_abs_err=max_err(got, want), bitwise_repeat=True)
        if timed:
            nbytes, flops, _ = paged_bytes_flops(q, kp, tables, pos)
            lib, _ = sdpa_library(q, kp, vp, tables, pos, kn, vn)
            out.update(zip(("bound_ms", "bound_by"),
                           bound_ms(nbytes, flops)))
            out.update(ms=device_ms(lambda: pa_mod.launch(
                q, kn, vn, kp, vp, tables, pos, 0, 0.0, p))[0],
                plain_ms=device_ms(lambda: ref.paged_attention_ref(
                    q, kn, vn, kp2, vp2, tables, pos, 0, 0.0), reps=3,
                    warmup=1)[0], library_ms=device_ms(lib)[0])
        return out

    direction, n, k, _, bias, permute, family, m = key
    fam = families.get_family(family)
    c, ct = fam.matrices(n, torch.float32, dev)
    riffle = direction in ("cascade", "cascade_bwd") and permute and k > 1
    mid = (ct[:, torch.as_tensor(fam.riffle(n), dtype=torch.long,
                                 device=dev)].contiguous() if riffle
           else None)
    x = randn(m, n)
    a, d = 1.0 + 0.061 * randn(k, n), 1.0 + 0.061 * randn(k, n)
    bb = 0.1 * randn(k, n) if bias and direction != "bwd" else None
    n_mats = 3 if mid is not None else 2
    if direction in ("fwd", "cascade"):
        def kernel():
            return cascade_mod.launch_cascade(x, a, d, bb, c, ct, mid, False,
                                              p)

        def plain():
            return ref.acdc_cascade_ref(x, a, d, bb, c, ct, mid)

        library = None
        if bb is None or k == 1:
            w = composed_matrix(a, d, c, ct, mid)
            bvec = None if bb is None else (bb[0].double()
                                            @ ct.double()).float()

            def library():
                return (torch.matmul(x, w) if bvec is None
                        else torch.addmm(bvec, x, w))
        work = (2 * m * n * 4 + (3 if bias else 2) * k * n * 4
                + n_mats * n * n * 4, 4.0 * k * m * n * n)
        got, want = kernel(), plain()
        y64 = cascade_fp64(x, a, d, bb, c, ct, mid)
        err = {"kernel": drift(got, y64), "plain": drift(want, y64)}
        ok, same = (rel_close(got, want, rtol=1e-3, atol=2e-4),
                    torch.equal(got, kernel()))
        abs_err = max_err(got, want)
    else:
        gy = randn(m, n)
        # one layer's db from a zero bias, whose value the backward never
        # reads
        b64 = torch.zeros(1, n, device=dev) if bias and k == 1 else bb

        def kernel():
            return cbwd_mod.launch_bwd(x, gy, a, d, bb, c, ct, mid, False,
                                       p, with_db=bias)

        def plain():
            return ref.acdc_cascade_bwd_ref(x, gy, a, d, b64, c, ct, mid,
                                            False)
        library = None
        work = (3 * m * n * 4 + 2 * (3 if bias else 2) * k * n * 4
                + n_mats * n * n * 4, 2.0 * m * n * n * (5 * k - 2))
        got = kernel()
        want = plain()
        w64 = cascade_bwd_fp64(x, gy, a, d, b64, c, ct, mid)
        err = {"kernel": grads_drift(got, w64),
               "plain": grads_drift(want, w64)}
        abs_err, ok = _grads_err(got, want)
        same = _same_bits(got, kernel())
    if not ok:
        _fail(f"autotune {label}: plan {p} against the plain version: max "
              f"err {abs_err}")
    if not same:
        _fail(f"autotune {label}: plan {p}: two runs differ in bits")
    fp32_gate("autotune", f"{label} plan {p}", err)
    out = dict(max_abs_err=abs_err, bitwise_repeat=True,
               fp32_err_vs_fp64=err)
    if timed:
        out.update(zip(("bound_ms", "bound_by"), bound_ms(*work)))
        out.update(ms=device_ms(kernel)[0], plain_ms=device_ms(plain)[0],
                   library_ms=None if library is None
                   else device_ms(library)[0])
    return out


def autotune_phase(dev) -> dict:
    """Phase 3b: resolve ``autotune_requests`` on the card -- a key's
    first request sweeps its candidates -- and, for every sweep of the
    run so far (phase 3's paged rows swept theirs at their first call),
    print the candidates, the cost model's plan and the winner with their
    device times (``device_ms`` on the sweep's own sample operands; for
    paged attention the pair of ticks it times, every row at the end of
    its table and at half of it) and the sweep's seconds; hold each winner against the plain version
    (``hold_plan``).  The winners land in ``build/autotune_cache.json``."""
    import torch

    from repro_torch.kernels import autotune

    t0 = time.perf_counter()
    resolve(autotune_requests(), dev)
    rows = []
    for rec in autotune.SWEEPS:
        key = rec.key
        direction, dims = key[0], autotune._dims_of(key)
        if direction == "paged_attn":
            run = autotune.make_runner(direction, dims, dev)
        else:
            _, _, _, dt, bias, permute, family, _ = key
            run = autotune.make_runner(direction, dims, dev,
                                       getattr(torch, dt), bias, permute,
                                       family)
        cm_ms = device_ms(run(rec.cost_model))[0]
        win_ms = cm_ms if rec.winner == rec.cost_model else device_ms(
            run(rec.winner))[0]
        row = dict(key="|".join(str(v) for v in key),
                   candidates=rec.candidates,
                   cost_model=dataclasses.asdict(rec.cost_model),
                   cost_model_ms=cm_ms,
                   cost_model_sweep_ms=rec.cost_model_s * 1e3,
                   winner=dataclasses.asdict(rec.winner), winner_ms=win_ms,
                   winner_sweep_ms=rec.winner_s * 1e3,
                   sweep_s=rec.seconds)
        row.update(hold_plan(key, autotune.memo()[key], dev, timed=True))
        rows.append(row)
        lib = row["library_ms"]
        print(f"[autotune] {row['key']}: {rec.candidates} candidates | cost "
              f"model {autotune.describe(rec.cost_model)} device "
              f"{cm_ms:.4f} ms | winner {autotune.describe(rec.winner)} "
              f"device {win_ms:.4f} ms ({cm_ms / win_ms:.2f}x) | sweep "
              f"{rec.seconds:.2f} s | plain err {row['max_abs_err']:.2e} | "
              f"held sample: winner {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, library "
              f"{'none' if lib is None else f'{lib:.4f}'}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}", flush=True)
    n, s = autotune.totals()
    print(f"[autotune] {n} keys swept in {s:.1f} s, the phase "
          f"{time.perf_counter() - t0:.1f} s; file "
          f"{autotune._cache_path()}", flush=True)
    return dict(rows=rows, sweeps=n, sweep_s=s)


def hold_memo(dev, first: int = 0) -> dict:
    """At the end of the run: every plan the memo holds, against the
    plain version at its key's shape (``hold_plan``), keys first hit
    after the autotune phase included; every sweep of the run is listed,
    and those after the first ``first`` (the autotune phase's) printed
    with the device times of the winner, the plain version and the
    library call on ``hold_plan``'s operands and their bound (its
    ``timed``)."""
    from repro_torch.kernels import autotune

    t0 = time.perf_counter()
    memo = autotune.memo()
    later = {rec.key for rec in autotune.SWEEPS[first:]}
    held = {key: hold_plan(key, p, dev, timed=key in later)
            for key, p in memo.items()}
    info = dict(entries=len(memo), sweeps=autotune.totals()[0],
                seconds=time.perf_counter() - t0, swept=[])
    for rec in autotune.SWEEPS:
        row = dict(key="|".join(str(v) for v in rec.key),
                   candidates=rec.candidates,
                   cost_model=autotune.describe(rec.cost_model),
                   cost_model_sweep_ms=rec.cost_model_s * 1e3,
                   winner=autotune.describe(rec.winner),
                   winner_sweep_ms=rec.winner_s * 1e3, sweep_s=rec.seconds)
        row.update({k: v for k, v in held.get(rec.key, {}).items()
                    if k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")})
        info["swept"].append(row)
    for row in info["swept"][first:]:
        lib = row.get("library_ms")
        print(f"[autotune] swept later: {row['key']}: {row['candidates']} "
              f"candidates | cost model {row['cost_model']} "
              f"{row['cost_model_sweep_ms']:.4f} ms | winner "
              f"{row['winner']} {row['winner_sweep_ms']:.4f} ms (sweep "
              f"times, best of {autotune.SWEEP_REPS}) | held sample: "
              f"winner {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
              f"library {'none' if lib is None else f'{lib:.4f}'}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}", flush=True)
    print(f"[autotune] every memo entry ({info['entries']}; "
          f"{info['sweeps']} sweeps in the run) held against its plain "
          f"version in {info['seconds']:.1f} s", flush=True)
    return info


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

    def fused_plain(x, a, d, bias, c, ct, p=None):
        b2 = None if bias is None else bias.reshape(1, -1)
        return ref.acdc_cascade_ref(x, a.reshape(1, -1), d.reshape(1, -1),
                                    b2, c, ct, None)

    def cascade_plain(x, a, d, bias, c, ct, ct_mid, relu=False, p=None):
        return ref.acdc_cascade_ref(x, a, d, bias, c, ct, ct_mid, relu)

    def paged_plain(q, kn, vn, kp, vp, tables, position, window, softcap):
        return ref.paged_attention_ref(q, kn.to(kp.dtype), vn.to(vp.dtype),
                                       kp, vp, tables, position, int(window),
                                       float(softcap))

    def bwd_plain(x, g, a, d, c, ct, with_bias=True, p=None):
        return ref.acdc_bwd_ref(x, g, a, d, c, ct, with_bias)

    def cascade_bwd_plain(x, g, a, d, bias, c, ct, ct_mid, relu=False,
                          p=None):
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


@contextlib.contextmanager
def kernels_in_fp64():
    """Swap every SELL kernel wrapper for its plain version with fp64
    products and sums, rounded back where the kernel rounds (outputs to
    x's dtype, diagonal grads to fp32): the fp64-summed path each side's
    fp32 drift is measured against.  ``paged_attn`` stays the kernel.
    For comparisons only."""
    import torch

    from repro_torch.kernels import acdc_bwd as bwd_mod
    from repro_torch.kernels import acdc_cascade_bwd as cbwd_mod
    from repro_torch.kernels import acdc_cascade_fused as cascade_mod
    from repro_torch.kernels import acdc_fused as fused_mod
    from repro_torch.kernels import scaled_matmul as smm_mod

    saved = (smm_mod.scaled_matmul, fused_mod.acdc_fused,
             cascade_mod.acdc_cascade, bwd_mod.acdc_bwd,
             cbwd_mod.acdc_cascade_bwd)

    def rounded(grads, dtype):
        dx, *rest = grads
        return (dx.to(dtype), *(None if t is None else t.float()
                                for t in rest))

    def cascade64(x, a, d, bias, c, ct, ct_mid, relu=False, p=None):
        return cascade_fp64(x, a, d, bias, c, ct, ct_mid, relu).to(x.dtype)

    def fused64(x, a, d, bias, c, ct, p=None):
        return cascade64(x, a[None], d[None],
                         None if bias is None else bias[None], c, ct, None)

    def cascade_bwd64(x, g, a, d, bias, c, ct, ct_mid, relu=False, p=None):
        return rounded(cascade_bwd_fp64(x, g, a, d, bias, c, ct, ct_mid,
                                        relu), x.dtype)

    def bwd64(x, g, a, d, c, ct, with_bias=True, p=None):
        bias = torch.zeros(1, a.shape[-1], device=x.device) \
            if with_bias else None
        dx, da, dd, db = cascade_bwd64(x, g, a[None], d[None], bias, c, ct,
                                       None)
        return dx, da[0], dd[0], None if db is None else db[0]

    smm_mod.scaled_matmul = scaled_matmul_fp64
    fused_mod.acdc_fused = fused64
    cascade_mod.acdc_cascade = cascade64
    bwd_mod.acdc_bwd = bwd64
    cbwd_mod.acdc_cascade_bwd = cascade_bwd64
    try:
        yield
    finally:
        (smm_mod.scaled_matmul, fused_mod.acdc_fused,
         cascade_mod.acdc_cascade, bwd_mod.acdc_bwd,
         cbwd_mod.acdc_cascade_bwd) = saved


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


def model_for(params_cache, argv, **overrides):
    """(cfg, model, params) of the launcher flags ``argv`` with config
    ``overrides``, built once a key."""
    from repro_torch.launch import serve

    args = serve.parse_args(argv)
    key = (args.smoke, tuple(sorted(overrides.items())))
    if key not in params_cache:
        params_cache[key] = serve.build(args, **overrides)
    return params_cache[key]


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


#: the logit probe's prompt: 41 tokens in a 64-token window (seed 3)
PROBE_LEN = 41


def probe_logits(model, cfg, params, dev, prefix=None) -> dict:
    """fp32 logits of one batch-1 prefill of ``PROBE_LEN`` random tokens
    (seed 3) at its last position, and of one decode step after it.
    ``prefix`` (1, P, D), a vision frontend's embeddings, goes before the
    tokens on P placeholder positions; an encoder-decoder's frames
    (1, F, D) feed its encoder instead."""
    import numpy as np
    import torch

    p = (0 if prefix is None or cfg.family == "encdec"
         else prefix.shape[1])
    rs = np.random.RandomState(3)
    toks = np.zeros((1, p + 64), np.int32)
    toks[0, p:p + PROBE_LEN] = rs.randint(0, cfg.vocab_size, size=PROBE_LEN)
    n = p + PROBE_LEN
    lengths = torch.tensor([n], dtype=torch.int32, device=dev)
    next_tok = torch.tensor([rs.randint(0, cfg.vocab_size)],
                            dtype=torch.int32, device=dev)
    template = model.init_cache(cfg, 1, p + 96, dev)
    logits, cache = model.prefill(params, template,
                                  torch.from_numpy(toks).to(dev), cfg,
                                  lengths, prefix)
    pos = torch.tensor([n], dtype=torch.int32, device=dev)
    dlog, _ = model.decode_step(params, cache, next_tok, pos, cfg)
    return {"prefill": logits[0, n - 1].float(), "decode": dlog[0].float()}


def compare_full_width_logits(pieces, dev, dtype=None):
    """One prefill's and one decode step's logits, kernels vs plain, gated
    at ``BF16_LOGIT_REL_L2``.  Beside it, each side against an fp64-summed
    path (which side drifts), every layer's residual stream, and two
    controls read against the same limit: the plain path with TF32 and a
    faulty path that drops the diagonals; and, reported only, the kernel
    path with the weight stream at every M.  Then scaled_matmul's own fp32
    error on every one of the prefill's calls (``real_input_errors``).
    ``dtype`` overrides the compute dtype: "float32" rounds nothing to
    bf16 between layers, so the kernel path's drift from fp64 is summation
    order alone and is reported against the plain path's
    (``drift_ratio``)."""
    import torch

    from repro_torch.models import transformer

    cfg, model, params = pieces
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    n_calls = prefill_smm_calls(cfg)
    ffn = transformer._ffn

    def run():
        residuals = []

        def ffn_recording(layer, x, cfg_, rows=None, tp=None):
            y = ffn(layer, x, cfg_, rows, tp)
            residuals.append(y[0, :PROBE_LEN].float())
            return y

        transformer._ffn = ffn_recording
        try:
            out = probe_logits(model, cfg, params, dev)
        finally:
            transformer._ffn = ffn
        return dict(out, residuals=residuals)

    # the kernel prefill's scaled_matmul calls (the first ``n_calls`` of
    # the run), inputs kept: each side's fp32 error on the model's own
    # activations (below)
    from repro_torch.kernels import scaled_matmul as smm_mod

    recorded = []
    kernel_fn = smm_mod.scaled_matmul

    def recording(x, w, pre=None, post=None, bias=None):
        if len(recorded) < n_calls:
            recorded.append((x.float(), w, pre, post, bias))
        return kernel_fn(x, w, pre, post, bias)

    with scaled_matmul_as(recording):
        runs = {"kernel": run()}
    for name, ctx in (("plain", plain_kernels),
                      ("kernel_stream_only", stream_regime_only),
                      ("fp64", kernels_in_fp64),
                      ("plain_tf32", plain_with_tf32),
                      ("no_diagonals",
                       lambda: scaled_matmul_as(scaled_matmul_without_pre))):
        with ctx():
            runs[name] = run()
    torch.cuda.synchronize()
    pairs = (("kernel", "plain"), ("kernel", "fp64"), ("plain", "fp64"),
             ("kernel_stream_only", "plain"), ("plain_tf32", "plain"),
             ("no_diagonals", "plain"))
    out = {"limit_rel_l2": BF16_LOGIT_REL_L2, "compute": cfg.dtype}
    for where in ("prefill", "decode"):
        rels = {f"{a}_vs_{b}": _rel_l2(runs[a][where], runs[b][where])
                for a, b in pairs}
        got, want = runs["kernel"][where], runs["plain"][where]
        out[where] = dict(rel_l2=rels, max_abs_err=max_err(got, want),
                          max_abs=float(want.abs().max()),
                          drift_ratio=rels["kernel_vs_fp64"]
                          / rels["plain_vs_fp64"])
        print(f"[logits] full width {cfg.dtype} {where}: rel L2 "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (|logit| <= {out[where]['max_abs']:.2f}; limit "
              f"{BF16_LOGIT_REL_L2} on kernel_vs_plain; kernel/plain drift "
              f"from fp64 {out[where]['drift_ratio']:.2f})", flush=True)
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
    out["scaled_matmul_on_prefill_inputs"] = real_input_errors(
        recorded, n_calls // cfg.n_layers)
    return out


def prefill_smm_calls(cfg) -> int:
    """scaled_matmul calls of one full-width prefill: every SELL projection
    (attn_out and the three MLP ones per layer) is K two-call ACDC layers,
    2 calls each."""
    return cfg.n_layers * 4 * cfg.sell_k * 2


def real_input_errors(recorded, calls_per_layer: int) -> dict:
    """Each side's fp32 error against fp64 on the prefill's own
    scaled_matmul inputs, every layer's calls (fp32 x, the bf16 rounding
    of h2 not applied): max |err| / max |y| and rel. L2, the median and
    the worst over the calls, and the first call (and its layer) where
    the kernel's max error exceeds 2 x the plain version's.  The kernel's
    worst must stay within 2 x cuBLAS fp32's worst, as on the random
    inputs of phase 3."""
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
    out = {"calls": len(recorded), "first_departure": None}
    for i, (k, p) in enumerate(zip(errs["kernel"], errs["plain"])):
        if k[0] > 2 * p[0]:
            out["first_departure"] = dict(call=i, layer=i // calls_per_layer,
                                          kernel_max_err=k[0],
                                          plain_max_err=p[0])
            break
    for side, rows in errs.items():
        out[side] = {f"{stat}_{name}": fn(r[i] for r in rows)
                     for i, name in enumerate(("max_err", "rel_l2"))
                     for stat, fn in (("median", lambda v: statistics.median(
                         list(v))), ("worst", max))}
    print(f"[logits] scaled_matmul on the prefill's {len(recorded)} "
          f"calls, fp32 vs fp64: " + "; ".join(
              f"{side} rel L2 median {v['median_rel_l2']:.2e} worst "
              f"{v['worst_rel_l2']:.2e}, max err worst "
              f"{v['worst_max_err']:.2e}" for side, v in out.items()
              if side in errs) + f"; first call over 2 x plain: "
          f"{out['first_departure']}", flush=True)
    if not (out["kernel"]["worst_max_err"]
            <= 2 * out["plain"]["worst_max_err"]):
        _fail("scaled_matmul on the prefill's inputs: fp32 error "
              f"{out['kernel']['worst_max_err']} > 2 x the plain version's "
              f"{out['plain']['worst_max_err']}")
    return out


# ---------------------------------------------------------------------------
# Speculative decoding (phases 5 and 4b): exact launches a tick, streams
# ---------------------------------------------------------------------------

#: the speculative paths' draft length (the launcher's default)
SPEC_K = 4

#: the reference's un-riffled truncation target
#: (tests/test_spec_decode.py): K = 4, no riffle, near-converged init
UNRIFFLED = dict(sell_k=4, sell_permute=False, sell_init_std=0.02)


def sell_projections(cfg, rows: int, enc_rows: int = 0) -> list:
    """``(operating size N, rows, groups, count, remat)`` of each SELL
    projection of ``cfg``'s stack over ``rows`` tokens, ``count`` its
    instances and ``remat`` whether training recomputes it in the
    backward.  A decoder layer: attn_out, then the three MLP projections
    -- or, in an MoE layer, the routed experts' three (grouped: E groups
    of each expert's capacity at ``rows`` tokens) and the shared expert's
    three.  A mamba layer (ssm, hybrid): ssm_in and ssm_out; the hybrid's
    shared block, once an application (not recomputed): shared_in,
    attn_out and the MLP's three.  An encoder-decoder's decoder layer:
    the self- and the cross-attention's attn_out and the MLP's three;
    with ``enc_rows`` frames (a pass that runs the encoder: a prefill,
    training) each encoder layer's attn_out and MLP over them too."""
    from repro_torch.models import linear, mamba2, zamba2
    from repro_torch.models import mlp as mlp_mod

    dh, d = cfg.head_dim_, cfg.d_model

    def ffn(d_ff, r, groups, count, remat):
        return [("mlp_in", d, d_ff, r, groups, count, remat)] * 2 + [
            ("mlp_out", d_ff, d, r, groups, count, remat)]

    proj = []
    if cfg.family in ("ssm", "hybrid"):
        proj += [("ssm_in", d, mamba2._proj_out(cfg), rows, 1, cfg.n_layers,
                  cfg.remat),
                 ("ssm_out", mamba2._dims(cfg)[0], d, rows, 1, cfg.n_layers,
                  cfg.remat)]
    if cfg.family == "hybrid":
        apps = len(zamba2._n_groups(cfg))
        proj += [("shared_in", 2 * d, d, rows, 1, apps, False),
                 ("attn_out", cfg.n_heads * dh, d, rows, 1, apps, False)]
        proj += ffn(cfg.d_ff, rows, 1, apps, False)
    elif cfg.family == "encdec":
        n, remat = cfg.n_layers, cfg.remat
        proj += [("attn_out", cfg.n_heads * dh, d, rows, 1, 2 * n, remat)]
        proj += ffn(cfg.d_ff, rows, 1, n, remat)
        if enc_rows:
            n_enc = cfg.n_encoder_layers or n
            proj += [("attn_out", cfg.n_heads * dh, d, enc_rows, 1, n_enc,
                      remat)]
            proj += ffn(cfg.d_ff, enc_rows, 1, n_enc, remat)
    elif cfg.family == "decoder":
        n, remat = cfg.n_layers, cfg.remat
        proj.append(("attn_out", cfg.n_heads * dh, d, rows, 1, n, remat))
        if cfg.n_experts:
            e = cfg.n_experts
            proj += ffn(cfg.d_ff, e * mlp_mod.capacity(cfg, rows), e, n,
                        remat)
            if cfg.n_shared_experts:
                proj += ffn(cfg.d_ff * cfg.n_shared_experts, rows, 1, n,
                            remat)
        else:
            proj += ffn(cfg.d_ff, rows, 1, n, remat)
    return [(linear._sell_cfg(cfg, n_in, n_out).n_op, r, g, count, remat)
            for role, n_in, n_out, r, g, count, remat in proj
            if linear.uses_sell(cfg, role)]


def attention_passes(cfg) -> int:
    """Cached (self-)attention applications in one pass of ``cfg``'s
    stack: one a decoder layer (an encoder-decoder's cross-attention
    reads its dense cross cache), one a shared-block application
    (hybrid), none (ssm)."""
    from repro_torch.models import zamba2

    if cfg.family == "hybrid":
        return len(zamba2._n_groups(cfg))
    return {"decoder": cfg.n_layers, "encdec": cfg.n_layers,
            "ssm": 0}[cfg.family]


def prefill_frames(cfg) -> int:
    """Audio frames the serve launcher gives each encoder-decoder request
    (``n_frontend_tokens or 16``, ``launch/serve._make_frontend``); 0 for
    every other family."""
    return (cfg.n_frontend_tokens or 16) if cfg.family == "encdec" else 0


def forward_launches(cfg, rows: int, paged_t: int = 0, enc_rows: int = 0):
    """Kernel launches of one forward pass of ``cfg`` over ``rows`` rows
    (batch x tokens), and an encoder-decoder's encoder over ``enc_rows``
    frames: each SELL projection (``sell_projections``, times its count)
    launches what the port's routing gives it -- on the ``pallas`` route
    ``kernels.ops.forward_launches`` (grouped projections: one grouped
    ``scaled_matmul`` a call, never one an expert), on every other method
    (``auto``, ``fft``, ``matmul``) and kind no kernel at all; a paged
    pass adds one ``paged_attn`` an attention application at T =
    ``paged_t``."""
    import collections

    from repro_torch.core import acdc as acdc_mod
    from repro_torch.kernels import ops

    out = collections.Counter()
    k = cfg.sell_k
    if cfg.sell_kind != "acdc":
        k = 0
    for n, r, groups, count, _ in (sell_projections(cfg, rows, enc_rows)
                                   if k else ()):
        if acdc_mod._resolve_method(n, cfg.sell_method) != "pallas":
            continue
        one = ops.forward_launches(n, k, r, permute=cfg.sell_permute,
                                   bias=False, groups=groups)
        out.update({key: v * count for key, v in one.items()})
    if paged_t:
        out["paged_attn"] += attention_passes(cfg)
        out[f"paged_attn_T{paged_t}"] += attention_passes(cfg)
    return out


@contextlib.contextmanager
def tick_recorder():
    """Record every ``Engine.tick`` run inside the block: the kernel
    launches it made (the wrappers' counts, ``scaled_matmul`` also by
    regime and ``paged_attn`` by T, tallied at each kernel's ``launch``),
    the prefills it ran, whether it stepped, and its speculation depth;
    an autotune sweep inside a tick fails (``no_sweeps``)."""
    import collections

    from repro_torch.kernels import paged_attn as pa_mod
    from repro_torch.kernels import scaled_matmul as smm_mod
    from repro_torch.serving import Engine

    records, tally = [], collections.Counter()
    smm_launch, pa_launch, tick = smm_mod.launch, pa_mod.launch, Engine.tick

    def smm_counted(x, w, pre, post, bias, p):
        tally[f"scaled_matmul_{p.regime}"] += 1
        return smm_launch(x, w, pre, post, bias, p)

    def pa_counted(q, *args):
        tally[f"paged_attn_T{q.shape[1]}"] += 1
        return pa_launch(q, *args)

    def counts():
        return collections.Counter(read_counts()) + tally

    def tick_counted(eng):
        before = counts()
        s0 = (eng.stats["prefill_dispatches"], eng.stats["decode_ticks"])
        k = eng.spec_k_eff
        with no_sweeps(f"tick {len(records)}"):
            n = tick(eng)
        launched = counts()
        launched.subtract(before)
        records.append(dict(
            k=k, prefills=eng.stats["prefill_dispatches"] - s0[0],
            stepped=eng.stats["decode_ticks"] - s0[1],
            launches={key: v for key, v in launched.items() if v}))
        return n

    smm_mod.launch, pa_mod.launch, Engine.tick = (smm_counted, pa_counted,
                                                  tick_counted)
    try:
        yield records
    finally:
        smm_mod.launch, pa_mod.launch, Engine.tick = smm_launch, pa_launch, tick


def expected_tick(eng, rec, prompt_rows: int):
    """The launches tick record ``rec`` of engine ``eng`` must show: a
    target prefill (and a draft prefill when the engine has a draft) for
    every admission, an encoder-decoder's each with its encoder over the
    request's frames, then either a speculative step (k + 1 single-token
    draft passes over the dense draft cache, one verify of all slots at
    T = k + 1) or a decode step."""
    import collections

    want = collections.Counter()
    draft_cfg = eng.draft.cfg if eng.draft is not None else None
    frames = prefill_frames(eng.cfg)
    for _ in range(rec["prefills"]):
        want += forward_launches(eng.cfg, prompt_rows, enc_rows=frames)
        if draft_cfg is not None:
            want += forward_launches(draft_cfg, prompt_rows,
                                     enc_rows=frames)
    if rec["stepped"]:
        k, slots = rec["k"], eng.n_slots
        t = k + 1
        want += forward_launches(eng.cfg, slots * t,
                                 paged_t=t if eng.paged else 0)
        for _ in range(k + 1 if k else 0):
            want += forward_launches(draft_cfg, slots)
    return {key: v for key, v in want.items() if v}


def check_ticks(label, eng, records, prompt_rows: int,
                spec: bool = True) -> dict:
    """Every tick's launches exactly as ``expected_tick`` (and, with
    ``spec``, at least one speculative tick); returns the launches of a
    speculative tick without admissions (and of each other kind of tick
    seen), and the ticks by kind."""
    kinds = {}
    for i, rec in enumerate(records):
        want = expected_tick(eng, rec, prompt_rows)
        if rec["launches"] != want:
            _fail(f"{label}: tick {i} (k={rec['k']}, {rec['prefills']} "
                  f"prefills, stepped {rec['stepped']}) launched "
                  f"{rec['launches']}, want {want}")
        key = f"k={rec['k']}" + (f" +{rec['prefills']} prefills"
                                 if rec["prefills"] else "")
        if rec["stepped"] or rec["prefills"]:
            kinds.setdefault(key, dict(ticks=0, launches=want))["ticks"] += 1
    if spec and not any(r["k"] and r["stepped"] for r in records):
        _fail(f"{label}: no speculative tick ran")
    return kinds


def serve_path(label, argv, pieces, totals, require, record=False):
    """Drive the launcher's engine once with ``pieces`` = (cfg, model,
    params), counts reset just before and read just after; ``require``
    names kernels that must have launched; with ``record`` every tick is
    recorded (``tick_recorder``).  Returns (info, requests, engine, tick
    records)."""
    import torch

    from repro_torch.launch import serve

    args = serve.parse_args(argv)
    cfg, model, params = pieces
    reset_counts()
    with (tick_recorder() if record else contextlib.nullcontext([])) as recs:
        eng, reqs, dt = serve.serve(args, cfg, model, params)
    counts = read_counts()
    for name in require:
        if counts[name] == 0:
            _fail(f"{label}: kernel {name} never launched on this path")
    for name, n in counts.items():
        totals[name] += n
    if any(r.finish_reason is None for r in reqs):
        _fail(f"{label}: unfinished requests")
    s = eng.stats
    steps = max(s["decode_ticks"], 1)
    info = dict(path=label, argv=argv, compute=cfg.dtype,
                tokens=s["tokens_out"], wall_s=dt,
                tok_per_s=s["tokens_out"] / dt, prefill_s=s["prefill_s"],
                decode_s=s["decode_s"], decode_ticks=s["decode_ticks"],
                s_per_tick=s["decode_s"] / steps,
                tokens_per_tick=(s["tokens_out"] - s["prefill_dispatches"])
                / steps,
                prefills=s["prefill_dispatches"], drafted=s["drafted"],
                accepted=s["accepted"],
                acceptance_rate=s["acceptance_rate"],
                degrade_down=s["degrade_down"], launches=counts,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[serve] {label} ({smi_line()}): {s['tokens_out']} tokens in "
          f"{dt:.3f}s ({info['tok_per_s']:.1f} tok/s) | prefill "
          f"{s['prefill_s']:.3f}s ({s['prefill_dispatches']}) | decode "
          f"{s['decode_s']:.3f}s ({s['decode_ticks']} ticks, "
          f"{info['s_per_tick'] * 1e3:.1f} ms a tick, "
          f"{info['tokens_per_tick']:.2f} tokens a tick) | accepted "
          f"{s['accepted']}/{s['drafted']} | launches {counts}", flush=True)
    return info, reqs, eng, recs


def streams_of(reqs):
    return [list(r.generated) for r in reqs]


def smoke_spec(params_cache, totals):
    """Smoke-width speculative serving (fp32), dense and with 4-token
    pages, in two setups: the main path at the default draft depth (K = 2
    riffled, the depth-1 draft on ``acdc_fused``) and the reference's
    un-riffled K = 4 target at depth 2 with one block skipped.  Every
    tick's launches are exact; the greedy streams are identical with the
    kernels, with the plain versions and without speculation."""
    from repro_torch.launch import serve

    base = ["--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
            "--sell-method", "pallas", "--slots", "4", "--prompt-len",
            "12", "--gen", "8", "--requests", "8", "--device", "cuda"]
    out = []
    for setup, extra, overrides in (
            ("smoke spec", [], {}),
            ("smoke spec un-riffled K=4", ["--draft-depth", "2",
                                          "--spec-skip-layers", "1"],
             UNRIFFLED)):
        pieces = model_for(params_cache, base, **overrides)
        for paged in (False, True):
            layout = ["--paged", "--block-size", "4"] if paged else []
            label = f"{setup} {'paged' if paged else 'dense'}"
            argv = base + layout + extra + ["--spec", "--spec-k",
                                            str(SPEC_K)]
            need = ("acdc_cascade",) + (("paged_attn",) if paged else ())
            if not overrides:
                need += ("acdc_fused",)
            info, reqs, eng, recs = serve_path(label, argv, pieces, totals,
                                               need, record=True)
            streams = streams_of(reqs)
            info["ticks"] = check_ticks(label, eng, recs, 12)
            info["draft"] = dict(depth=eng.draft.depth,
                                 skip_layers=eng.draft.skip_layers,
                                 sell_k=eng.draft.cfg.sell_k)
            with plain_kernels():
                plain = streams_of(serve_path(
                    label + " (plain)", argv, pieces,
                    {k: 0 for k in KERNEL_MODULES}, ())[1])
            nonspec = streams_of(serve_path(
                label + " (no speculation)", base + layout, pieces,
                {k: 0 for k in KERNEL_MODULES}, ())[1])
            if streams != plain:
                _fail(f"{label}: greedy streams differ between kernels and "
                      f"plain versions")
            if streams != nonspec:
                _fail(f"{label}: greedy streams differ from the "
                      f"non-speculative run")
            info["streams_identical_to_plain"] = True
            info["streams_identical_to_nonspec"] = True
            print(f"[spec] {label}: launches a tick by kind "
                  f"{json.dumps(info['ticks'])}", flush=True)
            out.append(info)
    return out


def logits_after(model, cfg, params, context, dev):
    """fp32 logits of the token after ``context`` (a batch-1 prefill)."""
    import torch

    n = len(context)
    toks = torch.tensor([context], dtype=torch.int32, device=dev)
    template = model.init_cache(cfg, 1, n, dev)
    lengths = torch.tensor([n], dtype=torch.int32, device=dev)
    logits, _ = model.prefill(params, template, toks, cfg, lengths)
    return logits[0, n - 1].double()


def decode_logits_after(model, cfg, params, context, dev):
    """fp32 logits of the token after ``context`` from a decode step over
    its last token (after a prefill of the rest)."""
    import torch

    n = len(context)
    toks = torch.tensor([context[:-1]], dtype=torch.int32, device=dev)
    template = model.init_cache(cfg, 1, n, dev)
    lengths = torch.tensor([n - 1], dtype=torch.int32, device=dev)
    _, cache = model.prefill(params, template, toks, cfg, lengths)
    pos = torch.tensor([n - 1], dtype=torch.int32, device=dev)
    last = torch.tensor([context[-1]], dtype=torch.int32, device=dev)
    logits, _ = model.decode_step(params, cache, last, pos, cfg)
    return logits[0].double()


def near_tie(model, cfg, params, context, tok_a, tok_b, dev,
             fp64=None) -> dict:
    """Whether two paths' different greedy picks ``tok_a`` / ``tok_b``
    after ``context`` are a near-tie: the gap between their logits in an
    fp64-summed pass (every SELL kernel in fp64, or the context
    ``fp64()`` gives) is below the sum of the two sides' measured drift
    from it at that position, the tensor-core regime's (a prefill over the
    context: the verify's regime) and the weight stream's (a decode step:
    the decode's)."""
    with (fp64 or kernels_in_fp64)():
        want = logits_after(model, cfg, params, context, dev)
    drift_tc = float((logits_after(model, cfg, params, context, dev)
                      - want).abs().max())
    drift_stream = float((decode_logits_after(model, cfg, params, context,
                                              dev) - want).abs().max())
    gap = abs(float(want[tok_a] - want[tok_b]))
    top2 = [int(i) for i in want.topk(2).indices]
    return dict(position=len(context), tokens=[tok_a, tok_b], gap=gap,
                top2=top2, drift_tc=drift_tc, drift_stream=drift_stream,
                near_tie=gap <= drift_tc + drift_stream)


def compare_streams(label, pieces, prompts, got, want, dev, hold: bool,
                    fp64=None):
    """Compare streams ``got`` with ``want`` (same prompts: speculative
    against non-speculative, or fp32 against fp64); each first difference
    is examined by ``near_tie`` (its fp64 pass ``fp64``).  With ``hold``,
    a difference that is not a near-tie fails."""
    cfg, model, params = pieces
    diffs = []
    for prompt, g, w in zip(prompts, got, want):
        if g == w:
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            diffs.append(dict(lengths=[len(g), len(w)]))
            if hold:
                _fail(f"{label}: streams of unequal length {g} / {w}")
            continue
        tie = near_tie(model, cfg, params, list(prompt) + w[:j], g[j], w[j],
                       dev, fp64)
        diffs.append(tie)
        if hold and not tie["near_tie"]:
            _fail(f"{label}: speculative stream {g} departs from {w} at "
                  f"token {j}, not a near-tie ({tie})")
    out = dict(streams=len(got), equal=len(got) - len(diffs), diffs=diffs)
    print(f"[streams] {label}: {out['equal']}/{len(got)} streams equal"
          + (f"; first differences {diffs}" if diffs else ""), flush=True)
    return out


def spec_full_width(pieces, dev, totals, nonspec_streams):
    """Full-width speculative serving through the launcher (``--spec
    --spec-k 4``, the default depth-1 draft), dense and with 16-token
    pages, 4 slots, phase 4's first 4 requests (one wave of the 4 slots):
    exact launches every tick (the verify's
    448 ``scaled_matmul`` on the tensor cores at M = 20, 224 a draft pass
    in the weight stream at M = 4, 28 ``paged_attn`` at T = 5 a paged
    verify), s/tick, tokens/s, tokens a tick and the acceptance rate.
    bf16 streams against phase 4's non-speculative ones are reported; in
    fp32 compute both are run again and any difference must be a near-tie
    (``near_tie``)."""
    cfg, model, params = pieces
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    base = ["--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method",
            "pallas", "--slots", "4", "--prompt-len", "64", "--gen", "16",
            "--requests", "4", "--device", "cuda"]
    spec = ["--spec", "--spec-k", str(SPEC_K)]
    out = {}
    for paged in (False, True):
        layout = ["--paged", "--block-size", "16"] if paged else []
        name = "paged" if paged else "dense"
        label = f"full width spec {name}"
        info, reqs, eng, recs = serve_path(
            label, base + layout + spec, (cfg, model, params), totals,
            ("scaled_matmul",) + (("paged_attn",) if paged else ()),
            record=True)
        prompts = [r.prompt for r in reqs]
        info["ticks"] = check_ticks(label, eng, recs, 64)
        print(f"[spec] {label}: launches a tick by kind "
              f"{json.dumps(info['ticks'])}", flush=True)
        info["bf16_vs_nonspec"] = compare_streams(
            label + " bf16", (cfg, model, params), prompts, streams_of(reqs),
            nonspec_streams[name][:len(reqs)], dev, hold=False)
        wave = base + layout
        nonspec32 = streams_of(serve_path(
            f"full width {name} fp32 (no speculation)", wave,
            (cfg32, model, params), totals, ("scaled_matmul",))[1])
        info32, reqs32, _, _ = serve_path(
            f"full width spec {name} fp32", wave + spec,
            (cfg32, model, params), totals, ("scaled_matmul",))
        spec32 = streams_of(reqs32)
        if len(spec32) != 4 or len(nonspec32) != 4:
            _fail(f"{label} fp32: {len(spec32)} / {len(nonspec32)} streams, "
                  f"want 4")
        info["fp32"] = dict(info32, vs_nonspec=compare_streams(
            label + " fp32", (cfg32, model, params),
            [r.prompt for r in reqs32], spec32, nonspec32, dev, hold=True))
        info["acceptance_rate_fp32"] = info32["acceptance_rate"]
        out[name] = info
    return out


# ---------------------------------------------------------------------------
# Phases 6-7: training through the train launcher's functions
# ---------------------------------------------------------------------------

#: parameter groups whose gradients are compared, by path regex
GRAD_GROUPS = (("sell/a", r"sell/a$"), ("sell/d", r"sell/d$"),
               ("dense w", r"/w$"), ("embed", r"^embed/"))

#: an MoE model's groups besides: the routed experts' diagonals (per
#: expert, from the grouped backward) and the router
MOE_GRAD_GROUPS = (("experts sell/a", r"experts/.*sell/a$"),
                   ("experts sell/d", r"experts/.*sell/d$"),
                   ("router/w", r"router/w$"))


#: a mamba layer's own leaves (ssm and hybrid families)
MAMBA_GRAD_GROUPS = (("mixer conv/dt/A/D",
                      r"mixer/(conv_w|conv_b|dt_bias|a_log|d_skip)$"),)


def grad_groups(cfg) -> tuple:
    """The gradient groups of ``cfg``: an attention-free model (ssm) has
    no dense projection weights."""
    groups = tuple(g for g in GRAD_GROUPS
                   if g[0] != "dense w" or cfg.family != "ssm")
    if cfg.family in ("ssm", "hybrid"):
        groups += MAMBA_GRAD_GROUPS
    return groups + (MOE_GRAD_GROUPS if cfg.n_experts else ())


def group_rel_l2(got: dict, want: dict, groups=GRAD_GROUPS) -> dict:
    """Relative L2 distance of two gradient trees over each group of
    ``groups`` (the group's leaves taken as one vector)."""
    import torch

    from repro_torch.optim.optimizers import tree_flatten

    paths, g = tree_flatten(got)
    _, w = tree_flatten(want)
    out = {}
    for name, rx in groups:
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


def train_launches_per_step(cfg, rows: int, enc_rows: int = 0) -> dict:
    """Kernel launches of one full-width train step over ``rows`` tokens
    (and an encoder-decoder's ``enc_rows`` frames), by wrapper: every
    SELL projection (``sell_projections``: attn_out and the three MLP ones
    per layer, or the experts' three -- grouped, one launch for all
    experts -- and the shared expert's three; ssm_in and ssm_out a mamba
    layer; the hybrid's shared block once an application; the
    encoder-decoder's self and cross attn_out, its encoder's attn_out and
    the MLPs) launches its forward (``kernels.ops.forward_launches``), the
    forward again when remat recomputes it in the backward, and its
    backward: a fused cascade one ``acdc_cascade_bwd`` a group when the
    reverse sweep's gate passes (else the per-layer backward: K - 1
    ``acdc_fused`` re-walks and K ``acdc_bwd``), a per-layer cascade K
    ``acdc_bwd`` (N <= MAX_FUSED_N) or 3 ``scaled_matmul`` a layer (the
    two-call backward)."""
    import collections

    from repro_torch.kernels import ops

    k, want = cfg.sell_k, collections.Counter()
    for n, r, groups, count, remat in sell_projections(cfg, rows, enc_rows):
        fwd = ops.forward_launches(n, k, r, permute=cfg.sell_permute,
                                   bias=False, groups=groups)
        step = collections.Counter({key: v * (2 if remat else 1)
                                    for key, v in fwd.items()
                                    if not key.startswith("scaled_matmul_")})
        route = ops.cascade_route(n, k, permute=cfg.sell_permute,
                                  bias=False)
        if route == "two_call":
            step["scaled_matmul"] += 3 * k
        elif route == "fused":
            step["acdc_bwd"] += k * groups
        elif ops.cascade_bwd_fits(n, k, permute=cfg.sell_permute,
                                  bias=False):
            step["acdc_cascade_bwd"] += groups
        else:
            step.update({"acdc_fused": (k - 1) * groups,
                         "acdc_bwd": k * groups})
        want.update({key: v * count for key, v in step.items()})
    return dict(want)


def compare_grads(model, cfg, params, batch, label="full width",
                  fp64=False) -> dict:
    """One step's loss and gradients with the kernels, the plain versions
    and the faulty backward, at ``cfg``'s compute dtype; rel. L2 per
    group against the plain versions, and with ``fp64`` each side's
    against every ``scaled_matmul`` summed in fp64."""
    import torch

    from repro_torch.dist import steps as steps_mod

    runs = {}
    sides = [("kernel", contextlib.nullcontext), ("plain", plain_kernels),
             ("no_d_in_dh1", backward_without_d)]
    if fp64:
        sides.append(("fp64", kernels_in_fp64))
    for name, ctx in sides:
        with ctx():
            runs[name] = steps_mod.loss_and_grads(model, cfg, params, batch)
    torch.cuda.synchronize()
    pairs = [(a, "plain") for a in ("kernel", "no_d_in_dh1")]
    if fp64:
        pairs += [(a, "fp64") for a in ("kernel", "plain", "no_d_in_dh1")]
    out = dict(loss_kernel=float(runs["kernel"][0]),
               loss_plain=float(runs["plain"][0]),
               rel_l2={f"{a}_vs_{b}": group_rel_l2(runs[a][1], runs[b][1],
                                                   grad_groups(cfg))
                       for a, b in pairs})
    del runs
    torch.cuda.empty_cache()
    print(f"[grads] {label} {cfg.dtype}, one step: loss kernel "
          f"{out['loss_kernel']:.6f} plain {out['loss_plain']:.6f} | rel L2 "
          + "; ".join(f"{k}: " + ", ".join(f"{g} {v:.3e}"
                                           for g, v in r.items())
                      for k, r in out["rel_l2"].items()), flush=True)
    return out


def train_full_width(dev, totals, arch="qwen3_1_7b", global_batch=4,
                     seq_len=128, hold="plain"):
    """Full-width training of ``arch`` (Qwen3-1.7B on the main path) at
    ``global_batch`` x ``seq_len`` tokens: one step's loss and grads
    against the plain versions and a faulty control (the fp32 grads held
    within ``FP32_GRAD_REL_L2`` of the plain versions, or with ``hold``
    "drift" within ``DRIFT_RATIO`` x the plain version's drift from an
    fp64-summed step), then one warm-up and two timed AdamW steps with
    exact launch counts (``train_launches_per_step``; every cascade
    backward's gate decision the reverse sweep, counted in
    ``ops.CASCADE_BWD_DISPATCHES``).  An encoder-decoder's batch carries
    the launcher's frames (``seq_len // 4`` a row)."""
    import torch

    from repro_torch.dist import steps as steps_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    args = train.parse_args([
        "--arch", arch, "--sell", "acdc", "--sell-method", "pallas",
        "--global-batch", str(global_batch), "--seq-len", str(seq_len),
        "--steps", "3", "--device", str(dev)])
    label = "full width" + ("" if arch == "qwen3_1_7b" else f" {arch}")
    cfg, model, opt, train_step, pipeline = train.build(args)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_state(model, cfg, opt, gen, dev)
    tokens = args.global_batch * args.seq_len
    batch = train.batch_on(pipeline, 0, dev)

    grads = {}
    for dtype in ("bfloat16", "float32"):
        grads[dtype] = compare_grads(
            model, dataclasses.replace(cfg, dtype=dtype), state["params"],
            batch, label, fp64=hold == "drift" and dtype == "float32")
    loss_k = grads["bfloat16"]["loss_kernel"]
    loss_p = grads["bfloat16"]["loss_plain"]
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p)
            <= 1e-2 * abs(loss_p)):
        _fail(f"{label} loss: kernel {loss_k} vs plain {loss_p}")
    rel = grads["float32"]["rel_l2"]
    if hold == "drift":
        for group, plain in rel["plain_vs_fp64"].items():
            got = rel["kernel_vs_fp64"][group]
            bad = rel["no_d_in_dh1_vs_fp64"][group]
            if not got <= DRIFT_RATIO * plain:
                _fail(f"{label} fp32 grads {group}: kernel drift from fp64 "
                      f"{got} > {DRIFT_RATIO} x the plain version's {plain}")
            if not bad > DRIFT_RATIO * plain:
                _fail(f"{label} fp32 grads {group}: the drift limit does "
                      f"not catch the faulty backward ({bad})")
    else:
        worst = max(rel["kernel_vs_plain"].values())
        if not worst <= FP32_GRAD_REL_L2:
            _fail(f"{label} fp32 grads: rel L2 {worst} > "
                  f"{FP32_GRAD_REL_L2}")
        control = min(rel["no_d_in_dh1_vs_plain"].values())
        if not control > FP32_GRAD_REL_L2:
            _fail(f"{label} fp32 grads: the limit {FP32_GRAD_REL_L2} does "
                  f"not catch the faulty backward (rel L2 {control})")

    frames = pipeline.cfg.n_frontend_tokens if cfg.family == "encdec" else 0
    want = train_launches_per_step(cfg, tokens,
                                   args.global_batch * frames)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = []
    for step in range(args.steps):
        before = read_counts()
        sweeps = dict(ops.CASCADE_BWD_DISPATCHES)
        t0 = time.perf_counter()
        state, metrics = train_step(state, train.batch_on(pipeline, step,
                                                          dev))
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        after = read_counts()
        delta = {k: after[k] - before[k] for k in after}
        routed = {k: ops.CASCADE_BWD_DISPATCHES[k] - sweeps[k]
                  for k in sweeps}
        loss = float(metrics["loss"])
        print(f"[train] {label} step {step}: loss {loss:.4f} |g| "
              f"{float(metrics['grad_norm']):.3f} {dt:.3f}s | launches "
              f"{delta} | cascade backward routes {routed}", flush=True)
        if not math.isfinite(loss):
            _fail(f"{label} step {step}: loss {loss}")
        if {k: v for k, v in delta.items() if v} != want:
            _fail(f"{label} step {step}: launches {delta}, want {want} "
                  f"and nothing else")
        if routed != {"reverse_sweep": want.get("acdc_cascade_bwd", 0),
                      "per_layer_scan": 0}:
            _fail(f"{label} step {step}: cascade backward routes {routed}")
        steps.append(dict(loss=loss, grad_norm=float(metrics["grad_norm"]),
                          s=dt, launches=delta))
    counts = read_counts()
    for name, n in counts.items():
        totals[name] += n
    timed = [st["s"] for st in steps[1:]]
    s_step = sum(timed) / len(timed)
    info = dict(config=f"{arch} full width, bf16 compute, fp32 masters",
                global_batch=args.global_batch, seq_len=args.seq_len,
                steps=steps, s_per_step=s_step, tokens_per_s=tokens / s_step,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_step=want, frames_per_row=frames,
                launches=counts,
                grads=grads, fp32_limit_rel_l2=FP32_GRAD_REL_L2)
    print(f"[train] {label} ({smi_line()}): {s_step:.3f} s/step, "
          f"{info['tokens_per_s']:.1f} tokens/s, peak "
          f"{info['peak_mem_gb']:.2f} GB, launches a step {want}",
          flush=True)
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


# ---------------------------------------------------------------------------
# Phases 8 and 8b: overload at full width (deadlines, priorities, faults,
# obs), 8b speculative
# ---------------------------------------------------------------------------

#: the overload phase's fault plan: two corrupt-logit ticks (every slot's
#: ids are garbage and heal by requeue), a few denied pages, and three
#: consecutive simulated slow ticks after the watchdog's warm-up (not
#: slept: 30 s is added to what the watchdog sees), so the ladder must
#: step down to ``shed``
OVERLOAD_FAULTS = dict(seed=7, nan_ticks=(5, 13), p_alloc_fail=0.03,
                       slow_ticks=(8, 9, 10), slow_extra_s=30.0)

#: the speculative overload phase's plan: as ``OVERLOAD_FAULTS`` with three
#: runs of three slow ticks, so the speculative ladder must step down
#: through ``spec_half`` and ``spec_off`` to ``shed``
SPEC_OVERLOAD_FAULTS = dict(OVERLOAD_FAULTS,
                            slow_ticks=(8, 9, 10, 14, 15, 16, 20, 21, 22))


def overload_run(label, dev, totals, extra, faults, **build_overrides):
    """Serve full-width Qwen3-1.7B with ACDC projections, paged with
    16-token pages, through the launcher's ``build``/``serve`` (flags
    ``extra`` added, the config's fields ``build_overrides``): 4 slots, 10
    requests (prompts <= 64, 16 new tokens), a 600 s deadline on half of
    them (wide: no request may time out however slow the host), two
    priority bands, a metrics JSONL and a span trace, under the fault plan
    ``faults``.  Fails unless every request is terminal, the pool audits
    clean, a corrupt tick was healed by requeue, the trace holds one
    terminal per request, the last JSONL snapshot equals ``eng.stats``,
    and every ``eos``/``length`` stream is, segment by segment, exactly
    what a fault-free, deadline-free run with the same flags on the same
    weights generates from the same context: the segments are cut at the
    request's prefills (from the trace), the first from its prompt, each
    later one from its prompt plus the tokens before it.  (A re-prefill
    rounds in bf16 otherwise than the decode steps it replaces, so a
    requeued stream need not continue the undisturbed one token for token;
    how many do is reported.)  Returns (engine, info)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.serving import Engine, FaultPlan, Request
    from repro_torch.serving.engine import STATS_METRICS

    out_dir = ROOT / "build" / ("chip_smoke_" + label.replace(" ", "_"))
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    metrics_path, trace_path = out_dir / "metrics.jsonl", out_dir / "trace.json"
    args = serve.parse_args([
        "--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method", "pallas",
        "--slots", "4", "--prompt-len", "64", "--gen", "16", "--requests",
        "10", "--paged", "--block-size", "16", "--deadline-s", "600",
        "--priorities", "2", "--metrics-jsonl", str(metrics_path),
        "--metrics-every", "5", "--trace-out", str(trace_path),
        "--device", str(dev)] + extra)
    cfg, model, params = serve.build(args, **build_overrides)
    fault = FaultPlan(**faults)
    reset_counts()
    eng, reqs, dt = serve.serve(args, cfg, model, params, fault=fault)
    counts = read_counts()
    for name in ("scaled_matmul", "paged_attn"):
        if counts[name] == 0:
            _fail(f"{label}: kernel {name} never launched on this path")
    for name, n in counts.items():
        totals[name] += n
    s = dict(eng.stats)
    print(f"[{label}] stats {json.dumps(s)} | faults {fault.injected} | "
          f"{dt:.3f}s | launches {counts}", flush=True)
    serve.report(eng, reqs, dt, args.trace_out)

    if not all(r.done for r in reqs):
        _fail(f"{label}: requests left unfinished: "
              f"{[r.rid for r in reqs if not r.done]}")
    eng.allocator.audit()
    if eng.allocator.n_free != eng.allocator.n_blocks:
        _fail(f"{label}: pages leaked")
    if not (s["corrupt_ticks"] >= 1 and s["requeued"] >= 1):
        _fail(f"{label}: no corrupt tick healed by requeue ({s})")

    trace = json.loads(trace_path.read_text())
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    # each request's prefills in order: their contexts cut its stream into
    # segments, each the greedy continuation of the prompt plus the tokens
    # before it
    contexts = {}
    for e in sorted((e for e in trace["traceEvents"]
                     if e["ph"] == "X" and e["name"] == "prefill"),
                    key=lambda e: e["ts"]):
        contexts.setdefault(names[e["tid"]], []).append(e["args"]["ctx_len"])
    fresh = []
    for r in reqs:
        if r.finish_reason not in ("eos", "length"):
            continue
        starts = [c - r.prompt_len for c in contexts[f"req {r.rid}"]]
        for i, k in enumerate(starts):
            end = starts[i + 1] if i + 1 < len(starts) else len(r.generated)
            fresh.append((r, k, end, Request(
                rid=len(fresh), prompt=list(r.prompt) + r.generated[:k],
                max_new_tokens=r.max_new_tokens - k)))
    Engine(model, cfg, params, n_slots=args.slots,
           max_len=args.prompt_len + args.gen + 1,
           max_prompt_len=args.prompt_len, paged=True,
           block_size=args.block_size,
           spec_k=args.spec_k if args.spec else 0).run(
               [f for *_, f in fresh], max_ticks=4000)
    torch.cuda.synchronize(dev)
    for r, k, end, f in fresh:
        if r.generated[k:end] != f.generated[:end - k]:
            _fail(f"{label}: rid {r.rid} tokens {k}:{end} "
                  f"{r.generated[k:end]} != a fault-free run from the same "
                  f"context {f.generated[:end - k]}")
    if not fresh:
        _fail(f"{label}: no request finished normally")
    # the fault-free, deadline-free run of each prompt is its first
    # segment's run: how many whole streams it reproduces (a requeued
    # stream need not: a bf16 re-prefill rounds unlike the decode steps)
    undisturbed = sum(k == 0 and r.generated == f.generated
                      for r, k, _, f in fresh)
    requeued = [r for r in reqs if r.n_preemptions]

    terminals = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "i" and e["name"].startswith("terminal:"):
            terminals[e["tid"]] = terminals.get(e["tid"], 0) + 1
    per_req = {names[t]: n for t, n in terminals.items()}
    if per_req != {f"req {r.rid}": 1 for r in reqs}:
        _fail(f"{label}: terminals per request {per_req}")
    last = json.loads(metrics_path.read_text().splitlines()[-1])["metrics"]
    snap = {key: (last["gauges"] if kind == "gauge" else
                  last["counters"])[name][""]
            for key, (name, kind) in STATS_METRICS.items()
            if kind != "derived"}
    if any(snap[k] != s[k] for k in snap):
        _fail(f"{label}: last JSONL snapshot {snap} != stats {s}")
    return eng, dict(stats=s, faults=dict(fault.injected), wall_s=dt,
                     compute=cfg.dtype, launches=counts,
                     segments_checked=len(fresh),
                     streams_equal_undisturbed=undisturbed,
                     requeued_rids=[r.rid for r in requeued],
                     finish_reasons=[r.finish_reason for r in reqs],
                     degrade_level=eng.degrade_level,
                     snapshots=len(metrics_path.read_text().splitlines()))


def overload_full_width(dev, totals):
    """Phase 8: ``overload_run`` on the main path (bf16 compute, no
    speculation) under ``OVERLOAD_FAULTS``; fails also unless the ladder
    stepped down."""
    eng, info = overload_run("overload", dev, totals, [], OVERLOAD_FAULTS)
    if not info["stats"]["degrade_down"] >= 1:
        _fail(f"overload: the ladder never stepped down ({info['stats']})")
    return info


def overload_spec_full_width(dev, totals):
    """Phase 8b: ``overload_run`` speculative (``--spec --spec-k 4``) under
    ``SPEC_OVERLOAD_FAULTS``, in fp32 compute: the rungs run the verify at
    M = 20 (tensor cores), 12 and the decode at 4 (weight stream), which
    round apart, and in bf16 those differences grow into stream departures
    (PERF.md §6), so exact segments are held in fp32.  Fails also
    unless the ladder walked ``full`` -> ``spec_half`` -> ``spec_off`` ->
    ``shed`` and, on idle ticks after the run, back to ``full`` at the full
    speculation depth."""
    eng, info = overload_run("overload spec", dev, totals,
                             ["--spec", "--spec-k", str(SPEC_K)],
                             SPEC_OVERLOAD_FAULTS, dtype="float32")
    down = [i.args["dst"] for i in eng.obs.tracer.instants
            if i.name == "ladder" and i.args["direction"] == "down"]
    if down[:3] != ["spec_half", "spec_off", "shed"]:
        _fail(f"overload spec: the ladder stepped down {down}, not through "
              f"spec_half and spec_off to shed ({info['stats']})")
    # idle ticks after the run (the bundle is closed: export nothing more)
    # walk the ladder back up after sustained calm
    eng.obs.exporter = None
    for _ in range(3 * eng.degrade_up_after + 3):
        if eng.degrade_level == "full":
            break
        eng.tick()
    walk = [i.args["dst"] for i in eng.obs.tracer.instants
            if i.name == "ladder"]
    if eng.degrade_level != "full" or eng.spec_k_eff != SPEC_K:
        _fail(f"overload spec: the ladder did not walk back to full "
              f"({walk})")
    print(f"[overload spec] ladder {walk}", flush=True)
    info.update(ladder=walk, degrade_level=eng.degrade_level)
    return info


# ---------------------------------------------------------------------------
# Phase 9: where the time goes (torch.profiler, full width)
# ---------------------------------------------------------------------------

#: kernel names of each wrapper's one primary launch a call (a split-K
#: ``smm_reduce`` and a two-pass ``paged_combine`` follow some of them)
PRIMARY_KERNELS = {"scaled_matmul": ("smm_stream", "smm_tc"),
                   "paged_attn": ("paged_split",)}


def check_profile(label, logdir, summary, wrapper_counts,
                  regimes=None) -> dict:
    """A window's digest, held to its kernel events: the window must hold
    CUDA kernels, and each wrapper's primary kernels in the trace must
    number the wrapper's own launch count over the same window (with
    ``regimes``, ``smm_stream`` and ``smm_tc`` each the count of launches
    in that regime).  First the trace must be whole: every kernel launch
    call of the window with its device record (``window_launches_lost``;
    the records a session loses fall on the primer it opens with)."""
    if summary["kernels"] == 0:
        _fail(f"profile {label}: no CUDA kernel events in the window")
    if summary["window_launches_lost"]:
        _fail(f"profile {label}: the trace lost the device records of "
              f"{summary['window_launches_lost']} kernel launches of the "
              f"window ({summary['launches_lost']} lost in all, "
              f"{summary['primer_kernels']} primer kernels kept)")
    trace = json.loads((Path(logdir) / "trace.json").read_text())
    kernels = [e["name"] for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    seen = {name: sum(any(k in n for k in keys) for n in kernels)
            for name, keys in PRIMARY_KERNELS.items()}
    for name, n in seen.items():
        if n != wrapper_counts[name]:
            _fail(f"profile {label}: {n} {name} kernels in the trace, the "
                  f"wrapper counted {wrapper_counts[name]}")
    for regime, n in (regimes or {}).items():
        got = sum(f"smm_{regime}" in k for k in kernels)
        if got != n:
            _fail(f"profile {label}: {got} smm_{regime} kernels in the "
                  f"trace, {n} launches in that regime")
        seen[f"smm_{regime}"] = got
    keep = ROOT / "chiprun_out" / "profile" / label.replace(" ", "_")
    keep.mkdir(parents=True, exist_ok=True)
    for name in ("key_averages.txt", "summary.json"):
        shutil.copy(Path(logdir) / name, keep / name)
    s = summary
    print(f"[profile] {label} ({smi_line()}): {s['steps']} steps, host "
          f"{s['host_s_per_step'] * 1e3:.3f} ms a step, device busy "
          f"{s['device_busy_s'] / max(s['steps'], 1) * 1e3:.3f} ms a step "
          f"({s['device_busy_share']:.1%}), {s['kernels_per_step']:.1f} "
          f"kernels a step; wrappers {seen}; launch records lost "
          f"{s['launches_lost']}, all of them the primer's", flush=True)
    for name, cnt, sec in s["top"]:
        print(f"[profile]   {sec * 1e3:9.3f} ms {cnt:6d} x {name[:110]}",
              flush=True)
    return dict(summary, wrapper_launches=wrapper_counts)


def profile_ticks(label, root, pieces, dev, paged, spec_k, first, last):
    """A ``ProfileWindow`` over engine ticks ``first``..``last`` of a
    full-width run (4 slots, 4 requests, prompts <= 64, 16 new tokens),
    held by ``check_profile``; the window must hold steady ticks only
    (no admission, speculation depth ``spec_k``), and the tick times
    outside it are kept beside it.  The run stops after tick
    ``last + 3``: nothing later is read."""
    from repro_torch.obs import Observability, Prof, ProfileWindow
    from repro_torch.serving import Engine
    from repro_torch.serving.request import make_ragged_requests

    cfg, model, params = pieces
    window = ProfileWindow(f"{first}:{last}", str(root / label), dev)
    obs = Observability(window=window, prof=Prof(enabled=True))
    eng = Engine(model, cfg, params, n_slots=4, max_len=81,
                 max_prompt_len=64, paged=paged, block_size=16, obs=obs,
                 spec_k=spec_k)
    for r in make_ragged_requests(cfg.vocab_size, 4, 64, 16):
        eng.submit(r)
    tick, counts, tick_s = 0, {}, []
    with tick_recorder() as recs:
        while eng.has_work and tick <= last + 3:
            if tick in (first, last + 1):
                counts[tick] = read_counts()
            t0 = time.perf_counter()
            eng.tick()
            tick_s.append(time.perf_counter() - t0)
            tick += 1
    obs.close(tick)
    wrappers = {k: counts[last + 1][k] - counts[first][k]
                for k in counts[first]}
    inside = recs[first:last + 1]
    if any(r["prefills"] or r["k"] != spec_k for r in inside):
        _fail(f"profile {label}: ticks {first}..{last} are not steady "
              f"{inside}")
    regimes = {reg: sum(r["launches"].get(f"scaled_matmul_{reg}", 0)
                        for r in inside) for reg in ("stream", "tc")}
    info = check_profile(label, window.logdir, window.summary, wrappers,
                         regimes)
    # ticks 1 .. first - 1 and the two after last + 1: decode only,
    # outside the window (tick last + 1 pays the window's stop and trace
    # export)
    info["unprofiled_tick_s"] = tick_s[1:first] + tick_s[last + 2:last + 4]
    return info


def profile_full_width(dev):
    """``torch.profiler`` windows at full width: 2 steady decode ticks
    (ticks 4..5, every slot decoding, no admission) dense and paged and
    1 steady speculative tick paged (tick 4, ``spec_k`` 4, the
    depth-1 draft; their ``smm_stream`` / ``smm_tc`` kernels each held to
    the launches in that regime) through the ported ``ProfileWindow``,
    one 64-token prefill admission
    (a one-token request: its tick admits, samples and finishes), and one
    AdamW train step (B.S = 512) after two unprofiled ones.  Each window's
    digest (``obs.prof.summarize``) is printed and kept; the tick times
    outside the windows are kept beside them (the profiler's own host
    cost shows as the difference)."""
    import numpy as np
    import torch

    from repro_torch.dist import steps as steps_mod
    from repro_torch.launch import serve, train
    from repro_torch.obs import Observability, Prof, ProfileWindow
    from repro_torch.obs.prof import start_profiler, write_profile
    from repro_torch.serving import Engine, Request

    root = ROOT / "build" / "chip_smoke_profile"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    args = serve.parse_args([
        "--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method", "pallas",
        "--device", str(dev)])
    cfg, model, params = serve.build(args)
    for label, paged, spec_k, first, last in (
            ("decode dense", False, 0, 4, 5),
            ("decode paged", True, 0, 4, 5),
            ("spec paged", True, SPEC_K, 4, 4)):
        out[label] = profile_ticks(label, root, (cfg, model, params), dev,
                                   paged, spec_k, first, last)

    label = "prefill admission"
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, cfg.vocab_size, 64).tolist() for _ in range(2)]
    # the same admission unprofiled first: its wall time sits beside the
    # window's
    eng = Engine(model, cfg, params, n_slots=4, max_len=81,
                 max_prompt_len=64)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.run([Request(rid=0, prompt=prompts[0], max_new_tokens=1)])
    torch.cuda.synchronize(dev)
    unprofiled = time.perf_counter() - t0
    window = ProfileWindow("0:0", str(root / label), dev)
    obs = Observability(window=window, prof=Prof(enabled=True))
    eng = Engine(model, cfg, params, n_slots=4, max_len=81,
                 max_prompt_len=64, obs=obs)
    before = read_counts()
    with no_sweeps(f"profile {label}"):
        eng.run([Request(rid=1, prompt=prompts[1], max_new_tokens=1)])
        obs.close(1)
    after = read_counts()
    info = check_profile(label, window.logdir, window.summary,
                         {k: after[k] - before[k] for k in after})
    info["unprofiled_tick_s"] = [unprofiled]
    out[label] = info
    del eng, params
    torch.cuda.empty_cache()

    label = "train step"
    targs = train.parse_args([
        "--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method", "pallas",
        "--global-batch", "4", "--seq-len", "128", "--steps", "3",
        "--device", str(dev)])
    tcfg, tmodel, opt, train_step, pipeline = train.build(targs)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_state(tmodel, tcfg, opt, gen, dev)
    unprofiled = []
    for step in range(2):           # set-up, then one unprofiled step
        t0 = time.perf_counter()
        state, _ = train_step(state, train.batch_on(pipeline, step, dev))
        torch.cuda.synchronize(dev)
        unprofiled.append(time.perf_counter() - t0)
    batch = train.batch_on(pipeline, 2, dev)
    torch.cuda.synchronize(dev)
    before = read_counts()
    with no_sweeps(f"profile {label}"):
        prof, primer = start_profiler(dev)
        t0 = time.perf_counter()
        state, _ = train_step(state, batch)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        prof.stop()
    after = read_counts()
    summary = write_profile(prof, str(root / label), 1, wall, primer=primer)
    info = check_profile(label, root / label, summary,
                         {k: after[k] - before[k] for k in after})
    info["unprofiled_tick_s"] = unprofiled[1:]
    out[label] = info
    del state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Paths A - D: the reference's default method (``auto``), ``fft`` and
# ``matmul`` at full width and at smoke width with every SELL kind, and
# the paper's Figure 2 on the card
# ---------------------------------------------------------------------------

#: fp32 logits of the full-width model, the reference's routes (``auto``;
#: ``fft`` and ``matmul`` at every size) against the ``pallas`` route on
#: the same weights: relative L2.  Both compute the same function in fp32
#: and differ in summation order only, so they differ by at most the sum
#: of their drifts from an fp64 evaluation (measured and reported beside
#: it).  The pallas route's drift was ~1e-5 (ROADMAP.md section 3, PR 16);
#: an FFT sums O(log N) terms an output where a matmul sums N, so the
#: other routes should drift no more and the sum stays ~2e-5; the limit
#: leaves 5 x above that, and 1000 x below the bf16 limit
FP32_METHOD_REL_L2 = 1e-4

#: path C: every SELL kind, and ``--sell acdc`` at ``fft`` and ``matmul``
#: for each transform family, at smoke width: (label, flags, paged)
SMOKE_METHODS = (
    ("low_rank", ["--sell", "low_rank"], False),
    ("circulant", ["--sell", "circulant"], False),
    ("fastfood", ["--sell", "fastfood"], False),
    *((f"acdc {m} {f}", ["--sell", "acdc", "--sell-method", m,
                         "--sell-transform", f], False)
      for m in ("fft", "matmul") for f in ("acdc", "circulant", "hadamard")),
    ("acdc fft acdc paged", ["--sell", "acdc", "--sell-method", "fft"],
     True),
)

#: path D: the layer sizes of the paper's Figure 2 (and Qwen3's d_ff)
FIG2_SIZES = (128, 256, 512, 1024, 2048, 4096, 6144, 8192)

#: path D: rows a call, as ``benchmarks/bench_fig2_speed.py`` uses
FIG2_ROWS = 128


@contextlib.contextmanager
def sell_in_fp64():
    """Every SELL projection evaluated in fp64 (input and parameters
    upcast, the result rounded back to the activation dtype): the fp64
    pass of the routes without kernels (``auto``, ``fft``, ``matmul`` and
    the baseline kinds).  Comparisons only."""
    from repro_torch.core import sell as sell_mod

    saved = sell_mod.structured_linear

    def fp64(params, x, cfg):
        p64 = {k: v.double() for k, v in params.items()}
        return saved(p64, x.double(), cfg).to(x.dtype)

    sell_mod.structured_linear = fp64
    try:
        yield
    finally:
        sell_mod.structured_linear = saved


@contextlib.contextmanager
def acdc_without_d():
    """A deliberately faulty ACDC layer on the routes without kernels
    that drops ``d``: a control for the cross-route logit limits."""
    import torch

    from repro_torch.core import acdc as acdc_mod

    saved = acdc_mod.acdc

    def faulty(x, a, d, bias=None, **kw):
        return saved(x, a, torch.ones_like(d), bias, **kw)

    acdc_mod.acdc = faulty
    try:
        yield
    finally:
        acdc_mod.acdc = saved


def sell_diagonals_in_bf16(params):
    """``params`` with every SELL diagonal rounded to bf16 (and back to
    fp32): a 2^-9 perturbation of the weights, the size of the rounding a
    bf16 route applies to its own operands."""
    import torch

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return node.to(torch.bfloat16).float() if "/sell/" in path \
            else node

    return walk(params, "")


def compare_methods_logits(pieces, dev) -> dict:
    """One prefill's and one decode step's logits on the reference's
    routes (``auto``, ``fft``, ``matmul``) against the ``pallas`` route,
    same weights, each route's drift from an fp64 evaluation
    (``sell_in_fp64`` on the ``matmul`` route) beside it, and a faulty
    ``auto`` route that drops ``d`` (``acdc_without_d``) that must read
    over each limit held.

    fp32 compute: every route within ``FP32_METHOD_REL_L2``, prefill and
    decode.  bf16 compute: ``auto`` within ``BF16_LOGIT_REL_L2`` on the
    decode step.  The bf16 prefill is reported, not held: the routes
    round their own weights differently (``matmul`` multiplies by the DCT
    matrix in the activation dtype, as the reference does, and casts the
    diagonals down), and the prefill's last-position logits move by
    ~0.07 under a 2^-9 perturbation of the SELL diagonals alone even in
    fp32 compute (``weight_rounding_fp32`` below, measured every run; the
    decode step's by ~0.007), so at the prefill no bf16 limit tells a
    fault from the reference's rounding."""
    cfg, model, params = pieces

    def probe(dtype, method, ctx=contextlib.nullcontext, p=params):
        with ctx():
            return probe_logits(model, dataclasses.replace(
                cfg, dtype=dtype, sell_method=method), p, dev)

    methods = ("auto", "fft", "matmul")
    out = {"limit_bf16": BF16_LOGIT_REL_L2, "limit_fp32": FP32_METHOD_REL_L2}
    rounded = sell_diagonals_in_bf16(params)
    for dtype, limit in (("bfloat16", BF16_LOGIT_REL_L2),
                         ("float32", FP32_METHOD_REL_L2)):
        runs = {m: probe(dtype, m) for m in ("pallas",) + methods}
        runs["fp64"] = probe(dtype, "matmul", sell_in_fp64)
        runs["auto_without_d"] = probe(dtype, "auto", acdc_without_d)
        if dtype == "float32":
            runs["weight_rounding"] = probe(dtype, "pallas", p=rounded)
        for where in ("prefill", "decode"):
            row = {f"{m}_vs_pallas": _rel_l2(runs[m][where],
                                              runs["pallas"][where])
                   for m in runs if m not in ("pallas", "fp64")}
            row.update({f"{m}_vs_fp64": _rel_l2(runs[m][where],
                                                runs["fp64"][where])
                        for m in ("pallas",) + methods})
            held = dtype == "float32" or where == "decode"
            out[f"{dtype} {where}"] = dict(row, held=held)
            print(f"[methods] full width {dtype} {where} ({smi_line()}): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in row.items())
                  + (f" (limit {limit} on the routes vs pallas)" if held
                     else " (reported)"), flush=True)
            if not held:
                continue
            for m in methods if dtype == "float32" else ("auto",):
                if not row[f"{m}_vs_pallas"] <= limit:
                    _fail(f"full-width {dtype} {where} logits: {m} vs "
                          f"pallas rel L2 {row[f'{m}_vs_pallas']} > {limit}")
            if not row["auto_without_d_vs_pallas"] > limit:
                _fail(f"full-width {dtype} {where} logits: the limit {limit}"
                      f" does not catch the faulty route (rel L2 "
                      f"{row['auto_without_d_vs_pallas']})")
    return out


def methods_full_width(pieces, dev, totals) -> dict:
    """Path A: full-width Qwen3-1.7B served with ``--sell acdc
    --sell-method auto`` (matmul at N = 2048, fft at N = 6144; bf16
    compute, fp32 masters) on phase 4's weights, dense then paged with
    phase 4's requests: every tick's launches exact (no SELL kernel, one
    ``paged_attn`` a layer on the paged layout), s/tick, tok/s, prefill
    s/admission; and the logits against the ``pallas`` route
    (``compare_methods_logits``).  (Its profiled windows of 8 decode
    ticks a layout were cut to keep the whole run in its time; PERF.md
    keeps the last profile of this route.)"""
    import torch

    from repro_torch.launch import serve

    cfg, model, params = pieces
    auto = (dataclasses.replace(cfg, sell_method="auto"), model, params)
    base = ["--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method",
            "auto", "--slots", "4", "--prompt-len", "64", "--gen", "16",
            "--requests", "8", "--device", "cuda"]
    out = {"routes": serve.sell_routes(auto[0])}
    print(f"[methods] full width auto: {out['routes']}", flush=True)
    for paged in (False, True):
        name = "paged" if paged else "dense"
        label = f"full width auto {name}"
        info, _, eng, recs = serve_path(
            label, base + (["--paged"] if paged else []), auto, totals,
            ("paged_attn",) if paged else (), record=True)
        info["ticks"] = check_ticks(label, eng, recs, 64, spec=False)
        info["prefill_s_per_admission"] = info["prefill_s"] / max(
            info["prefills"], 1)
        out[name] = info
    out["logits"] = compare_methods_logits(pieces, dev)
    torch.cuda.empty_cache()
    return out


def train_methods_full_width(dev, totals, arch="qwen3_1_7b") -> dict:
    """Path B: full-width training at ``--sell-method auto`` (bf16
    compute, fp32 masters, global batch 4 x 128): one step's fp32 loss and
    per-group grads against the ``pallas`` route on the same state (within
    ``FP32_GRAD_REL_L2``), then one warm-up and two timed AdamW steps that
    launch no SELL kernel: s/step, tokens/s, peak memory."""
    import torch

    from repro_torch.dist import steps as steps_mod
    from repro_torch.launch import train

    args = train.parse_args([
        "--arch", arch, "--sell", "acdc", "--sell-method", "auto",
        "--global-batch", "4", "--seq-len", "128", "--steps", "3",
        "--device", str(dev)])
    label = "full width" + ("" if arch == "qwen3_1_7b" else f" {arch}")
    cfg, model, opt, train_step, pipeline = train.build(args)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps_mod.init_state(model, cfg, opt, gen, dev)
    batch = train.batch_on(pipeline, 0, dev)
    runs = {m: steps_mod.loss_and_grads(model, dataclasses.replace(
        cfg, dtype="float32", sell_method=m), state["params"], batch)
        for m in ("auto", "pallas")}
    torch.cuda.synchronize()
    loss_a, loss_p = float(runs["auto"][0]), float(runs["pallas"][0])
    grads = dict(loss_auto=loss_a, loss_pallas=loss_p,
                 loss_rel_diff=abs(loss_a - loss_p) / abs(loss_p),
                 rel_l2=group_rel_l2(runs["auto"][1], runs["pallas"][1],
                                     grad_groups(cfg)),
                 limit=FP32_GRAD_REL_L2)
    del runs
    torch.cuda.empty_cache()
    print(f"[grads] {label} fp32, auto vs pallas ({smi_line()}): loss "
          f"{loss_a:.6f} / {loss_p:.6f} | rel L2 " + ", ".join(
              f"{g} {v:.3e}" for g, v in grads["rel_l2"].items()),
          flush=True)
    worst = max(grads["rel_l2"].values())
    if not (worst <= FP32_GRAD_REL_L2
            and grads["loss_rel_diff"] <= FP32_GRAD_REL_L2):
        _fail(f"{label} fp32 auto vs pallas: grads rel L2 {worst}, "
              f"loss {grads['loss_rel_diff']} (limit {FP32_GRAD_REL_L2})")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = train_step(state, train.batch_on(pipeline, step,
                                                          dev))
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        loss = float(metrics["loss"])
        print(f"[train] {label} auto step {step}: loss {loss:.4f} |g| "
              f"{float(metrics['grad_norm']):.3f} {dt:.3f}s", flush=True)
        if not math.isfinite(loss):
            _fail(f"{label} auto step {step}: loss {loss}")
        steps.append(dict(loss=loss, grad_norm=float(metrics["grad_norm"]),
                          s=dt))
    counts = read_counts()
    if any(counts.values()):
        _fail(f"{label} auto training launched kernels {counts}")
    s_step = sum(st["s"] for st in steps[1:]) / (len(steps) - 1)
    tokens = args.global_batch * args.seq_len
    info = dict(config=f"{arch} full width, bf16 compute, fp32 masters, "
                "--sell-method auto", global_batch=args.global_batch,
                seq_len=args.seq_len, steps=steps, s_per_step=s_step,
                tokens_per_s=tokens / s_step,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=counts, grads=grads)
    print(f"[train] {label} auto ({smi_line()}): {s_step:.3f} s/step, "
          f"{info['tokens_per_s']:.1f} tokens/s, peak "
          f"{info['peak_mem_gb']:.2f} GB, launches {counts}", flush=True)
    del state
    torch.cuda.empty_cache()
    return info


def smoke_methods(totals, dev) -> list:
    """Path C: the smoke decoder (fp32) served with every SELL kind and,
    for ``--sell acdc``, ``fft`` and ``matmul`` over each transform family
    (``SMOKE_METHODS``), 4 slots, 4 requests: every tick's launches exact
    (no SELL kernel; ``paged_attn`` on the paged layout); the greedy
    streams equal the same model with its SELL projections in fp64
    (``sell_in_fp64``), or differ at a near-tie (``near_tie``)."""
    from repro_torch.launch import serve

    base = ["--arch", "qwen3_1_7b", "--smoke", "--slots", "4",
            "--prompt-len", "12", "--gen", "8", "--requests", "4",
            "--device", "cuda"]
    out = []
    for name, flags, paged in SMOKE_METHODS:
        argv = base + flags + (["--paged", "--block-size", "4"]
                               if paged else [])
        label = f"smoke {name}"
        pieces = serve.build(serve.parse_args(argv))
        info, reqs, eng, recs = serve_path(label, argv, pieces, totals,
                                           ("paged_attn",) if paged else (),
                                           record=True)
        info["ticks"] = check_ticks(label, eng, recs, 12, spec=False)
        with sell_in_fp64():
            want = streams_of(serve_path(label + " (fp64)", argv, pieces,
                                         {k: 0 for k in KERNEL_MODULES},
                                         ())[1])
        info["vs_fp64"] = compare_streams(
            label + " fp32 vs fp64", pieces, [r.prompt for r in reqs],
            streams_of(reqs), want, dev, hold=True, fp64=sell_in_fp64)
        out.append(info)
    return out


def fig2_work(route: str, m: int, n: int):
    """(bytes, flops) one Figure-2 call must move and do: x read and y
    written once, the diagonals (and the route's N x N operands) read
    once; flops: two N x N products a row (``matmul``, ``pallas``), one
    (``dense``), or two length-N complex FFTs a row at the standard
    5 N log2 N each (``fft``), plus the diagonal products."""
    io = 4 * (2 * m * n + 2 * n)
    if route == "dense":
        return 4 * (2 * m * n + n * n), 2 * m * n * n
    if route == "fft":
        return io, 2 * 5 * m * n * math.log2(n) + 2 * m * n
    return io + 4 * 2 * n * n, 4 * m * n * n + 2 * m * n


def fig2_speed(dev) -> list:
    """Path D, the paper's Figure 2 on the card: one ACDC layer (K = 1,
    fp32, ``FIG2_ROWS`` rows, random diagonals, no bias) at each of
    ``FIG2_SIZES``, by device time (``device_ms``) on the ``fft`` and
    ``matmul`` routes, the ``pallas`` route (``acdc_fused`` at N <= 1024,
    two ``scaled_matmul`` calls above) and a dense fp32 ``x @ W`` with the
    layer's matrix rounded to fp32; each beside its bound (``fig2_work``)
    and its fp32 error against an fp64 evaluation of its own function
    (``drift``).  The ACDC routes' errors must stay within 2 x the
    ``matmul`` route's; the dense baseline's is reported (an fp32 ``x @
    W`` with W near the identity sums N terms where an orthonormal
    transform spreads them, and reads ~2 x the ``matmul`` route's at N =
    2048 on the CPU)."""
    import torch

    from repro_torch.core import acdc as acdc_mod
    from repro_torch.core import transforms
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for n in FIG2_SIZES:
        m = FIG2_ROWS
        x = torch.randn((m, n), generator=gen, device=dev)
        a = 1.0 + 0.1 * torch.randn((n,), generator=gen, device=dev)
        d = 1.0 + 0.1 * torch.randn((n,), generator=gen, device=dev)
        c64 = transforms.dct_matrix(n, torch.float64, dev)
        w64 = (a.double()[:, None] * c64 * d.double()[None, :]) @ c64.T
        want = x.double() @ w64
        w = w64.float()
        fns = {"fft": lambda: acdc_mod.acdc(x, a, d, method="fft"),
               "matmul": lambda: acdc_mod.acdc(x, a, d, method="matmul"),
               "pallas": lambda: ops.acdc_fused_op(x, a, d),
               "dense": lambda: x @ w}
        # the dense layer's own function has the fp32-rounded W
        wants = dict.fromkeys(fns, want)
        wants["dense"] = x.double() @ w.double()
        row = dict(n=n, rows=m)
        with torch.no_grad():
            for route, fn in fns.items():
                ms, host_us = device_ms(fn)
                b, by = bound_ms(*fig2_work(route, m, n))
                row[route] = dict(ms=ms, host_us=host_us, bound_ms=b,
                                  bound_by=by, fp32_err_vs_fp64=drift(
                                      fn(), wants[route]))
        del c64, w64, want, w, wants
        print(f"[fig2] N={n} ({smi_line()}): " + "; ".join(
            f"{r} {row[r]['ms']:.4f} ms (bound {row[r]['bound_ms']:.4f} by "
            f"{row[r]['bound_by']}, err {row[r]['fp32_err_vs_fp64']:.2e})"
            for r in fns), flush=True)
        for route in ("fft", "pallas"):
            if not (row[route]["fp32_err_vs_fp64"]
                    <= 2 * row["matmul"]["fp32_err_vs_fp64"]):
                _fail(f"fig2 N={n}: {route} fp32 error "
                      f"{row[route]['fp32_err_vs_fp64']} > 2 x matmul's")
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Paths E and F: the dense decoder configs and the MoE layer
# ---------------------------------------------------------------------------

#: the fp32 masters (GB) reckoned from the configs before the first run
#: (PERF.md section 4), printed beside each full-width phase's measured
#: parameter bytes and peak memory
RECKONED_MASTERS_GB = {"deepseek_67b": 35.0, "gemma3_27b": 16.6,
                       "chatglm3_6b": 3.2, "deepseek_moe_16b": 2.3,
                       "mamba2_1_3b": 0.43, "zamba2_1_2b": 0.33,
                       "llava_next_34b": 17.7,
                       "seamless_m4t_large_v2": 1.98}

#: the depth of the full-width configs on the paths that ``cut_depth``
#: runs (F - J, K, L and phases 8 / 8b): every width is the published one,
#: the layers are cut so the whole run keeps inside its time limit (PERF.md
#: has their times at full depth)
CUT_DEPTH = {"qwen3_1_7b": dict(n_layers=8),
             "deepseek_moe_16b": dict(n_layers=8),
             "mamba2_1_3b": dict(n_layers=12),
             "zamba2_1_2b": dict(n_layers=12),
             "llava_next_34b": dict(n_layers=20),
             "seamless_m4t_large_v2": dict(n_layers=6, n_encoder_layers=6)}


@contextlib.contextmanager
def cut_depth():
    """Inside, every full config the launchers look up
    (``registry.get_config``) has the depth of ``CUT_DEPTH``; the smoke
    configs are left as they are."""
    from repro_torch.configs import registry

    full = registry.get_config

    def get_config(arch):
        return dataclasses.replace(full(arch), **CUT_DEPTH.get(arch, {}))

    registry.get_config = get_config
    try:
        yield
    finally:
        registry.get_config = full


def depth_note(cfg) -> str:
    """`` (N of M layers)`` where ``cut_depth`` cut ``cfg``, else ''."""
    from repro_torch.configs import registry

    full = registry._module(
        next(a for a in registry.ARCHS
             if registry._module(a).CONFIG.name == cfg.name)).CONFIG
    return ("" if full.n_layers == cfg.n_layers
            else f" ({cfg.n_layers} of {full.n_layers} layers)")

#: path E, full width: (arch, requests, paged, then speculative paged)
DENSE_FULL_WIDTH = (("gemma3_27b", 4, True, False),
                    ("chatglm3_6b", 4, True, True),
                    ("deepseek_67b", 2, False, False))

#: the Gemma3-27B window probe: one prompt this long (past the 1024
#: window of its local layers)
WINDOW_PROMPT = 1280


def params_gb(params) -> float:
    from repro_torch.optim.optimizers import tree_flatten

    return sum(t.numel() * t.element_size()
               for t in tree_flatten(params)[1]) / 1e9


def release_memory() -> None:
    """Free the card between phases: the objects of earlier phases that
    sit in reference cycles until the collector runs (an engine and its
    scheduler hold each other through the scheduler's admission test, and
    with them a model's weights), and
    the cached transform matrices (an N = 22016 fp32 C and C^T take 3.9 GB
    on the card; the numpy-built ones' fp64 source as much on the
    host)."""
    import torch

    from repro_torch.core import transforms
    from repro_torch.kernels import ops

    ops._mats.cache_clear()
    transforms._constant.cache_clear()
    transforms._dct_matrix_np.cache_clear()
    transforms._dct_matrix_cuda.cache_clear()
    transforms._idct_matrix_cuda.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def build_matrices(cfg, dev) -> float:
    """Make the fp32 C, C^T of each two-call operating size of ``cfg``
    before anything is timed (set-up, seconds)."""
    import torch

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    for n in sorted({p[0] for p in sell_projections(cfg, 1)}):
        if n > ops.MAX_FUSED_N:
            ops._mats("acdc", n, dev, False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@contextlib.contextmanager
def route_recorder(calls: list):
    """Record every MoE routing's expert choices (``gate_idx``, sorted
    within each token) into ``calls``."""
    import torch

    from repro_torch.models import mlp as mlp_mod

    saved = mlp_mod._routing

    def recording(xt, params, cfg, rows=None):
        out = saved(xt, params, cfg, rows)
        calls.append(torch.sort(out[1], dim=-1).values.cpu())
        return out

    mlp_mod._routing = recording
    try:
        yield calls
    finally:
        mlp_mod._routing = saved


def scaled_matmul_group0(x, w, pre=None, post=None, bias=None):
    """A deliberately faulty grouped scaled_matmul that scales every group
    by group 0's vectors (every expert with expert 0's diagonals): a
    control for the MoE logit limit."""
    from repro_torch.kernels import ref

    def first(v):
        return v if v is None or v.dim() == 1 else v[:1].expand_as(v)

    return ref.scaled_matmul_ref(x, w, first(pre), first(post), first(bias))


def logits_vs_plain(label, pieces, dev, limit, faulty, dtype=None,
                    hold=("prefill", "decode"), prefix=None) -> dict:
    """One prefill's and one decode step's logits (``probe_logits``) with
    the kernels against the plain versions on the card, at ``dtype``
    compute (else the config's), and under ``faulty()`` (a deliberately
    faulty path); where named in ``hold``, kernels vs plain within
    ``limit`` and the faulty path over it, the rest reported.  For an MoE
    model, the share of (token, slot) expert choices that agree between
    kernels and plain versions beside.  ``prefix``: a vision frontend's
    embeddings before the probe's tokens (``probe_logits``); the kernels
    with the prefix zeroed are then a second control that must read over
    the limit (the prefix reaches the logits)."""
    import torch

    cfg, model, params = pieces
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    runs, routes = {}, {}
    sides = [("kernel", contextlib.nullcontext, prefix),
             ("plain", plain_kernels, prefix), ("faulty", faulty, prefix)]
    if prefix is not None:
        sides.append(("zero_prefix", contextlib.nullcontext,
                      torch.zeros_like(prefix)))
    for name, ctx, pre in sides:
        calls = []
        with ctx(), route_recorder(calls):
            runs[name] = probe_logits(model, cfg, params, dev, pre)
        routes[name] = calls
    torch.cuda.synchronize()
    out = dict(limit_rel_l2=limit, compute=cfg.dtype, held=list(hold))
    controls = [side[0] for side in sides[2:]]
    for where in ("prefill", "decode"):
        out[where] = {f"{a}_vs_plain": _rel_l2(runs[a][where],
                                                runs["plain"][where])
                      for a in ["kernel"] + controls}
    if cfg.n_experts:
        same = sum(int((a == b).sum())
                   for a, b in zip(routes["kernel"], routes["plain"]))
        out["expert_choices_agree"] = same / sum(
            a.numel() for a in routes["plain"])
    print(f"[logits] {label} {cfg.dtype} ({smi_line()}): "
          + "; ".join(f"{w} " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in out[w].items())
                      for w in ("prefill", "decode"))
          + (f"; expert choices agree {out['expert_choices_agree']:.4f}"
             if cfg.n_experts else "")
          + (f" (limit {limit} on {', '.join(hold)})" if hold
             else " (reported)"), flush=True)
    for where in hold:
        rel = out[where]
        if not rel["kernel_vs_plain"] <= limit:
            _fail(f"{label} {cfg.dtype} {where} logits: kernels vs plain "
                  f"rel L2 {rel['kernel_vs_plain']} > {limit}")
        for name in controls:
            if not rel[f"{name}_vs_plain"] > limit:
                _fail(f"{label} {cfg.dtype} {where} logits: the limit "
                      f"{limit} does not catch the {name} control (rel L2 "
                      f"{rel[f'{name}_vs_plain']})")
    return out


def tick_floor_ms(cfg) -> float:
    """The least time of one decode tick of ``cfg`` on the card: the
    bytes every tick must read (each two-call ACDC layer's fp32 C or C^T
    of every projection instance, each dense projection's fp32 master,
    the fp32 embedding table the unembedding reads) over the HBM rate."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import linear

    nbytes = sum(count * cfg.sell_k * 2 * n * n * 4
                 for n, _, _, count, _ in sell_projections(cfg, 1)
                 if n > ops.MAX_FUSED_N)
    nbytes += sum(count * n_in * n_out * 4
                  for role, n_in, n_out, count in serve.projections(cfg)
                  if not linear.uses_sell(cfg, role))
    nbytes += cfg.vocab_size * cfg.d_model * 4
    return nbytes / HBM_BYTES_S * 1e3


def serve_full_width(label, argv, pieces, totals, paged, spec=False):
    """``serve_path`` of a full-width config with every tick's launches
    exact (``check_ticks``), s/tick, tok/s, prefill s/admission and peak
    memory since the caller's reset."""
    if spec:
        argv = argv + ["--spec", "--spec-k", str(SPEC_K)]
    info, reqs, eng, recs = serve_path(
        label, argv + (["--paged", "--block-size", "16"] if paged else []),
        pieces, totals, ("scaled_matmul",) + (("paged_attn",) if paged
                                              else ()), record=True)
    info["streams"] = streams_of(reqs)
    info["ticks"] = check_ticks(label, eng, recs, eng.max_prompt_len,
                                spec=spec)
    info["prefill_s_per_admission"] = info["prefill_s"] / max(
        info["prefills"], 1)
    info["tick_floor_ms"] = tick_floor_ms(pieces[0])
    print(f"[serve] {label}: {info['s_per_tick'] * 1e3:.1f} ms a tick "
          f"(weight-read floor {info['tick_floor_ms']:.1f} ms), "
          f"{info['tok_per_s']:.2f} tok/s, prefill "
          f"{info['prefill_s_per_admission']:.3f} s an admission, peak "
          f"{info['peak_mem_gb']:.2f} GB; launches a tick by kind "
          f"{json.dumps(info['ticks'])}", flush=True)
    return info


def window_full_width(pieces, dev) -> dict:
    """Gemma3-27B at ``--sell-method auto`` in fp32 compute, one request
    of a ``WINDOW_PROMPT``-token prompt through the paged admission step
    (16-token pages) and one paged decode step: the 1024 window binds on
    the local layers at prefill and decode.  The logits with the
    ``paged_attn`` kernel against the plain paged attention within
    ``FP32_METHOD_REL_L2``; the same model with every layer global must
    read over it."""
    import numpy as np
    import torch

    from repro_torch.dist import steps as steps_mod

    cfg, model, params = pieces
    cfg = dataclasses.replace(cfg, sell_method="auto", dtype="float32")
    n, bs = WINDOW_PROMPT, 16
    mb = -(-(n + 1) // bs)
    rs = np.random.RandomState(5)
    toks = torch.tensor(rs.randint(0, cfg.vocab_size, size=(1, n)),
                        dtype=torch.int32, device=dev)
    nxt = torch.tensor([rs.randint(0, cfg.vocab_size)], dtype=torch.int32,
                       device=dev)
    tables = torch.arange(mb, dtype=torch.int32, device=dev)[None]
    pos = torch.tensor([n], dtype=torch.int32, device=dev)

    def run(c):
        cache = model.init_cache_paged(c, 1, mb, bs, dev)
        step = steps_mod.make_prefill_step(model, c, paged=True)
        last, cache = step(params, cache, model.init_cache(c, 1, mb * bs,
                                                           dev),
                           toks, pos, tables[0])
        dlog, _ = model.decode_step_paged(params, cache, nxt, pos, tables, c)
        return {"prefill": last[0].float(), "decode": dlog[0].float()}

    reset_counts()
    runs = {"kernel": run(cfg)}
    torch.cuda.synchronize()
    launched = read_counts()
    with plain_kernels():
        runs["plain"] = run(cfg)
        runs["global"] = run(dataclasses.replace(cfg, sliding_window=0))
    torch.cuda.synchronize()
    out = dict(prompt=n, window=cfg.sliding_window,
               local_layers=int(sum(w > 0 for w in cfg.layer_windows())),
               launches=launched, limit=FP32_METHOD_REL_L2)
    for where in ("prefill", "decode"):
        out[where] = {f"{a}_vs_plain": _rel_l2(runs[a][where],
                                                runs["plain"][where])
                      for a in ("kernel", "global")}
    print(f"[window] gemma3_27b full width auto fp32, {n}-token prompt, "
          f"window {cfg.sliding_window} on {out['local_layers']} of "
          f"{cfg.n_layers} layers ({smi_line()}): "
          + "; ".join(f"{w} " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in out[w].items())
                      for w in ("prefill", "decode"))
          + f" (limit {FP32_METHOD_REL_L2}) | launches {launched}",
          flush=True)
    want = {k: 0 for k in launched}
    want["paged_attn"] = cfg.n_layers
    if launched != want:
        _fail(f"gemma3 window probe launched {launched}, want {want}")
    for where in ("prefill", "decode"):
        rel = out[where]
        if not rel["kernel_vs_plain"] <= FP32_METHOD_REL_L2:
            _fail(f"gemma3 window {where} logits: kernel vs plain rel L2 "
                  f"{rel['kernel_vs_plain']} > {FP32_METHOD_REL_L2}")
        if not rel["global_vs_plain"] > FP32_METHOD_REL_L2:
            _fail(f"gemma3 window {where} logits: the window does not bind "
                  f"(global attention rel L2 {rel['global_vs_plain']})")
    return out


def dense_configs_full_width(dev, totals) -> dict:
    """Path E at full width: Gemma3-27B, ChatGLM3-6B (then speculative,
    ``--spec-k 4``: 80 verify rows a KV head) and DeepSeek-67B served with
    ``--sell acdc --sell-method pallas``, bf16 compute (``serve_full_width``),
    one decode step's logits against the plain versions within
    ``BF16_DECODE_REL_L2`` (so within ``BF16_LOGIT_REL_L2``) with the
    diagonals-dropped control over it and one prefill's reported, peak
    memory beside the reckoned fp32 masters; Gemma3 also through
    ``window_full_width``."""
    import torch

    out = {}
    release_memory()
    for arch, requests, paged, spec in DENSE_FULL_WIDTH:
        argv = ["--arch", arch, "--sell", "acdc", "--sell-method", "pallas",
                "--slots", "4", "--prompt-len", "64", "--gen", "8",
                "--requests", str(requests), "--device", "cuda"]
        t0 = time.perf_counter()
        pieces = model_for({}, argv)
        info = dict(init_s=time.perf_counter() - t0,
                    params_gb=params_gb(pieces[2]),
                    reckoned_masters_gb=RECKONED_MASTERS_GB[arch],
                    matrices_s=build_matrices(pieces[0], dev))
        torch.cuda.reset_peak_memory_stats()
        name = f"{arch} full width {'paged' if paged else 'dense'}"
        info["serve"] = serve_full_width(name, argv, pieces, totals, paged)
        if spec:
            info["spec"] = serve_full_width(f"{arch} full width spec paged",
                                            argv, pieces, totals, True,
                                            spec=True)
        # bf16: the decode step held, the prefill reported (its last
        # position amplifies one bf16 ulp of the weights' rounding past
        # any limit that tells a fault: PERF.md, PR 18)
        info["logits"] = logits_vs_plain(
            f"{arch} full width", pieces, dev, BF16_DECODE_REL_L2,
            lambda: scaled_matmul_as(scaled_matmul_without_pre),
            hold=("decode",))
        info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[memory] {arch} full width ({smi_line()}): peak "
              f"{info['peak_mem_gb']:.2f} GB; fp32 masters "
              f"{info['params_gb']:.2f} GB (reckoned "
              f"{info['reckoned_masters_gb']}); init {info['init_s']:.1f} s,"
              f" transform matrices {info['matrices_s']:.1f} s", flush=True)
        if arch == "gemma3_27b":
            info["window"] = window_full_width(pieces, dev)
        out[arch] = info
        del pieces
        release_memory()
    return out


def train_vs_plain(arch, steps, totals) -> dict:
    """``steps`` smoke-width AdamW steps of ``arch`` (fp32, ``--sell acdc
    --sell-method pallas``, batch 4 x 64) through the launcher's
    ``build``/``run``: the backward kernels launched, the losses against
    the plain versions within ``FP32_LOSS_RTOL``."""
    from repro_torch.launch import train

    root = ROOT / "build" / "chip_smoke_ckpt_archs"
    shutil.rmtree(root / arch, ignore_errors=True)

    def args_for(side):
        return train.parse_args([
            "--arch", arch, "--smoke", "--sell", "acdc", "--sell-method",
            "pallas", "--global-batch", "4", "--seq-len", "64", "--steps",
            str(steps), "--log-every", "1", "--device", "cuda",
            "--ckpt-dir", str(root / arch / side)])

    args = args_for("kernel")
    reset_counts()
    _, hist = train.run(args, *train.build(args))
    counts = read_counts()
    for name in ("acdc_cascade", "acdc_cascade_bwd"):
        if not counts[name]:
            _fail(f"{arch} smoke train: {name} never launched")
    for name, n in counts.items():
        totals[name] += n
    with plain_kernels():
        pargs = args_for("plain")
        _, plain = train.run(pargs, *train.build(pargs))
    rel = [abs(h["loss"] - q["loss"]) / abs(q["loss"])
           for h, q in zip(hist, plain)]
    if len(hist) != steps or not max(rel) <= FP32_LOSS_RTOL:
        _fail(f"{arch} smoke train: losses differ from the plain versions "
              f"by {max(rel)} (limit {FP32_LOSS_RTOL})")
    info = dict(path=f"{arch} smoke train", launches=counts,
                losses=[h["loss"] for h in hist],
                plain_losses=[q["loss"] for q in plain],
                max_rel_loss_diff=max(rel),
                ms_per_step=[h["ms"] for h in hist])
    print(f"[train] {arch} smoke: losses {info['losses']} | plain max rel "
          f"diff {max(rel):.2e} | launches {counts}", flush=True)
    return info


def smoke_configs(totals, archs, train_steps, hold_nonspec) -> list:
    """Smoke width (fp32) of ``archs`` served dense, paged (4-token pages)
    and speculative paged (``--spec-k 4``; a family without a paged cache
    dense and speculative dense; a vision frontend with ``--frontend``):
    every tick's launches exact,
    the greedy streams identical with the kernels and with the plain
    versions (and, with ``hold_nonspec``, without speculation: an MoE's
    capacity couples the batch's rows, so its verify of k + 1 tokens a
    slot routes otherwise than its decode); then ``train_vs_plain``."""
    out = []
    paged = ["--paged", "--block-size", "4"]
    spec_flags = ["--spec", "--spec-k", str(SPEC_K)]
    for arch in archs:
        base = ["--arch", arch, "--smoke", "--sell", "acdc", "--sell-method",
                "pallas", "--slots", "4", "--prompt-len", "12", "--gen", "8",
                "--requests", "8", "--device", "cuda"]
        pieces = model_for({}, base)
        if pieces[0].frontend == "vision":
            base.append("--frontend")
        # a family without a paged cache (ssm) serves dense and speculates
        # dense
        layouts = ((("dense", []), ("paged", paged),
                    ("spec paged", paged + spec_flags))
                   if pieces[1].init_cache_paged is not None
                   else (("dense", []), ("spec dense", spec_flags)))
        streams = {}
        for layout, extra in layouts:
            label = f"{arch} smoke {layout}"
            spec = layout.startswith("spec")
            need = (("acdc_cascade",)
                    + (("paged_attn",) if "paged" in layout else ())
                    + (("acdc_fused",) if spec else ()))
            info, reqs, eng, recs = serve_path(label, base + extra, pieces,
                                               totals, need, record=True)
            info["ticks"] = check_ticks(label, eng, recs, 12, spec=spec)
            got = streams_of(reqs)
            with plain_kernels():
                plain = streams_of(serve_path(
                    label + " (plain)", base + extra, pieces,
                    {k: 0 for k in KERNEL_MODULES}, ())[1])
            if got != plain:
                _fail(f"{label}: greedy streams differ between kernels and "
                      f"plain versions")
            info["streams_identical_to_plain"] = True
            if spec:
                nonspec = streams[layout.split()[-1]]
                info["streams_identical_to_nonspec"] = got == nonspec
                if hold_nonspec and got != nonspec:
                    _fail(f"{label}: greedy streams differ from the "
                          f"non-speculative run")
            streams[layout] = got
            out.append(info)
        out.append(train_vs_plain(arch, train_steps, totals))
    return out


def moe_full_width(dev, totals) -> dict:
    """Path F at full width: DeepSeekMoE-16B served (``--sell acdc
    --sell-method pallas``, bf16, dense then paged, 4 slots, 8 requests,
    16 new tokens) with every tick's launches exact -- one grouped
    ``scaled_matmul`` a projection call for all 64 experts; one prefill's
    and one decode step's logits against the plain versions held in fp32
    compute within ``FP32_METHOD_REL_L2`` (a control that gives every
    expert expert 0's diagonals over it) and reported in bf16 with the
    share of expert choices that agree; then trained (3 AdamW steps, batch
    4 x 128) on ``pallas`` (``train_full_width``) and on ``auto``
    (``train_methods_full_width``)."""
    import torch

    arch = "deepseek_moe_16b"
    argv = ["--arch", arch, "--sell", "acdc", "--sell-method", "pallas",
            "--slots", "4", "--prompt-len", "64", "--gen", "16",
            "--requests", "8", "--device", "cuda"]
    release_memory()
    pieces = model_for({}, argv)
    cfg = pieces[0]
    out = dict(params_gb=params_gb(pieces[2]),
               reckoned_masters_gb=RECKONED_MASTERS_GB[arch],
               n_layers=cfg.n_layers,
               matrices_s=build_matrices(cfg, dev))
    torch.cuda.reset_peak_memory_stats()
    per_tick = forward_launches(cfg, 4)["scaled_matmul"]
    if per_tick >= cfg.n_layers * cfg.n_experts:
        _fail(f"{arch}: {per_tick} scaled_matmul launches a decode tick: "
              f"not one grouped call a projection")
    out["scaled_matmul_per_decode_tick"] = per_tick
    for paged in (False, True):
        name = "paged" if paged else "dense"
        out[name] = serve_full_width(f"{arch} full width {name}", argv,
                                     pieces, totals, paged)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    def faulty():
        return scaled_matmul_as(scaled_matmul_group0)

    out["logits_fp32"] = logits_vs_plain(f"{arch} full width", pieces, dev,
                                         FP32_METHOD_REL_L2, faulty,
                                         dtype="float32")
    out["logits_bf16"] = logits_vs_plain(f"{arch} full width", pieces, dev,
                                         BF16_LOGIT_REL_L2, faulty,
                                         hold=())
    print(f"[memory] {arch} full width{depth_note(cfg)} serving "
          f"({smi_line()}): peak "
          f"{out['peak_mem_gb']:.2f} GB; fp32 masters {out['params_gb']:.2f}"
          f" GB (reckoned {out['reckoned_masters_gb']})", flush=True)
    del pieces
    release_memory()
    out["train"] = train_full_width(dev, totals, arch)
    out["train_auto"] = train_methods_full_width(dev, totals, arch)
    release_memory()
    return out


# ---------------------------------------------------------------------------
# Paths G, H and I: the recurrent families and the vision frontend
# ---------------------------------------------------------------------------

def logits_drift(label, pieces, dev, dtype, frames=None) -> dict:
    """One prefill's and one decode step's logits (``probe_logits``) at
    ``dtype`` compute with the kernels, the plain versions, every SELL
    kernel summed in fp64 (``kernels_in_fp64``) and the diagonals
    dropped; ``frames``: an encoder-decoder's (``probe_logits``).  In fp32
    the kernel path's drift from the fp64-summed path is held within
    ``DRIFT_RATIO`` x the plain version's and the faulty path's must read
    over that; bf16 readings are reported."""
    import torch

    cfg, model, params = pieces
    cfg = dataclasses.replace(cfg, dtype=dtype)
    runs = {}
    for name, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", plain_kernels),
                      ("fp64", kernels_in_fp64),
                      ("faulty",
                       lambda: scaled_matmul_as(scaled_matmul_without_pre))):
        with ctx():
            runs[name] = probe_logits(model, cfg, params, dev, frames)
    torch.cuda.synchronize()
    held = dtype == "float32"
    out = dict(compute=dtype, held=held, drift_ratio_limit=DRIFT_RATIO)
    for where in ("prefill", "decode"):
        rel = {f"{a}_vs_{b}": _rel_l2(runs[a][where], runs[b][where])
               for a, b in (("kernel", "plain"), ("kernel", "fp64"),
                            ("plain", "fp64"), ("faulty", "fp64"))}
        out[where] = rel
        print(f"[logits] {label} {dtype} {where} ({smi_line()}): "
              + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
              + (f" (held: kernel_vs_fp64 <= {DRIFT_RATIO} x plain_vs_fp64"
                 f" < faulty_vs_fp64)" if held else " (reported)"),
              flush=True)
        if not held:
            continue
        bound = DRIFT_RATIO * rel["plain_vs_fp64"]
        if not rel["kernel_vs_fp64"] <= bound:
            _fail(f"{label} fp32 {where} logits: kernel drift from fp64 "
                  f"{rel['kernel_vs_fp64']} > {DRIFT_RATIO} x the plain "
                  f"version's {rel['plain_vs_fp64']}")
        if not rel["faulty_vs_fp64"] > bound:
            _fail(f"{label} fp32 {where} logits: the drift limit {bound} "
                  f"does not catch the faulty control "
                  f"({rel['faulty_vs_fp64']})")
    return out


def paged_vs_dense_logits(pieces, dev, frames=None) -> dict:
    """A hybrid's (or an encoder-decoder's, its encoder over ``frames``)
    fp32 decode-step logits after the ``probe_logits`` prompt, through
    the paged admission step (16-token pages) and the paged decode
    (``paged_attn``) against the dense prefill and decode, within
    ``FP32_METHOD_REL_L2``; the same paged decode over a table whose pages
    are rolled by one (the prefix read from the wrong pages) must read
    over it."""
    import numpy as np
    import torch

    from repro_torch.dist import steps as steps_mod

    cfg, model, params = pieces
    cfg = dataclasses.replace(cfg, dtype="float32")
    bs, mb = 16, 6
    rs = np.random.RandomState(3)
    toks = np.zeros((1, 64), np.int32)
    toks[0, :PROBE_LEN] = rs.randint(0, cfg.vocab_size, size=PROBE_LEN)
    toks = torch.from_numpy(toks).to(dev)
    nxt = torch.tensor([rs.randint(0, cfg.vocab_size)], dtype=torch.int32,
                       device=dev)
    pos = torch.tensor([PROBE_LEN], dtype=torch.int32, device=dev)
    tables = torch.arange(mb, dtype=torch.int32, device=dev)[None]

    _, cache = model.prefill(params, model.init_cache(cfg, 1, mb * bs, dev),
                             toks, cfg, pos, frames)
    dense, _ = model.decode_step(params, cache, nxt, pos, cfg)

    def paged(table):
        cache = model.init_cache_paged(cfg, 1, mb, bs, dev)
        step = steps_mod.make_prefill_step(model, cfg, paged=True)
        _, cache = step(params, cache, model.init_cache(cfg, 1, mb * bs, dev),
                        toks, pos, tables[0], 0, frames)
        logits, _ = model.decode_step_paged(params, cache, nxt, pos, table,
                                            cfg)
        return logits

    reset_counts()
    got = paged(tables)
    torch.cuda.synchronize()
    launched = read_counts()["paged_attn"]
    rolled = paged(torch.roll(tables, 1, dims=1))
    out = dict(limit=FP32_METHOD_REL_L2, paged_attn_launches=launched,
               paged_vs_dense=_rel_l2(got[0].float(), dense[0].float()),
               rolled_table_vs_dense=_rel_l2(rolled[0].float(),
                                             dense[0].float()))
    print(f"[paged] {cfg.name} full width fp32 decode logits ({smi_line()}):"
          f" paged vs dense {out['paged_vs_dense']:.3e}, rolled table "
          f"{out['rolled_table_vs_dense']:.3e} (limit {FP32_METHOD_REL_L2});"
          f" paged_attn launched {launched}", flush=True)
    if launched != attention_passes(cfg):
        _fail(f"{cfg.name} paged decode: {launched} paged_attn launches, "
              f"want {attention_passes(cfg)}")
    if not out["paged_vs_dense"] <= FP32_METHOD_REL_L2:
        _fail(f"{cfg.name} paged decode logits: rel L2 "
              f"{out['paged_vs_dense']} > {FP32_METHOD_REL_L2}")
    if not out["rolled_table_vs_dense"] > FP32_METHOD_REL_L2:
        _fail(f"{cfg.name} paged decode logits: the limit does not catch a "
              f"rolled table ({out['rolled_table_vs_dense']})")
    return out


def recurrent_full_width(dev, totals, arch, paged) -> dict:
    """Paths G (Mamba2-1.3B, dense: the ssm family has no paged cache) and
    H (Zamba2-1.2B, 16-token pages) at full width, ``--sell acdc
    --sell-method pallas``, bf16 compute: 4 requests of <= 64 prompt
    tokens and 16 new ones, then ``--spec --spec-k 4`` with the truncated
    draft (``serve_full_width``: every tick's launches exact, s/tick
    beside the weight-read floor, tok/s, prefill s/admission); the bf16
    speculative streams against the non-speculative ones reported; one
    prefill's and one decode step's logits held by drift in fp32 and
    reported in bf16 (``logits_drift``); Zamba2's paged fp32 decode
    against its dense one (``paged_vs_dense_logits``); peak memory beside
    the reckoned fp32 masters; then 3 AdamW steps at 2 x 256 tokens
    (``train_full_width``: the SSD's chunk is 256; fp32 grads held by
    drift)."""
    import torch

    from repro_torch.launch import serve

    argv = ["--arch", arch, "--sell", "acdc", "--sell-method", "pallas",
            "--slots", "4", "--prompt-len", "64", "--gen", "16",
            "--requests", "4", "--device", "cuda"]
    release_memory()
    t0 = time.perf_counter()
    pieces = model_for({}, argv)
    cfg = pieces[0]
    out = dict(init_s=time.perf_counter() - t0,
               params_gb=params_gb(pieces[2]),
               reckoned_masters_gb=RECKONED_MASTERS_GB[arch],
               n_layers=cfg.n_layers,
               cache=serve.cache_kind(cfg, pieces[1], 81),
               matrices_s=build_matrices(cfg, dev))
    print(f"[cache] {arch} full width: {out['cache']}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    layout = "paged" if paged else "dense"
    out["serve"] = serve_full_width(f"{arch} full width {layout}", argv,
                                    pieces, totals, paged)
    out["spec"] = serve_full_width(f"{arch} full width spec {layout}", argv,
                                   pieces, totals, paged, spec=True)
    equal = sum(a == b for a, b in zip(out["spec"]["streams"],
                                       out["serve"]["streams"]))
    out["spec"]["bf16_streams_equal_nonspec"] = equal
    print(f"[spec] {arch} full width bf16: {equal}/"
          f"{len(out['serve']['streams'])} speculative streams equal the "
          f"non-speculative ones (reported)", flush=True)
    out["logits"] = {dtype: logits_drift(f"{arch} full width", pieces, dev,
                                         dtype)
                     for dtype in ("bfloat16", "float32")}
    if paged:
        out["paged_vs_dense"] = paged_vs_dense_logits(pieces, dev)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[memory] {arch} full width{depth_note(cfg)} serving "
          f"({smi_line()}): peak "
          f"{out['peak_mem_gb']:.2f} GB; fp32 masters {out['params_gb']:.2f}"
          f" GB (reckoned {out['reckoned_masters_gb']})", flush=True)
    del pieces
    release_memory()
    out["train"] = train_full_width(dev, totals, arch, global_batch=2,
                                    seq_len=256, hold="drift")
    release_memory()
    return out


def llava_full_width(dev, totals) -> dict:
    """Path I: LLaVA-NeXT-34B's backbone at full width, ``--sell acdc
    --sell-method pallas``, bf16 compute, 16-token pages: 2 requests whose
    first 576 positions are the stub patch prefix (``--frontend``: fp32
    embeddings from a seeded generator), prompts of <= 64 tokens after it
    (``max_prompt_len`` 640) and 8 new tokens (``serve_full_width``); one
    decode step's logits after a prefixed probe against the plain versions
    within ``BF16_DECODE_REL_L2``, with the diagonals-dropped control and
    the prefix zeroed both over it; peak memory beside the reckoned fp32
    masters.  Its AdamW state does not fit one card: no training here."""
    import torch

    from repro_torch.launch import serve

    arch = "llava_next_34b"
    argv = ["--arch", arch, "--sell", "acdc", "--sell-method", "pallas",
            "--slots", "2", "--prompt-len", "64", "--gen", "8",
            "--requests", "2", "--frontend", "--device", "cuda"]
    release_memory()
    t0 = time.perf_counter()
    pieces = model_for({}, argv)
    cfg = pieces[0]
    out = dict(init_s=time.perf_counter() - t0,
               params_gb=params_gb(pieces[2]),
               reckoned_masters_gb=RECKONED_MASTERS_GB[arch],
               n_layers=cfg.n_layers,
               matrices_s=build_matrices(cfg, dev))
    torch.cuda.reset_peak_memory_stats()
    out["serve"] = serve_full_width(f"{arch} full width paged", argv, pieces,
                                    totals, True)
    prefix = serve._make_frontend(
        cfg, torch.Generator().manual_seed(7), 1).to(dev)
    out["logits"] = logits_vs_plain(
        f"{arch} full width", pieces, dev, BF16_DECODE_REL_L2,
        lambda: scaled_matmul_as(scaled_matmul_without_pre),
        hold=("decode",), prefix=prefix)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[memory] {arch} full width{depth_note(cfg)} serving "
          f"({smi_line()}): peak "
          f"{out['peak_mem_gb']:.2f} GB; fp32 masters {out['params_gb']:.2f}"
          f" GB (reckoned {out['reckoned_masters_gb']}); init "
          f"{out['init_s']:.1f} s, transform matrices "
          f"{out['matrices_s']:.1f} s", flush=True)
    del pieces, prefix
    release_memory()
    return out


def frames_vs_apply(pieces, dev, frames) -> dict:
    """The frame fix at full width, fp32 compute.  The full config leaves
    ``n_frontend_tokens`` unset, so a slot's cross cache holds 128 frames
    and a request brings 16: the ``probe_logits`` prompt is prefilled with
    ``frames`` into a batch-1 slot cache, inserted into slot 1 of a 2-slot
    decode cache (slot 0 parked), and one decode step's logits are held
    against ``apply`` over the same tokens and frames within
    ``FP32_METHOD_REL_L2``.  The same decode reading all 128 frames of
    the slot (its frame count set to 128: the reference's cross read)
    must read over the limit."""
    import numpy as np
    import torch

    from repro_torch.dist import steps as steps_mod

    cfg, model, params = pieces
    cfg = dataclasses.replace(cfg, dtype="float32")
    smax = 96
    rs = np.random.RandomState(3)
    ctx = rs.randint(0, cfg.vocab_size, size=PROBE_LEN + 1).astype(np.int32)
    toks = np.zeros((1, 64), np.int32)
    toks[0, :PROBE_LEN] = ctx[:PROBE_LEN]
    lengths = torch.tensor([PROBE_LEN], dtype=torch.int32, device=dev)
    _, slot_cache = steps_mod.make_prefill_step(model, cfg)(
        params, model.init_cache(cfg, 1, smax, dev),
        torch.from_numpy(toks).to(dev), lengths, frames)
    cache = steps_mod.make_insert_step()(model.init_cache(cfg, 2, smax, dev),
                                         slot_cache, 1)
    room = int(cache["xk"].shape[2])
    tok = torch.tensor([0, int(ctx[PROBE_LEN])], dtype=torch.int32,
                       device=dev)
    pos = torch.tensor([smax, PROBE_LEN], dtype=torch.int32, device=dev)

    def decode(xlen):
        c = dict(cache, k=cache["k"].clone(), v=cache["v"].clone(),
                 xlen=torch.tensor([room, xlen], dtype=torch.int32,
                                   device=dev))
        return model.decode_step(params, c, tok, pos, cfg)[0][1].float()

    got = decode(int(cache["xlen"][1]))
    unmasked = decode(room)
    want = model.apply(params, torch.from_numpy(ctx[None]).to(dev), cfg,
                       frames)[0, PROBE_LEN].float()
    out = dict(limit=FP32_METHOD_REL_L2, cache_frames=room,
               request_frames=int(frames.shape[1]),
               decode_vs_apply=_rel_l2(got, want),
               unmasked_decode_vs_apply=_rel_l2(unmasked, want))
    print(f"[frames] {cfg.name} full width fp32 ({smi_line()}): "
          f"{out['request_frames']} frames in a {room}-frame cross cache; "
          f"decode vs apply {out['decode_vs_apply']:.3e}, all {room} frames "
          f"read {out['unmasked_decode_vs_apply']:.3e} (limit "
          f"{FP32_METHOD_REL_L2})", flush=True)
    if not out["decode_vs_apply"] <= FP32_METHOD_REL_L2:
        _fail(f"{cfg.name} decode after a short-framed prefill departs from "
              f"apply: rel L2 {out['decode_vs_apply']}")
    if not out["unmasked_decode_vs_apply"] > FP32_METHOD_REL_L2:
        _fail(f"{cfg.name}: the limit does not catch a decode reading all "
              f"{room} frames ({out['unmasked_decode_vs_apply']})")
    return out


def plans_ab(label, argv, pieces) -> dict:
    """Dense serving on the autotuned plans and on the cost model's
    (``kernels.ops`` passing no plan: each wrapper's own ``_geometry``,
    the launch before the autotuner), in turns on the same weights, card
    and requests (autotuned, cost model, cost model, autotuned): s/tick
    and prefill s/admission of each run."""
    from repro_torch.kernels import ops

    out = {"autotuned": [], "cost model": []}
    saved = ops._plan
    for side in ("autotuned", "cost model", "cost model", "autotuned"):
        if side == "cost model":
            ops._plan = lambda *args, **kw: None
        try:
            info = serve_path(f"{label} ({side} plans)", argv, pieces,
                              {k: 0 for k in KERNEL_MODULES}, ())[0]
        finally:
            ops._plan = saved
        out[side].append(dict(
            s_per_tick=info["s_per_tick"],
            prefill_s=info["prefill_s"] / max(info["prefills"], 1)))
    print(f"[J] {label}, in turns ({smi_line()}): ms a tick autotuned "
          + " / ".join(f"{r['s_per_tick'] * 1e3:.1f}"
                       for r in out["autotuned"])
          + ", cost model " + " / ".join(
              f"{r['s_per_tick'] * 1e3:.1f}" for r in out["cost model"]),
          flush=True)
    return out


def seamless_full_width(dev, totals) -> dict:
    """Path J: Seamless-M4T-large-v2 at full width (d 1024, d_ff 8192,
    vocab 256206; 6 + 6 of its 24 + 24 layers under ``cut_depth``),
    ``--sell acdc --sell-method pallas``,
    bf16 compute, fp32 masters: 4 slots, 4 requests of <= 64 tokens plus
    16 stub frames each (the launcher's), 16 new tokens, served dense,
    paged (16-token pages) and ``--spec --spec-k 4`` paged with every
    tick's launches exact (``serve_full_width``: every attn_out, self,
    cross and encoder, an N = 1024 riffled cascade; the MLPs two-call
    ``scaled_matmul`` at N = 8192; the depth-1 draft's attn_out
    ``acdc_fused``); one prefill's and one decode step's logits after
    the probe against the plain versions, held in fp32 compute within
    ``FP32_METHOD_REL_L2`` with the diagonals-dropped control and the
    frames zeroed over it, reported in bf16 beside each side's drift from
    the fp64-summed path (``logits_drift``); paged against dense in
    fp32 (``paged_vs_dense_logits``); decode against ``apply`` with 16
    frames in the 128-frame cross cache (``frames_vs_apply``); peak
    memory beside the reckoned fp32 masters; then 3 AdamW steps at 4 x
    128 tokens and 32 frames a row (``train_full_width``: exact
    ``scaled_matmul``, ``acdc_cascade`` and ``acdc_cascade_bwd`` counts;
    fp32 grads held by drift: the plain versions' own drift from an
    fp64-summed step is 1.2e-3, 16 x Qwen3's: ``scripts/drift_vs_fp64.py``,
    PERF.md §6)."""
    import torch

    from repro_torch.launch import serve

    arch = "seamless_m4t_large_v2"
    argv = ["--arch", arch, "--sell", "acdc", "--sell-method", "pallas",
            "--slots", "4", "--prompt-len", "64", "--gen", "16",
            "--requests", "4", "--device", "cuda"]
    release_memory()
    t0 = time.perf_counter()
    pieces = model_for({}, argv)
    cfg = pieces[0]
    out = dict(init_s=time.perf_counter() - t0,
               params_gb=params_gb(pieces[2]),
               reckoned_masters_gb=RECKONED_MASTERS_GB[arch],
               n_layers=cfg.n_layers,
               cache=serve.cache_kind(cfg, pieces[1], 81),
               matrices_s=build_matrices(cfg, dev))
    print(f"[cache] {arch} full width: {out['cache']}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    for key, paged, spec in (("serve", False, False), ("paged", True, False),
                             ("spec", True, True)):
        out[key] = serve_full_width(
            f"{arch} full width {'spec ' if spec else ''}"
            f"{'paged' if paged else 'dense'}", argv, pieces, totals, paged,
            spec=spec)
    for key in ("paged", "spec"):
        out[key]["bf16_streams_equal_dense"] = sum(
            a == b for a, b in zip(out[key]["streams"],
                                   out["serve"]["streams"]))
    print(f"[serve] {arch} full width bf16: streams equal to dense: paged "
          f"{out['paged']['bf16_streams_equal_dense']}/4, spec "
          f"{out['spec']['bf16_streams_equal_dense']}/4 (reported)",
          flush=True)
    frames = serve._make_frontend(
        cfg, torch.Generator().manual_seed(7), 1).to(dev)
    # bf16 reported: at 24 + 24 layers the plain versions' own decode
    # logits drift 0.029 from an fp64-summed path, the kernels' 0.014
    # (``scripts/drift_vs_fp64.py``, PERF.md §6), so a 0.03 limit between
    # them tells no fault; fp32 held, as the deep MoE stack's logits are
    out["logits"] = {dtype: logits_vs_plain(
        f"{arch} full width", pieces, dev, limit,
        lambda: scaled_matmul_as(scaled_matmul_without_pre), dtype=dtype,
        hold=hold, prefix=frames)
        for dtype, limit, hold in (
            ("bfloat16", BF16_DECODE_REL_L2, ()),
            ("float32", FP32_METHOD_REL_L2, ("prefill", "decode")))}
    out["logits_drift_bf16"] = logits_drift(f"{arch} full width", pieces,
                                            dev, "bfloat16", frames)
    out["paged_vs_dense"] = paged_vs_dense_logits(pieces, dev, frames)
    out["frames"] = frames_vs_apply(pieces, dev, frames)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["plans_ab"] = plans_ab(f"{arch} full width dense", argv, pieces)
    print(f"[memory] {arch} full width{depth_note(cfg)} serving "
          f"({smi_line()}): peak "
          f"{out['peak_mem_gb']:.2f} GB; fp32 masters {out['params_gb']:.2f}"
          f" GB (reckoned {out['reckoned_masters_gb']}); init "
          f"{out['init_s']:.1f} s, transform matrices "
          f"{out['matrices_s']:.1f} s", flush=True)
    del pieces, frames
    release_memory()
    out["train"] = train_full_width(dev, totals, arch, global_batch=4,
                                    seq_len=128, hold="drift")
    release_memory()
    print(f"[J] on autotuned plans{depth_note(cfg)} ({smi_line()}): "
          f"decode tick {out['serve']['s_per_tick'] * 1e3:.1f} dense / "
          f"{out['paged']['s_per_tick'] * 1e3:.1f} paged ms, prefill "
          f"{out['serve']['prefill_s_per_admission']:.3f} / "
          f"{out['paged']['prefill_s_per_admission']:.3f} s an admission, "
          f"train {out['train']['s_per_step']:.3f} s a step", flush=True)
    return out


# ---------------------------------------------------------------------------
# Path K: data-parallel training with int8 error-feedback gradient sums
# ---------------------------------------------------------------------------

#: elementwise int8 bound |ghat - (g + e)| <= scale / 2: the fp32 quotient
#: and product each round once (at most 127 x 2^-24 of a step, and one ulp
#: of the value)
INT8_STEP_SLACK = 1e-5
#: ``ghat + new_e == g + e`` to the reference's own tolerance
#: (tests/test_compression.py, compressed_psum on one member)
EF_IDENTITY_ATOL = 1e-5


@contextlib.contextmanager
def compression_recorder(sums: dict, drop_feedback: bool = False):
    """Record, for every gradient leaf the compressed all-reduce sees, the
    true gradient's and the transmitted gradient's running sums (fp64)
    and the largest block scale so far; ``drop_feedback`` is the faulty
    control: the residual is thrown away (``new_e = 0``)."""
    import torch

    from repro_torch.dist import compression
    from repro_torch.optim.optimizers import tree_flatten, tree_map

    reduce_tree = compression.compressed_all_reduce_tree

    def recorded(grads, errors, group=None):
        total, new_e = reduce_tree(grads, errors, group)
        paths, gs = tree_flatten(grads)
        _, es = tree_flatten(errors)
        _, ts = tree_flatten(total)
        for path, g, e, t in zip(paths, gs, es, ts):
            flat = g.float().reshape(-1) + e.reshape(-1)
            _, scale = compression.quantize_int8(
                torch.where(torch.isfinite(flat), flat, 0.0))
            if path not in sums:
                sums[path] = dict(
                    true=torch.zeros(flat.shape, dtype=torch.float64,
                                     device=flat.device),
                    sent=torch.zeros(flat.shape, dtype=torch.float64,
                                     device=flat.device),
                    scale=torch.zeros_like(scale))
            sums[path]["true"] += g.reshape(-1).double()
            sums[path]["sent"] += t.reshape(-1).double()
            torch.maximum(sums[path]["scale"], scale,
                          out=sums[path]["scale"])
        if drop_feedback:
            new_e = tree_map(torch.zeros_like, new_e)
        return total, new_e

    compression.compressed_all_reduce_tree = recorded
    try:
        yield
    finally:
        compression.compressed_all_reduce_tree = reduce_tree


def steps_from_true_sum(sums: dict) -> float:
    """max over elements of |sum of sent - sum of true| in units of the
    element's quantization step (its block's largest scale)."""
    import torch

    from repro_torch.dist import compression

    worst = 0.0
    for rec in sums.values():
        n = rec["true"].numel()
        step = rec["scale"].expand(-1, compression.BLOCK).reshape(-1)[:n]
        gap = (rec["sent"] - rec["true"]).abs()
        ratio = torch.where(step > 0, gap / step.double(),
                            torch.where(gap > 0, math.inf, 0.0))
        worst = max(worst, float(ratio.max()))
    return worst


def compressed_leaf_checks(grads: dict, errors: dict, group) -> dict:
    """One compressed all-reduce over ``group`` of ``grads`` with carried
    residuals ``errors``: per leaf the int8 bound and the error-feedback
    identity, and ``quantize_int8`` on the card against the CPU (entries
    that differ, counted)."""
    import torch

    from repro_torch.dist import compression
    from repro_torch.optim.optimizers import tree_flatten

    ghat, new_e = compression.compressed_all_reduce_tree(grads, errors,
                                                         group)
    out = dict(leaves=0, entries=0, worst_bound_ratio=0.0,
               identity_max_abs=0.0, q_differ=0, scale_differ=0)
    paths, gs = tree_flatten(grads)
    for path, g, e, gh, ne in zip(paths, gs, tree_flatten(errors)[1],
                                  tree_flatten(ghat)[1],
                                  tree_flatten(new_e)[1]):
        flat = g.float().reshape(-1) + e.reshape(-1)
        q, scale = compression.quantize_int8(flat)
        n = flat.numel()
        step = scale.expand(-1, compression.BLOCK).reshape(-1)[:n]
        err = (gh.reshape(-1).float() - flat).abs()
        bound = step * (0.5 + INT8_STEP_SLACK) + flat.abs() * 2.0 ** -23
        if not bool((err <= bound).all()):
            _fail(f"[K] {path}: |ghat - (g + e)| over scale / 2 "
                  f"({float((err - bound).max())} past the bound)")
        ratio = torch.where(step > 0, err / step, 0.0)
        ident = float((gh.reshape(-1).float() + ne.reshape(-1)
                       - flat).abs().max())
        if not ident <= EF_IDENTITY_ATOL:
            _fail(f"[K] {path}: ghat + new_e departs from g + e by {ident}")
        q_cpu, scale_cpu = compression.quantize_int8(flat.cpu())
        out["q_differ"] += int((q.cpu() != q_cpu).sum())
        out["scale_differ"] += int((scale.cpu() != scale_cpu).sum())
        out["leaves"] += 1
        out["entries"] += n
        out["worst_bound_ratio"] = max(out["worst_bound_ratio"],
                                       float(ratio.max()))
        out["identity_max_abs"] = max(out["identity_max_abs"], ident)
    return out


def dist_full_width(dev, totals) -> dict:
    """Path K: full-width Qwen3-1.7B trained data-parallel through the
    train launcher with ``--compress-grads`` over a world-of-one NCCL
    process group (``world_of_one``; the compressed state placed at rest
    on its (1, 1) mesh): the int8 bound, the error-feedback identity, the
    quantizer on the card against the CPU, equal step-0 losses with and
    without compression, three timed compressed steps (exact SELL
    launches: compression launches no SELL kernel) beside three
    uncompressed ones, and the faulty control (the residual dropped)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import compression
    from repro_torch.dist import steps as steps_mod
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_map

    mesh = mesh_mod.make_host_mesh(1, dev.type)
    if tuple(mesh.shape) != (1, 1):
        _fail(f"[K] world-of-one mesh {mesh}")
    args = train.parse_args([
        "--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method",
        "pallas", "--compress-grads", "--global-batch", "4",
        "--seq-len", "128", "--steps", "3", "--device", str(dev)])
    cfg, model, opt, step_c, pipeline = train.build(args)
    dp = pipeline.dp
    backend = dist.get_backend(dp.group) if dp.group else None
    if backend != mesh_mod.BACKENDS[dev.type]:
        _fail(f"[K] the data group runs {backend} on {dev.type}")
    step_u = steps_mod.make_train_step(model, cfg, opt, group=dp.group)
    tokens = args.global_batch * args.seq_len
    want = train_launches_per_step(cfg, tokens)

    def fresh(compress: bool) -> dict:
        gen = torch.Generator(device=dev).manual_seed(0)
        return steps_mod.init_state(model, cfg, opt, gen, dev,
                                    compress_dp=int(compress),
                                    mesh=dp.mesh if compress else None)

    # one seeded state and batch: the bound and the identity on a
    # carried (non-zero) residual, and the card against the CPU
    state = fresh(True)
    wire, raw = train._grad_wire_bytes(state["params"])
    _, grads = steps_mod.loss_and_grads(model, cfg, state["params"],
                                        train.batch_on(pipeline, 0, dev))
    zeros = tree_map(lambda e: e[0], state["grad_error"])
    _, carried = compression.compressed_all_reduce_tree(grads, zeros,
                                                        dp.group)
    leaf = compressed_leaf_checks(grads, carried, dp.group)
    del state, grads, zeros, carried
    torch.cuda.empty_cache()
    print(f"[K] {leaf['leaves']} grad leaves, {leaf['entries']} "
          f"entries: |ghat - (g + e)| <= {leaf['worst_bound_ratio']:.6f}"
          f" scale, |ghat + new_e - (g + e)| <= "
          f"{leaf['identity_max_abs']:.2e}; quantize_int8 card vs CPU: "
          f"{leaf['q_differ']} q and {leaf['scale_differ']} scales "
          f"differ", flush=True)

    def run(label, step_fn, compress, record=None, drop=False):
        state = fresh(compress)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = []
        ctx = (compression_recorder(record, drop) if record is not None
               else contextlib.nullcontext())
        with ctx:
            for step in range(args.steps):
                batch = train.batch_on(pipeline, step, dev)
                before = read_counts()
                t0 = time.perf_counter()
                state, met = step_fn(state, batch)
                torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                delta = {k: v - before[k]
                         for k, v in read_counts().items() if v - before[k]}
                loss = float(met["loss"])
                if not math.isfinite(loss):
                    _fail(f"[K] {label} step {step}: loss {loss}")
                if delta != want:
                    _fail(f"[K] {label} step {step}: launches {delta}, "
                          f"want {want} and nothing else")
                out.append(dict(loss=loss, s=dt, launches=delta,
                                grad_norm=float(met["grad_norm"])))
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state
        torch.cuda.empty_cache()
        timed_s = [o["s"] for o in out[1:]]
        info = dict(steps=out, s_per_step=sum(timed_s) / len(timed_s),
                    peak_mem_gb=peak)
        print(f"[K] {label}: losses {[o['loss'] for o in out]}, "
              f"{info['s_per_step']:.3f} s/step, peak {peak:.2f} GB",
              flush=True)
        return info

    reset_counts()
    plain = run("uncompressed", step_u, False)
    comp = run("compressed", step_c, True)
    if plain["steps"][0]["loss"] != comp["steps"][0]["loss"]:
        _fail(f"[K] step-0 loss compressed {comp['steps'][0]['loss']} "
              f"!= uncompressed {plain['steps'][0]['loss']}")
    sums_ef, sums_off = {}, {}
    run("compressed, recorded", step_c, True, sums_ef)
    run("compressed, feedback dropped", step_c, True, sums_off,
        drop=True)
    counts = read_counts()
    with_ef = steps_from_true_sum(sums_ef)
    without = steps_from_true_sum(sums_off)
    del sums_ef, sums_off
    torch.cuda.empty_cache()
    print(f"[K] accumulated transmitted gradient after {args.steps} "
          f"steps: {with_ef:.4f} quantization steps from the true sum "
          f"with error feedback, {without:.4f} without", flush=True)
    if not with_ef <= 0.5 + 1e-3:
        _fail(f"[K] with error feedback the transmitted sum drifts "
              f"{with_ef} steps from the true one (> 1/2)")
    if not without > 1.0:
        _fail(f"[K] the faulty control (no feedback) stays within one "
              f"quantization step ({without}): the check cannot tell")
    for name, n in counts.items():
        totals[name] += n
    info = dict(config="qwen3_1_7b full width, bf16 compute, fp32 masters, "
                       "--compress-grads over a world-of-one NCCL group",
                global_batch=args.global_batch, seq_len=args.seq_len,
                leaf_checks=leaf, uncompressed=plain, compressed=comp,
                s_per_step_ratio=comp["s_per_step"] / plain["s_per_step"],
                wire_bytes=wire, raw_bytes=raw,
                steps_from_true_sum=dict(with_feedback=with_ef,
                                         feedback_dropped=without),
                launches_per_step=want, launches=counts, device=smi_line())
    print(f"[K] ({info['device']}): compressed {comp['s_per_step']:.3f} "
          f"s/step vs uncompressed {plain['s_per_step']:.3f} "
          f"({info['s_per_step_ratio']:.3f}x), peak {comp['peak_mem_gb']:.2f}"
          f" / {plain['peak_mem_gb']:.2f} GB, wire {wire} vs raw {raw} "
          f"bytes ({wire / raw:.4f}x), launches a step {want}", flush=True)
    return info


@contextlib.contextmanager
def world_of_one(dev):
    """A world-of-one process group (NCCL on the card) for paths K and L,
    left on exit."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    pg = ROOT / "build" / "chip_smoke_pg"
    pg.parent.mkdir(parents=True, exist_ok=True)
    pg.unlink(missing_ok=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(mesh_mod.BACKENDS[dev.type],
                            init_method=f"file://{pg}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        mesh_mod.shutdown()


@contextlib.contextmanager
def stale_layer_gather(state: dict):
    """The faulty control of path L: layer 0's gather served from the
    copy it gathered first, once ``state["stale"]`` is set (after step
    0), as a gather cache that missed the update would serve it."""
    from repro_torch.dist import sharding
    from repro_torch.optim.optimizers import tree_map

    real = sharding.PlacedStack.layer

    def layer(self, i):
        if i != 0:
            return real(self, i)
        if state.get("stale") and "copy" in state:
            return state["copy"]
        out = real(self, i)
        state["copy"] = tree_map(lambda t: t.detach().clone(), out)
        return out

    sharding.PlacedStack.layer = layer
    try:
        yield
    finally:
        sharding.PlacedStack.layer = real


def placed_full_width(dev, totals) -> dict:
    """Path L: full-width Qwen3-1.7B (at the depth its caller sets)
    trained with its state placed at
    rest by the sharding rules on the world-of-one (1, 1) mesh of path K
    (every leaf spec'd over its size-1 axes: each layer gathered inside
    its checkpointed function, each gradient reduce-scattered by its
    gather's backward, the mesh-wide norm), 3 steps beside 3 replicated
    ones from the same seed and batches: losses, grad and update norms
    and every param and moment bitwise equal, ``scaled_matmul`` launched
    ``train_launches_per_step`` times a step on both sides; the faulty
    control (layer 0's gather
    served stale after step 0) must differ; then one placed smoke step
    (K = 2: the cascade kernels at N = 128 / 256) bitwise against a
    replicated one, with equal launches."""
    import torch

    from repro_torch.dist import steps as steps_mod
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_flatten

    def host(state) -> dict:
        paths, leaves = tree_flatten({k: state[k] for k in ("params",
                                                             "opt")})
        return {p: t.detach().cpu() for p, t in zip(paths, leaves)}

    def differs(a: dict, b: dict) -> list:
        return [p for p in a if not torch.equal(a[p], b[p])]

    def sides(argv, n_steps, control=False):
        args = train.parse_args(argv + ["--steps", str(n_steps), "--device",
                                        str(dev)])
        cfg, model, opt, step_p, pipeline = train.build(args)
        dp = pipeline.dp
        if dp.mesh is None or tuple(dp.mesh.shape) != (1, 1):
            _fail(f"[L] world-of-one mesh {dp.mesh}")
        step_r = steps_mod.make_train_step(model, cfg, opt, group=dp.group)
        want = train_launches_per_step(cfg,
                                       args.global_batch * args.seq_len)

        def run(label, step_fn, mesh, fault=None):
            gen = torch.Generator(device=dev).manual_seed(0)
            state = steps_mod.init_state(model, cfg, opt, gen, dev,
                                         mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = []
            with (stale_layer_gather(fault) if fault is not None
                  else contextlib.nullcontext()):
                for step in range(n_steps):
                    batch = train.batch_on(pipeline, step, dev)
                    before = read_counts()
                    t0 = time.perf_counter()
                    state, met = step_fn(state, batch)
                    torch.cuda.synchronize(dev)
                    dt = time.perf_counter() - t0
                    delta = {k: v - before[k] for k, v in
                             read_counts().items() if v - before[k]}
                    if fault is None and delta != want:
                        _fail(f"[L] {label} step {step}: launches {delta},"
                              f" want {want} and nothing else")
                    out.append(dict(s=dt, launches=delta, **{
                        k: float(v) for k, v in met.items()}))
                    if fault is not None:
                        fault["stale"] = True
            peak = torch.cuda.max_memory_allocated() / 1e9
            final = host(state)
            del state
            torch.cuda.empty_cache()
            timed_s = [o["s"] for o in out[1:]] or [out[0]["s"]]
            return dict(steps=out, peak_mem_gb=peak,
                        s_per_step=sum(timed_s) / len(timed_s)), final

        reset_counts()
        rep, rep_final = run("replicated", step_r, None)
        placed, placed_final = run("placed", step_p, dp.mesh)
        counts = read_counts()
        metrics = ("loss", "grad_norm", "update_norm")
        for a, b in zip(rep["steps"], placed["steps"]):
            if any(a[k] != b[k] for k in metrics):
                _fail(f"[L] {argv[1:4]}: placed metrics {b} != replicated "
                      f"{a}")
        bad = differs(rep_final, placed_final)
        if bad:
            _fail(f"[L] {len(bad)} leaves differ between the placed and "
                  f"the replicated state, e.g. {bad[:3]}")
        info = dict(replicated=rep, placed=placed, launches=counts,
                    launches_per_step=want, leaves=len(rep_final))
        if control:
            ctl, ctl_final = run("control", step_p, dp.mesh, fault={})
            bad = differs(rep_final, ctl_final)
            moved = [a["loss"] != b["loss"]
                     for a, b in zip(rep["steps"], ctl["steps"])]
            if not bad or not any(moved):
                _fail(f"[L] the faulty control (layer 0's gather stale "
                      f"after step 0) passes the check: {len(bad)} leaves "
                      f"differ, losses moved {moved}")
            info["control"] = dict(leaves_differing=len(bad),
                                   losses=[c["loss"] for c in ctl["steps"]],
                                   losses_moved=moved)
        del rep_final, placed_final
        return info

    full = sides(["--arch", "qwen3_1_7b", "--sell", "acdc",
                  "--sell-method", "pallas", "--global-batch", "4",
                  "--seq-len", "128"], 3, control=True)
    for side in ("replicated", "placed"):
        r = full[side]
        print(f"[L] full width {side}: losses "
              f"{[o['loss'] for o in r['steps']]}, {r['s_per_step']:.3f} "
              f"s/step, peak {r['peak_mem_gb']:.2f} GB", flush=True)
    print(f"[L] full width: {full['leaves']} leaves bitwise equal, "
          f"launches a step {full['launches_per_step']} on both sides; "
          f"control: {full['control']['leaves_differing']} leaves differ, "
          f"losses {full['control']['losses']}", flush=True)
    smoke = sides(["--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
                   "--sell-method", "pallas", "--global-batch", "4",
                   "--seq-len", "64"], 1)
    print(f"[L] smoke K=2 placed step: bitwise equal to replicated, "
          f"launches {smoke['launches']} over both sides", flush=True)
    for info in (full, smoke):
        for name, n in info["launches"].items():
            totals[name] += n
    info = dict(config="qwen3_1_7b full width, bf16 compute, fp32 masters, "
                       "placed at rest on a world-of-one (1, 1) NCCL mesh",
                full_width=full, smoke=smoke, device=smi_line())
    print(f"[L] ({info['device']}): placed {full['placed']['s_per_step']:.3f}"
          f" s/step vs replicated {full['replicated']['s_per_step']:.3f}, "
          f"peak {full['placed']['peak_mem_gb']:.2f} / "
          f"{full['replicated']['peak_mem_gb']:.2f} GB", flush=True)
    return info


#: path M's cells held against the dry run (Qwen3-1.7B, ``acdc`` on
#: ``auto``, the (1, 1) mesh): the served prefill and decode, and a
#: prefill whose activations (full fp32 logits) outweigh the gathered
#: embedding, so that the peak check covers what the dry run's table
#: reports
PATH_M_RECKON = ("qwen3_1_7b:prefill:64:4:1x1", "qwen3_1_7b:decode:80:4:1x1",
                 "qwen3_1_7b:prefill:1024:4:1x1")


@contextlib.contextmanager
def rows_cut_wrong():
    """The faulty control of path M: each layer's new K kept from rows
    rolled by one, as a cut that took the wrong rows would keep it."""
    import torch

    from repro_torch.dist import sharding

    real = sharding.LayerCut.__call__

    def cut(self, name, layer, heads_local=False):
        out = real(self, name, layer, heads_local)
        return torch.roll(out, 1, 0) if name == "k" else out

    sharding.LayerCut.__call__ = cut
    try:
        yield
    finally:
        sharding.LayerCut.__call__ = real


#: path N: the flags each torch example runs with on the card
EXAMPLE_RECOVERY = ["--ks", "1,4,16", "--steps", "300", "--init", "both"]
EXAMPLE_CONVNET_STEPS = 300
EXAMPLE_LM_STEPS = 20


def _example(name: str):
    """``examples/<name>_torch.py`` as a module."""
    import importlib

    path = str(ROOT / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(f"{name}_torch")


def examples_path(dev, totals) -> dict:
    """Path N: each PyTorch example's ``main`` in this process on the card
    -- the quickstart whole (its one ``acdc_fused`` launch counted exactly
    and held against the plain version), linear recovery at K = 1, 4, 16
    and both inits, the convnet on ``acdc`` and ``dense`` (each loss must
    fall), the ~100M LM trained 20 steps (finite losses, a checkpoint
    written), and serving at the example's default argv and on the
    kernels (``--sell acdc --sell-method pallas``)."""
    import torch

    from repro_torch.kernels import ops

    out, dev_arg = {}, ["--device", str(dev)]

    def run(key, fn, *args):
        reset_counts()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        launched = read_counts()
        for k, v in launched.items():
            totals[k] += v
        out[key] = dict(seconds=time.perf_counter() - t0,
                        launches={k: v for k, v in launched.items() if v})
        return res, out[key]

    qs = _example("quickstart")
    res, info = run("quickstart", qs.main, dev_arg)
    xk, a, d, yk, err = res["fused"]
    with plain_kernels():
        plain = ops.acdc_fused_op(xk, a, d, None)
    info.update(kernel_vs_plain=max_err(yk, plain), kernel_vs_matmul=err,
                logits_finite=bool(torch.isfinite(res["logits"]).all()),
                params=res["params"])
    if info["launches"] != {"acdc_fused": 1}:
        _fail(f"[N] quickstart launched {info['launches']}, want exactly "
              f"one acdc_fused ([4]; [1] - [3] and [5] run on auto)")
    if not rel_close(yk, plain, rtol=1e-3, atol=2e-4):
        _fail(f"[N] quickstart [4]: acdc_fused vs its plain version "
              f"{info['kernel_vs_plain']:.3g}")
    if not info["logits_finite"]:
        _fail("[N] quickstart [5]: logits not finite")

    rec = _example("linear_recovery")
    res, info = run("linear_recovery", rec.main, EXAMPLE_RECOVERY + dev_arg)
    info["final_mse"] = {f"K={k} {init}": v for (k, init), v in
                         ((key, v) for key, v in res.items()
                          if key != "floor")}
    info["noise_floor"] = res["floor"]
    if not all(math.isfinite(v) for v in info["final_mse"].values()):
        _fail(f"[N] linear recovery: {info['final_mse']}")

    conv = _example("convnet_acdc")
    for fc in ("acdc", "dense"):
        res, info = run(f"convnet_{fc}", conv.main, [
            "--fc", fc, "--steps", str(EXAMPLE_CONVNET_STEPS)] + dev_arg)
        losses = res["losses"]
        first, last = (sum(losses[:20]) / 20, sum(losses[-20:]) / 20)
        info.update(eval_acc=res["eval_acc"], loss_first20=first,
                    loss_last20=last, n_params=res["n_params"])
        if not last < first:
            _fail(f"[N] convnet {fc}: loss did not fall ({first:.4f} -> "
                  f"{last:.4f})")

    lm = _example("train_lm")
    ckpt = ROOT / "build" / "chip_examples_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    (state, history), info = run("train_lm", lm.main, [
        "--steps", str(EXAMPLE_LM_STEPS), "--ckpt-dir", str(ckpt)] + dev_arg)
    del state
    ms = [h["ms"] for h in history[1:]]
    info.update(s_per_step=sum(ms) / len(ms) / 1e3,
                losses=[h["loss"] for h in history],
                checkpoint=sorted(p.name for p in ckpt.iterdir())
                if ckpt.exists() else [])
    if not all(math.isfinite(v) for v in info["losses"]) \
            or not info["checkpoint"]:
        _fail(f"[N] train_lm: losses {info['losses']}, checkpoint "
              f"{info['checkpoint']}")
    shutil.rmtree(ckpt, ignore_errors=True)

    sl = _example("serve_lm")
    for key, extra in (("serve_lm", []),
                       ("serve_lm_pallas", ["--sell", "acdc",
                                            "--sell-method", "pallas"])):
        (eng, reqs), info = run(key, sl.main, sl.DEFAULT_ARGV + extra
                                + dev_arg)
        info.update(finished=sum(r.done for r in reqs), requests=len(reqs),
                    tokens=sum(len(r.generated) for r in reqs),
                    decode_s=eng.stats["decode_s"],
                    decode_ticks=eng.stats["decode_ticks"])
        if info["finished"] != len(reqs):
            _fail(f"[N] {key}: {info['finished']} of {len(reqs)} finished")
        if extra and not info["launches"].get("acdc_cascade"):
            _fail(f"[N] {key}: no acdc_cascade launch ({info['launches']})")
        del eng, reqs
    torch.cuda.empty_cache()
    for key, info in out.items():
        print(f"[N] {key}: " + ", ".join(
            f"{k} {v}" for k, v in info.items()), flush=True)
    return out


def placed_serving(dev, totals) -> dict:
    """Path M: placed serving beside the unplaced steps, then the dry
    run's reckoning against the card (see the module docstring)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.dist import sharding
    from repro_torch.dist import steps as steps_mod
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import get_model
    from repro_torch.optim.optimizers import tree_map

    out_json = ROOT / "build" / "chip_smoke_dryrun.json"
    reckoner = dryrun.start_reckoning(list(PATH_M_RECKON), "acdc", out_json)
    try:
        cfg = registry.with_sell(registry.get_config("qwen3_1_7b"), "acdc",
                                 method="pallas")
        model = get_model(cfg)
        mesh = mesh_mod.make_host_mesh(1, dev.type)
        params = model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
        gen = torch.Generator().manual_seed(1)
        b, s, max_len, n_decode = 4, 64, 80, 8
        tokens = torch.randint(0, cfg.vocab_size, (b, s),
                               generator=gen).to(dev)
        lengths = torch.tensor([64, 50, 64, 37], dtype=torch.int32,
                               device=dev)

        def run(label, placed: bool, decode: bool = True) -> dict:
            m = mesh if placed else None
            prefill = steps_mod.make_prefill_step(model, cfg,
                                                  full_logits=True, mesh=m)
            serve = steps_mod.make_serve_step(model, cfg, mesh=m)
            p = params
            cache = model.init_cache(cfg, b, max_len, device=dev)
            if placed:
                p = sharding.place_params(tree_map(torch.clone, params),
                                          mesh)
                cache = sharding.place_cache(cache, mesh)
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, cache = prefill(p, cache, tokens, lengths)
                torch.cuda.synchronize()
                t_prefill = time.perf_counter() - t0
                prefill_cache = {k: v.clone() for k, v in cache.items()}
                tok = logits[torch.arange(b, device=dev),
                             lengths.long() - 1].argmax(-1)
                pos, stream = lengths.clone(), [tok]
                t1 = time.perf_counter()
                for _ in range(n_decode if decode else 0):
                    tok, cache = serve(p, cache, tok, pos)
                    pos = pos + 1
                    stream.append(tok)
                torch.cuda.synchronize()
            t_decode = (time.perf_counter() - t1) / max(n_decode, 1)
            launches = {k: v - before[k] for k, v in read_counts().items()
                        if v - before[k]}
            out = dict(logits=logits, prefill_cache=prefill_cache,
                       cache={k: v.clone() for k, v in cache.items()},
                       streams=torch.stack(stream).cpu(),
                       launches=launches, prefill_s=t_prefill,
                       decode_s=t_decode)
            del p, cache
            print(f"[M] {label}: prefill {t_prefill:.3f} s, decode "
                  f"{t_decode * 1e3:.1f} ms a step, launches {launches}",
                  flush=True)
            return out

        def same(a: dict, b: dict) -> list:
            """The parts of two runs that differ (bitwise)."""
            bad = [] if torch.equal(a["logits"], b["logits"]) else ["logits"]
            for part in ("prefill_cache", "cache"):
                bad += [f"{part}/{k}" for k in a[part]
                        if not torch.equal(a[part][k], b[part][k])]
            if not torch.equal(a["streams"], b["streams"]):
                bad.append("streams")
            return bad

        plain = run("unplaced", False)
        placed = run("placed (1, 1)", True)
        bad = same(plain, placed)
        if bad:
            _fail(f"[M] placed serving differs from unplaced: {bad}")
        if (placed["launches"] != plain["launches"]
                or not placed["launches"].get("scaled_matmul")):
            _fail(f"[M] launches placed {placed['launches']} vs unplaced "
                  f"{plain['launches']}")
        for side in (plain, placed):
            for name, n in side["launches"].items():
                totals[name] += n
        with rows_cut_wrong():
            ctl = run("control (K rows rolled)", True, decode=False)
        if torch.equal(ctl["prefill_cache"]["k"], plain["prefill_cache"]["k"]):
            _fail("[M] the faulty control (K cut from the wrong rows) "
                  "passes the check")
        info = dict(
            config="qwen3_1_7b full width, bf16 compute, acdc on pallas, "
                   "placed on a world-of-one (1, 1) NCCL mesh",
            streams=plain["streams"].tolist(),
            launches={"unplaced": plain["launches"],
                      "placed": placed["launches"]},
            prefill_s={"unplaced": plain["prefill_s"],
                       "placed": placed["prefill_s"]},
            decode_s={"unplaced": plain["decode_s"],
                      "placed": placed["decode_s"]},
            control_differs=["prefill_cache/k"])
        del plain, placed, ctl, params
        torch.cuda.empty_cache()
        print("[M] placed prefill + 8 decode steps bitwise equal to the "
              "unplaced steps; the control reads unequal", flush=True)

        card = {}
        for spec in PATH_M_RECKON:
            arch, cell, _, overrides = dryrun.parse_reckon(spec)
            fn, args = dryrun.build_cell(arch, cell, mesh, sell="acdc",
                                         cfg_overrides=overrides,
                                         device=dev.type)
            card[spec] = dryrun.measure_on_device(fn, args)
            del fn, args
            torch.cuda.empty_cache()
        want = dryrun.reckoned(reckoner, out_json, timeout=600)
    finally:
        if reckoner.poll() is None:
            reckoner.kill()
            reckoner.communicate()
    checks = {}
    for spec, got in card.items():
        w = want[spec]
        held = dryrun.compare(got, w, peak_rel=dryrun.PEAK_REL)
        if held["mismatches"]:
            _fail(f"[M] {spec}: the card against the dry run: "
                  f"{held['mismatches']}")
        checks[spec] = dict(dryrun=w, card=got, **held)
        gb = 1e9
        print(f"[M] {spec} on auto: flops {w['flops_per_device']:.4g} "
              f"equal, collectives {w['collectives']['count']} / "
              f"{w['collectives']['total_bytes']} B equal, arguments "
              f"{w['memory']['argument_size_in_bytes'] / gb:.4f} GB and "
              f"outputs {w['memory']['output_size_in_bytes'] / gb:.4f} GB "
              f"equal; peak above the arguments predicted "
              f"{w['memory']['temp_size_in_bytes'] / gb:.4f} GB, measured "
              f"{got['measured_temp_bytes'] / gb:.4f} GB "
              f"({held['peak_rel_err']:.5f}); dry-run trace "
              f"{w['trace_s']:.2f} s", flush=True)
    info["dryrun_vs_card"] = checks
    info["device"] = smi_line()
    print(f"[M] ({info['device']})", flush=True)
    return info


def drill_worker(out: str, argv: list) -> int:
    """One ``torchrun`` worker of the drain drill (``chip_smoke.py
    --drill-worker OUT.json <launcher flags>``): the train launcher's
    ``main(argv)``, then the kernel launches this process counted and the
    steps it ran, written to ``out``."""
    from repro_torch.kernels import autotune
    from repro_torch.launch import train

    reset_counts()
    _, hist = train.main(argv)
    device = argv[argv.index("--device") + 1]
    Path(out).write_text(json.dumps({
        "launches": read_counts(), "steps": len(hist),
        "autotune_sweeps": autotune.totals()[0],
        "autotune_plans": drill_plans(autotune.memo(), device)}))
    return 0


def drill_plans(memo: dict, device) -> dict:
    """The plans ``memo`` holds for the drill's requests, by key."""
    from repro_torch.kernels import autotune

    out = {}
    for direction, *dims in drill_requests(device):
        m, n, k, dt, bias, permute, fam = dims
        key = autotune.key_of(direction, (m, n, k), dt, bias, permute, fam)
        p = memo.get(key)
        out["|".join(map(str, key))] = (None if p is None
                                        else dataclasses.asdict(p))
    return out


def drain_drill(totals, device="cuda") -> dict:
    """Path K's drain drill at smoke width: the train launcher under
    ``torchrun --standalone --nproc-per-node 1`` with ``--compress-grads
    --sell-method pallas`` (cascade kernels at N = 128 / 256) gets SIGTERM
    after step 2 (the agent forwards it): it must print the ``[preempt]``
    line and leave a checkpoint at or above step 3 and below ``--steps``;
    ``--resume`` then prints ``resumed from step N`` and ``done.``.  Each
    run's worker is this script's ``--drill-worker`` mode, which reports
    the kernel launches counted in that process: both runs must launch
    exactly ``train_launches_per_step`` at smoke width a step they ran,
    and nothing else.  The workers read this process's autotune file
    (``REPRO_AUTOTUNE_CACHE_PATH``): each must sweep nothing and hold this
    process's winners for the drill's keys."""
    import os
    import selectors
    import signal

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.kernels import autotune
    from repro_torch.launch import train

    ckpt = ROOT / "build" / "chip_smoke_drain"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               REPRO_AUTOTUNE_CACHE_PATH=autotune._cache_path(),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else [])))

    def flags(steps, *extra):
        return ["--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
                "--sell-method", "pallas", "--compress-grads",
                "--global-batch", "4", "--seq-len", "64", "--log-every",
                "1", "--ckpt-every", "2", "--ckpt-dir", str(ckpt),
                "--device", device, "--steps", str(steps), *extra]

    def cmd(tag, steps, *extra):
        return [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "1",
                str(ROOT / "chip_smoke.py"), "--drill-worker",
                str(ckpt / f"{tag}.json"), *flags(steps, *extra)]

    args = train.parse_args(flags(1))
    cfg = registry.with_sell(registry.get_smoke_config(args.arch), args.sell,
                             method=args.sell_method,
                             transform=args.sell_transform)
    per_step = train_launches_per_step(cfg, args.global_batch * args.seq_len)

    def launched(tag, steps_run, text):
        got = json.loads((ckpt / f"{tag}.json").read_text())
        want = {k: v * steps_run for k, v in per_step.items()}
        if (got["steps"] != steps_run
                or {k: v for k, v in got["launches"].items() if v} != want):
            _fail(f"[K] drain drill ({tag}): {got['steps']} steps and "
                  f"launches {got['launches']}, want {steps_run} steps and "
                  f"{want} ({per_step} a step) and nothing else:\n"
                  + text[-3000:])
        mine = drill_plans(autotune.memo(), device)
        if got["autotune_sweeps"] or got["autotune_plans"] != mine \
                or None in mine.values():
            _fail(f"[K] drain drill ({tag}): {got['autotune_sweeps']} "
                  f"autotune sweeps, plans {got['autotune_plans']}; want 0 "
                  f"sweeps and this process's winners {mine}")
        for name, n in got["launches"].items():
            totals[name] += n
        return got["launches"]

    def run(tag, steps, *extra, stop_after=None):
        """(returncode, output, seconds from the start to the first step
        line, to the SIGTERM, to the exit) of one torchrun launch; with
        ``stop_after``, SIGTERM once step ``stop_after`` is printed."""
        t = time.perf_counter()
        proc = subprocess.Popen(cmd(tag, steps, *extra), cwd=ROOT, env=env,
                                text=True, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        lines, when = [], {}
        try:
            sel = selectors.DefaultSelector()
            sel.register(proc.stdout, selectors.EVENT_READ)
            deadline = time.time() + 180
            while time.time() < deadline:
                if not sel.select(timeout=5):
                    continue
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line)
                if not line.startswith("step"):
                    continue
                when.setdefault("first_step", time.perf_counter() - t)
                if (stop_after is not None and "signal" not in when
                        and int(line.split()[1]) >= stop_after):
                    proc.send_signal(signal.SIGTERM)
                    when["signal"] = time.perf_counter() - t
            proc.wait(timeout=max(deadline - time.time(), 1))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        when["exit"] = time.perf_counter() - t
        text = "".join(lines)
        (ckpt / f"{tag}.log").write_text(text)
        return proc.returncode, text, when

    t0 = time.perf_counter()
    rc1, out1, when1 = run("drain", 20000, stop_after=2)
    if "signal" not in when1:
        _fail("[K] drain drill: the launcher never reached step 2:\n"
              + out1[-3000:])
    saved = CheckpointManager(str(ckpt)).latest_step()
    if ("[preempt] SIGTERM received: draining + checkpointing" not in out1
            or "done." not in out1 or "SIGKILL" in out1):
        _fail("[K] drain drill: the launcher did not drain and finish "
              "inside torchrun's grace period:\n" + out1[-3000:])
    if saved is None or not 3 <= saved < 20000:
        _fail(f"[K] drain drill: checkpoint at {saved}, want >= 3 and "
              f"< --steps:\n" + out1[-3000:])
    drained = launched("drain", saved, out1)
    final = saved + 2
    rc2, out2, when2 = run("resume", final, "--resume")
    if (rc2 != 0 or f"resumed from step {saved}" not in out2
            or f"step {final - 1:5d}" not in out2 or "done." not in out2
            or CheckpointManager(str(ckpt)).latest_step() != final):
        _fail(f"[K] drain drill: the resume from {saved} did not finish "
              f"(rc {rc2}):\n" + out2[-3000:])
    resumed = launched("resume", final - saved, out2)
    info = dict(signal_after_step=2, drained_checkpoint=saved,
                resumed_to=final, agent_returncode=rc1,
                launches_per_step=per_step, launches_drain=drained,
                launches_resume=resumed, drain_s=when1, resume_s=when2,
                autotune_plans=drill_plans(autotune.memo(), device),
                worker_autotune_sweeps=0, seconds=time.perf_counter() - t0)
    print(f"[K] drain drill: SIGTERM after step 2, checkpoint at {saved}, "
          f"resumed to {final} (torchrun agent rc {rc1}); "
          f"launches {per_step} a step in both workers (drain "
          f"{ {k: v for k, v in drained.items() if v} }, resume "
          f"{ {k: v for k, v in resumed.items() if v} }); 0 autotune "
          f"sweeps in both, this process's winners for their "
          f"{len(info['autotune_plans'])} keys; {info['seconds']:.1f} s",
          flush=True)
    print("[K] drain drill seconds from each launch: drain "
          + ", ".join(f"{k} {v:.1f}" for k, v in when1.items())
          + "; resume " + ", ".join(f"{k} {v:.1f}" for k, v in when2.items()),
          flush=True)
    return info


def timed(report: dict, key: str, fn, *args):
    """``report[key] = fn(*args)``, its wall seconds in
    ``report["phase_s"]`` and its autotune sweeps (count, seconds) in
    ``report["autotune"]``."""
    from repro_torch.kernels import autotune

    n0, s0 = autotune.totals()
    t0 = time.perf_counter()
    report[key] = fn(*args)
    dt = time.perf_counter() - t0
    gc.collect()
    report.setdefault("phase_s", {})[key] = dt
    n1, s1 = autotune.totals()
    report.setdefault("autotune", {})[key] = dict(
        sweeps=n1 - n0, sweep_s=s1 - s0)
    print(f"[phase] {key}: {dt:.1f} s ({n1 - n0} autotune sweeps, "
          f"{s1 - s0:.1f} s)", flush=True)
    return report[key]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import autotune, build

    dev = torch.device("cuda", 0)
    # every key is swept in this run: no winner of an earlier one answers
    Path(autotune._cache_path()).unlink(missing_ok=True)
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
            if "groups" in r:
                continue    # grouped rows: printed as they were measured
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
    report["phase_s"] = {"build": build_s,
                         "kernels": time.perf_counter() - t0 - build_s}
    report["autotune"] = {"kernels": dict(sweeps=autotune.totals()[0],
                                          sweep_s=autotune.totals()[1])}
    timed(report, "autotune_phase", autotune_phase, dev)
    with plans_at_engine_build():
        run_paths(report, dev)
    timed(report, "autotune_memo", hold_memo, dev,
          report["autotune_phase"]["sweeps"])
    return finish(report, kern)


def run_paths(report: dict, dev) -> None:
    """Phases 4 - 9 and paths A - L, on the memo of the autotune phase
    (an engine's keys resolved as it is built)."""
    import torch

    from repro_torch.kernels import autotune

    def untimed(key, since, n0, s0):
        n1, s1 = autotune.totals()
        report["phase_s"][key] = time.perf_counter() - since
        report["autotune"][key] = dict(sweeps=n1 - n0, sweep_s=s1 - s0)

    timed(report, "fig2", fig2_speed, dev)
    totals = {name: 0 for name in KERNEL_MODULES}
    t_serve = time.perf_counter()
    n0, s0 = autotune.totals()

    params_cache = {}
    paths = []
    base = ["--arch", "qwen3_1_7b", "--sell", "acdc", "--sell-method",
            "pallas", "--slots", "4", "--prompt-len", "64",
            "--device", "cuda"]
    full = base + ["--gen", "16", "--requests", "8"]
    # warm-up: one short request so the timed runs do not pay the
    # first-call set-up of the libraries (not a main-path run)
    pieces = model_for({}, base)
    serve_path("warm-up", base + ["--gen", "2", "--requests", "1"],
               pieces, {k: 0 for k in KERNEL_MODULES}, ())
    nonspec_streams = {}
    for paged in (False, True):
        label = "full width " + ("paged" if paged else "dense")
        info, reqs, _, _ = serve_path(
            label, full + (["--paged"] if paged else []), pieces, totals,
            ("scaled_matmul",) + (("paged_attn",) if paged else ()))
        nonspec_streams[label.split()[-1]] = streams_of(reqs)
        paths.append(info)
    untimed("full_width_serve", t_serve, n0, s0)
    timed(report, "full_width_logits", compare_full_width_logits, pieces,
          dev)
    timed(report, "full_width_logits_fp32", compare_full_width_logits,
          pieces, dev, "float32")
    timed(report, "spec_full_width", spec_full_width, pieces, dev, totals,
          nonspec_streams)
    timed(report, "methods_full_width", methods_full_width, pieces, dev,
          totals)
    del pieces
    torch.cuda.empty_cache()

    smoke = ["--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
             "--sell-method", "pallas", "--slots", "4", "--prompt-len",
             "12", "--gen", "8", "--requests", "8", "--device", "cuda"]
    t_smoke = time.perf_counter()
    n0, s0 = autotune.totals()
    for label, extra, sell_k, need in (
            ("smoke dense", [], 2, ("acdc_cascade",)),
            ("smoke paged", ["--paged", "--block-size", "4"], 2,
             ("acdc_cascade", "paged_attn")),
            ("smoke K=1", [], 1, ("acdc_fused",))):
        pieces = model_for(params_cache, smoke, sell_k=sell_k)
        info, reqs, _, _ = serve_path(label, smoke + extra, pieces, totals,
                                      need)
        streams = streams_of(reqs)
        with plain_kernels():
            plain_streams = streams_of(serve_path(
                label + " (plain)", smoke + extra, pieces,
                {k: 0 for k in KERNEL_MODULES}, ())[1])
        if streams != plain_streams:
            _fail(f"{label}: greedy streams differ between kernels and "
                  f"plain versions")
        info["streams_identical_to_plain"] = True
        paths.append(info)
    untimed("smoke_serve", t_smoke, n0, s0)
    timed(report, "spec_smoke", smoke_spec, params_cache, totals)
    timed(report, "methods_smoke", smoke_methods, totals, dev)
    report["paths"] = paths
    timed(report, "train_full_width", train_full_width, dev, totals)
    with world_of_one(dev):
        with cut_depth():
            timed(report, "dist_full_width", dist_full_width, dev, totals)
            timed(report, "placed_full_width", placed_full_width, dev,
                  totals)
        timed(report, "placed_serving", placed_serving, dev, totals)
    timed(report, "drain_drill", drain_drill, totals)
    timed(report, "train_methods_full_width", train_methods_full_width, dev,
          totals)
    timed(report, "train_smoke", train_smoke, totals)
    with cut_depth():
        timed(report, "overload", overload_full_width, dev, totals)
        timed(report, "overload_spec", overload_spec_full_width, dev,
              totals)
    timed(report, "profile", profile_full_width, dev)
    del params_cache
    torch.cuda.empty_cache()
    timed(report, "dense_configs_full_width", dense_configs_full_width, dev,
          totals)
    timed(report, "dense_configs_smoke", smoke_configs, totals,
          ("gemma3_27b", "chatglm3_6b", "deepseek_67b"), 3, True)
    with cut_depth():
        timed(report, "moe_full_width", moe_full_width, dev, totals)
    timed(report, "moe_smoke", smoke_configs, totals,
          ("deepseek_moe_16b", "moonshot_v1_16b_a3b"), 5, False)
    with cut_depth():
        timed(report, "mamba2_full_width", recurrent_full_width, dev,
              totals, "mamba2_1_3b", False)
        timed(report, "zamba2_full_width", recurrent_full_width, dev,
              totals, "zamba2_1_2b", True)
        timed(report, "llava_full_width", llava_full_width, dev, totals)
    timed(report, "recurrent_smoke", smoke_configs, totals,
          ("mamba2_1_3b", "zamba2_1_2b", "llava_next_34b"), 3, True)
    with cut_depth():
        timed(report, "seamless_full_width", seamless_full_width, dev,
              totals)
    timed(report, "seamless_smoke", smoke_configs, totals,
          ("seamless_m4t_large_v2",), 3, True)
    timed(report, "examples", examples_path, dev, totals)
    report["launches"] = totals


def finish(report: dict, kern) -> int:
    """The kernels line and the last line, the report to
    ``chiprun_out/chip_smoke.json``."""
    import torch

    totals = report["launches"]

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
    if sys.argv[1:2] == ["--drill-worker"]:
        sys.exit(drill_worker(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
