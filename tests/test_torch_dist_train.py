"""Port parity, data-parallel training over gloo on the CPU.

* **Two gloo ranks against the reference.**  Two compressed steps of
  smoke Qwen3-1.7B (``acdc`` on ``pallas``, fp32, batch 4 x 32, the
  launcher's AdamW) on two port processes, against the reference's
  ``make_train_step(compress_mesh=...)`` on two forced host devices (a
  subprocess, ``_jax_compressed_steps.py``), from one state and the same
  batches.  The int8 quantizer is a step function of the gradient, and
  the two packages sum the gradients in other orders (~1e-5 relative), so
  an element whose quotient x / scale sits at a rounding boundary can get
  the adjacent int8 level on one side.  So:
  - each step, each rank: the block scales within fp32 tolerance; the
    int8 levels equal except at such elements: at step 0 one level apart
    with the port's quotient within 0.01 of a half-integer; later, also
    in a block that carried a differing level from an earlier step (its
    residual and so its inputs differ by a quantization step, which is
    up to two levels where the scale halved);
  - the error-feedback identity: what a rank has sent up to a step,
    sum of q x scale, differs from the reference's by at most the two
    residuals, half a quantization step each (plus 1% of a step for the
    gradients' fp32 differences, 1e-5 of at most 127 levels);
  - loss, grad norm and update norm every step, and every parameter,
    moment and both ``grad_error`` rows at the end, at fp32 atol 2e-4 /
    rtol 1e-3 (tests/test_kernel_grads.py:248) on every element whose
    level agreed on both ranks at every step;
  - the elements whose level differed are counted (at most 1e-3 of the
    elements) and held to what the differing levels move: the residual
    within half a quantization step; the mean gradient of a step differs
    by D = |sum over ranks of the difference of q x scale| / 2, so the
    first moment
    by at most sum (1 - b1) b1^k D, the root of the second by at most
    sqrt(sum (1 - b2) b2^k D^2) (a weighted L2 norm), and the parameter
    by at most twice the largest AdamW step, lr x lr_mult x max
    |m_hat / sqrt(v_hat)| (Cauchy-Schwarz), plus weight decay on the
    difference, each plus the fp32 tolerance;
  - the parameters bitwise equal on both ranks (replicated).
* **Plain data parallelism.**  An uncompressed two-rank step equals a
  one-process step on the whole batch (fp32 tolerance).
* **Elastic-safe resume** (the port of the reference's red
  ``test_compressed_resume_reinit_residuals``): a checkpoint without
  ``grad_error`` and one with another rank axis re-zero the residuals; a
  matching one keeps them.
* **Drain drill.**  Four ranks (``torchrun``'s variables, one process
  each) with ``--compress-grads``; SIGTERM to rank 1 only: every rank
  agrees to stop on the same step, rank 0 checkpoints at step + 1 and all
  exit 0; then three processes resume: the elastic policy keeps two data
  ranks, the third exits, the residuals reset (rank axis 4 -> 2) and the
  run finishes.

Every child sets ``OMP_NUM_THREADS=1`` and has its own timeout; the test
kills what is left.
"""

import os
import re
import selectors
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry as treg
from repro_torch.dist import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model as tget
from repro_torch.optim import OptimizerConfig, constant_schedule, \
    make_optimizer

import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-4, rtol=1e-3)
N_STEPS = 2


def _close(got, want) -> np.ndarray:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want) <= F32["atol"] + F32["rtol"] * np.abs(want)


def _finish(procs, timeout: float) -> list:
    """(returncode, output) of every process; kills them past timeout."""
    out = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            out.append((p.returncode, text or ""))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two steps, then the port's on two gloo ranks,
    compressed and plain (all four ranks at once)."""
    d = tmp_path_factory.mktemp("dist_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_jax_compressed_steps.py"),
         str(d / "ref.npz"), str(N_STEPS)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    script = str(ROOT / "tests" / "_torch_dist_worker.py")
    procs = []
    for compress in ("1", "0"):
        procs += worker.launch_ranks(
            2, [script, str(d / "ref.npz"), str(d / f"port{compress}_"),
                compress], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for rc, text in _finish(procs, 300):
        assert rc == 0, text
    load = lambda name: np.load(d / name)  # noqa: E731
    return dict(ref=load("ref.npz"),
                compressed=[load(f"port1_{r}.npz") for r in range(2)],
                plain=[load(f"port0_{r}.npz") for r in range(2)])


def _flips(ref, ports):
    """({path: bool mask} of the elements whose int8 level differed on
    some rank at some step, {path: [D of each step]}, D per element what
    the differing levels moved the mean gradient by); checks each
    difference is explained."""
    paths = sorted(k[len("q0/"):] for k in ports[0].files
                   if k.startswith("q0/"))
    assert paths and len(paths) == sum(1 for k in ref.files
                                       if k.startswith("q0r0/"))
    mask, dg, sent = {}, {path: [] for path in paths}, {}
    for step in range(N_STEPS):
        for path in paths:
            dg[path].append(0.0)
        for rank, port in enumerate(ports):
            for path in paths:
                qp = port[f"q{step}/{path}"].astype(np.int64)
                qr = ref[f"q{step}r{rank}/{path}"].astype(np.int64)
                sp = port[f"scale{step}/{path}"]
                sr = ref[f"scale{step}r{rank}/{path}"]
                assert _close(sp, sr).all(), (step, rank, path)
                diff = qp != qr
                x = port[f"x{step}/{path}"]
                near_half = np.abs(np.abs(x - np.trunc(x)) - 0.5) < 0.01
                n = ref[f"final/params/{path}"].size
                carried = mask.get(path, np.zeros(n, bool))
                blocks = np.pad(carried, (0, qp.size - n)).reshape(
                    qp.shape).any(axis=1, keepdims=True)
                if step == 0:
                    ok = near_half & (np.abs(qp - qr) <= 1)
                else:
                    ok = near_half | blocks
                assert (ok | ~diff).all(), (
                    f"step {step} rank {rank} {path}: int8 levels differ "
                    f"away from a rounding boundary: "
                    f"{np.argwhere(diff & ~ok)[:5]}")
                mask[path] = carried | diff.reshape(-1)[:n]
                moved = (qp * sp.astype(np.float64)
                         - qr * sr.astype(np.float64))
                total = sent.get((rank, path), 0.0) + moved
                sent[(rank, path)] = total
                held = (sp + sr) / 2 * 1.01
                assert (np.abs(total) <= held).all(), (
                    f"step {step} rank {rank} {path}: error feedback lost "
                    f"{np.argwhere(np.abs(total) > held)[:5]}")
                dg[path][step] = dg[path][step] + moved.reshape(-1)[:n]
    dg = {path: [np.abs(d) / len(ports) for d in ds]
          for path, ds in dg.items()}
    return mask, dg


def _group(path: str, key: str, default: float) -> float:
    """The optimizer's per-leaf override, first matching group wins."""
    for rx, over in worker.OPT.groups:
        if re.search(rx, path):
            return over.get(key, default)
    return default


def _adam_ratio(t: int) -> float:
    """The most |m_hat / sqrt(v_hat)| can be after t steps."""
    b1, b2 = worker.OPT.b1, worker.OPT.b2
    k = np.arange(t)[::-1]
    a = (1 - b1) * b1 ** k / (1 - b1 ** t)
    b = (1 - b2) * b2 ** k / (1 - b2 ** t)
    return float(np.sqrt(np.sum(a * a / b)))


def _flipped_bounds(path: str, leaf: str, d: list, want: np.ndarray):
    """The most the state leaf ``path`` may differ from the reference's
    ``want`` at an element whose int8 level differed, per element."""
    b1, b2 = worker.OPT.b1, worker.OPT.b2
    want = np.abs(want.reshape(-1).astype(np.float64))
    k = np.arange(len(d))[::-1]
    if path.startswith("opt/m/"):
        return sum((1 - b1) * b1 ** j * dj for j, dj in zip(k, d))
    if path.startswith("opt/v/"):
        root = np.sqrt(sum((1 - b2) * b2 ** j * dj ** 2
                           for j, dj in zip(k, d)))
        return 2 * root * np.sqrt(want) + root ** 2
    mult = _group(leaf, "lr_mult", 1.0)
    wd = _group(leaf, "weight_decay", worker.OPT.weight_decay)
    bound = 0.0
    for t in range(len(d)):
        lr = float(worker.SCHEDULE(t)) * mult
        bound = bound * (1 + lr * wd) + 2 * lr * _adam_ratio(t + 1)
    return np.full(want.shape, bound)


def test_two_ranks_compressed_match_reference(runs):
    ref, ports = runs["ref"], runs["compressed"]
    mask, dg = _flips(ref, ports)
    total = sum(m.size for m in mask.values())
    flipped = sum(int(m.sum()) for m in mask.values())
    assert flipped <= 1e-3 * total, (flipped, total)
    for name in worker.METRICS:
        for port in ports:
            assert _close(port[name], ref[name]).all(), (
                name, port[name], ref[name])
    state_paths = [k for k in ports[0].files
                   if k.startswith(("params/", "opt/", "grad_error/"))]
    assert sorted(state_paths + ["step"]) == sorted(
        k[len("final/"):] for k in ref.files if k.startswith("final/"))
    assert int(ports[0]["step"]) == int(ref["final/step"]) == N_STEPS
    for path in state_paths:
        leaf = path.split("/", 2)[-1] if path.startswith("opt/") \
            else path.split("/", 1)[1]
        keep = ~mask[leaf]
        want = ref[f"final/{path}"]
        if path.startswith("grad_error/"):
            assert want.shape[0] == 2
            for rank, port in enumerate(ports):
                got = port[path]
                assert got.shape == (1,) + want.shape[1:]
                ok = _close(got[0], want[rank]).reshape(-1)
                assert ok[keep].all(), (path, rank)
                # where a level differed: each residual within the bound
                scale = port[f"scale{N_STEPS - 1}/{leaf}"]
                bound = np.repeat(scale[:, 0], 256)[:keep.size] / 2 + 1e-6
                flat = got[0].reshape(-1)
                assert (np.abs(flat[~keep]) <= bound[~keep]).all(), path
        else:
            got = ports[0][path]
            ok = _close(got, want).reshape(-1)
            assert ok[keep].all(), (path, np.argwhere(~ok & keep)[:5])
            np.testing.assert_array_equal(got, ports[1][path])
            # where a level differed: within what one level can move
            bound = _flipped_bounds(path, leaf, dg[leaf], want)
            gap = np.abs(got.astype(np.float64) - want).reshape(-1)
            tol = F32["atol"] + F32["rtol"] * np.abs(want).reshape(-1)
            far = ~keep & (gap > bound + tol)
            assert not far.any(), (path, np.argwhere(far)[:5])


def test_two_rank_plain_step_equals_full_batch(runs):
    ref, ports = runs["ref"], runs["plain"]
    flat, metrics = worker.run_steps(ref, compress=False)
    for name in worker.METRICS:
        for port in ports:
            np.testing.assert_allclose(port[name], metrics[name], **F32)
    assert not any(k.startswith("grad_error/") for k in ports[0].files)
    for path, want in flat.items():
        np.testing.assert_allclose(ports[0][path], want, err_msg=path,
                                   **F32)
        np.testing.assert_array_equal(ports[0][path], ports[1][path])


def _argv(ckpt, steps, *extra, batch=2):
    return ["--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
            "--sell-method", "pallas", "--device", "cpu", "--steps",
            str(steps), "--seq-len", "16", "--global-batch", str(batch),
            "--ckpt-every", "2", "--ckpt-dir", str(ckpt), "--log-every",
            "1", *extra]


def _error_rows(ckpt, step) -> dict:
    d = Path(ckpt) / f"step_{step:010d}" / "arrays"
    return {f.name: np.load(f) for f in sorted(d.glob("grad_error__*"))}


def test_compressed_resume_reinit_residuals(tmp_path, capsys):
    # phase 1: a checkpoint without compression, resumed WITH it
    ttrain.main(_argv(tmp_path, 2))
    ttrain.main(_argv(tmp_path, 4, "--resume", "--compress-grads"))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "[compress] residual rank axis None -> 1: resetting error " \
        "feedback" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    rows = _error_rows(tmp_path, 4)
    assert rows and all(r.shape[0] == 1 for r in rows.values())
    assert any(np.abs(r).max() > 0 for r in rows.values())

    # a matching rank axis keeps the residuals (a no-op resume re-saves)
    ttrain.main(_argv(tmp_path, 4, "--resume", "--compress-grads"))
    assert "resetting" not in capsys.readouterr().out
    again = _error_rows(tmp_path, 4)
    assert all(np.array_equal(rows[k], again[k]) for k in rows)

    # phase 2: forge residuals of two data ranks; resume on one
    cfg = treg.with_sell(treg.get_smoke_config("qwen3_1_7b"), "acdc",
                         method="pallas")
    opt = make_optimizer(OptimizerConfig(kind="adamw"),
                         constant_schedule(1e-3))
    state = tsteps.init_state(tget(cfg), cfg, opt,
                              torch.Generator().manual_seed(0), "cpu",
                              compress_dp=2)
    CheckpointManager(str(tmp_path)).save(6, state)
    _, hist = ttrain.main(_argv(tmp_path, 8, "--resume", "--compress-grads"))
    out = capsys.readouterr().out
    assert "[compress] residual rank axis 2 -> 1: resetting error " \
        "feedback" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert CheckpointManager(str(tmp_path)).latest_step() == 8


def _launch(n, ckpt, steps, *extra):
    return worker.launch_ranks(
        n, ["-m", "repro_torch.launch.train",
            *_argv(ckpt, steps, "--compress-grads", "--model-parallel",
                   "1", *extra, batch=8)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_drain_drill_four_ranks_then_two(tmp_path):
    ckpt = tmp_path / "ckpt"
    procs = _launch(4, ckpt, 20000)
    try:
        sel = selectors.DefaultSelector()
        sel.register(procs[0].stdout, selectors.EVENT_READ)
        lines, sent = [], False
        deadline = time.time() + 240
        while time.time() < deadline and not sent:
            if not sel.select(timeout=10):
                continue
            line = procs[0].stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("step") and int(line.split()[1]) >= 2:
                procs[1].send_signal(signal.SIGTERM)     # one rank only
                sent = True
        assert sent, "rank 0 never reached step 2:\n" + "".join(lines)
    finally:
        results = _finish(procs, 180)
    out0 = "".join(lines) + results[0][1]
    for rank, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {rank}:\n{text}\n--- rank 0:\n{out0}"
    assert "[elastic] resolved mesh data=4 model=1 from 4 devices" in out0
    assert "[preempt] SIGTERM received: draining + checkpointing" in out0
    assert "done." in out0
    saved = CheckpointManager(str(ckpt)).latest_step()
    assert saved is not None and 3 <= saved < 20000, out0
    assert all(r.shape[0] == 4 for r in _error_rows(ckpt, saved).values())

    # shrink: three processes, the policy keeps two data ranks
    final = saved + 2
    results = _finish(_launch(3, ckpt, final, "--resume"), 240)
    for rank, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {rank}:\n{text}"
    out0 = results[0][1]
    assert "[elastic] resolved mesh data=2 model=1 from 3 devices" in out0
    assert "[elastic] rank 2 is outside the resolved mesh: exiting" in \
        results[2][1]
    assert "[compress] residual rank axis 4 -> 2: resetting error " \
        "feedback" in out0
    assert f"resumed from step {saved}" in out0
    assert f"step {final - 1:5d}" in out0 and "done." in out0
    assert CheckpointManager(str(ckpt)).latest_step() == final
    assert all(r.shape[0] == 2 for r in _error_rows(ckpt, final).values())
