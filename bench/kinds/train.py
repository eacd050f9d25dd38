"""Training cells: the program's AdamW train step over a mix of kind
``train``.

Set-up builds one train state from the seed's weights and drives it
through three steps on distinct batches, through the step the window
calls; those steps build the kernels and sweep the launch plans, so
nothing compiles in the window.  The window then calls the same step on
the same state until ``--seconds`` have passed, each step ended by a
device synchronise.  A ``--trace 1`` run profiles ``trace_steps`` more
steps after the window.

What is judged (after the window, the program's state freed): the
reference, fp32, follows the first three steps from the same weights
on the same batches, and these numbers are worked out:

* ``loss_rel``: the widest relative gap of the three steps' losses;
  ``loss1_rel``: the first step's, which the later steps' drift does not
  move;
* ``grad1_gap``: the first step's gradient as the optimizer gets it
  (clipped; the program's worked out from its first moment after one
  step, ``m / (1 - b1)``), by the worst leaf: the gap between the two
  norms over the larger of the reference's norm of that leaf and of the
  median leaf;
* ``change3_gap``: the parameters' change after three steps (taken
  before the window's first step moves them), by the worst leaf as
  above, leaving out the leaves whose reference gradient norm is under a
  thousandth of the median leaf's (they move by round-off alone);
* ``grad1_median``, ``change3_median``: the same gaps of the median
  leaf, which the noise of one small leaf does not move;
* ``grad1_diff``, ``change3_diff`` and their ``_median``: the norm of
  the difference (of the first gradients; of the parameters after three
  steps) by the worst and the median leaf, over the same scale.  A gap
  of norms is second order in an error that is spread evenly over a
  leaf, and Adam's first steps move a parameter by about the learning
  rate whatever its gradient, so neither separates fp8 from bf16 here;
  the difference is first order.

Which of them a cell holds to a limit, its limits file says.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from typing import Dict, List

import torch

from bench import device as dv
from bench import weights
from bench.count import flops, kernels as kcount
from bench.reference import model as ref_model
from bench.reference import optim as ref_optim
from bench.traffic import train as gen

#: the steps the reference follows
CHECK_STEPS = 3
#: a leaf whose reference gradient norm is under this share of the
#: median leaf's moves by round-off alone and is left out of the change
ROUNDOFF_SHARE = 1e-3
#: kernels the traced stretch reads, by the regex of their names
PATTERNS = {"scaled_matmul": r"smm_(stream|tc|reduce)",
            "acdc_cascade": r"cascade_kernel",
            "acdc_cascade_bwd": r"cascade_bwd_kernel"}


def program_config(model: dict):
    from repro_torch.models.common import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(model) - fields
    if unknown:
        raise ValueError(f"keys the program's ModelConfig lacks: {unknown}")
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in model.items()})


def shapes_of(model_cfg) -> Dict[str, tuple]:
    """The program's parameter tree traced on ``meta``."""
    from repro_torch.models import get_model

    tree = get_model(model_cfg).init(torch.Generator(), model_cfg, "meta")
    return {k: tuple(v.shape) for k, v in weights.flatten(tree).items()}


def leaf_norms(tree: Dict[str, torch.Tensor], scale: float = 1.0
               ) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) * scale
            for k, v in tree.items()}


def change_norms(params: Dict[str, torch.Tensor], shapes, seed: int,
                 cfg: dict) -> Dict[str, float]:
    """||p - p0|| a leaf, p0 made again from the seed leaf by leaf."""
    out = {}
    for k, p in params.items():
        p0 = weights.make_leaf(k, shapes[k], seed, cfg, p.device)
        out[k] = float(torch.linalg.vector_norm(p.float() - p0))
        del p0
    return out


class Program:
    """The system under test: the program's train state and step."""

    def __init__(self, model: dict, mix: dict, seed: int, device):
        from repro_torch.dist import steps
        from repro_torch.models import get_model
        from repro_torch.optim.optimizers import (OptimizerConfig,
                                                  make_optimizer)
        from repro_torch.optim.schedules import constant_schedule

        o = mix["optimizer"]
        self.cfg = program_config(model)
        self.shapes = shapes_of(self.cfg)
        self.opt_cfg = OptimizerConfig(
            kind="adamw", lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
            groups=tuple((rx, dict(ov)) for rx, ov in o["groups"]))
        opt = make_optimizer(self.opt_cfg, constant_schedule(o["lr"]))
        params = weights.nest(weights.make(self.shapes, seed, model, device))
        self.state = {"params": params, "opt": opt.init(params), "step": 0}
        self.step_fn = steps.make_train_step(get_model(self.cfg), self.cfg,
                                             opt)

    def step(self, batch: dict) -> torch.Tensor:
        """One step of the program; returns its loss."""
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics["loss"]

    def first_steps(self, batches: List[dict], model: dict, seed: int,
                    b1: float) -> dict:
        """The checked steps: losses, the first gradient (from the first
        moment) and the parameters after the last one, both on the host,
        and the change's norms."""
        losses, g1 = [], None
        for i in range(CHECK_STEPS):
            losses.append(float(self.step(batches[i])))
            if i == 0:
                g1 = on_host(weights.flatten(self.state["opt"]["m"]),
                             1.0 / (1.0 - b1))
        params = weights.flatten(self.state["params"])
        return {"losses": losses, "grad1_t": g1,
                "params3_t": on_host(params),
                "change3": change_norms(params, self.shapes, seed, model)}


def on_host(tree: Dict[str, torch.Tensor], scale: float = 1.0
            ) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu() * scale for k, v in tree.items()}


def reference_record(model: dict, mix: dict, shapes, seed: int,
                     batches: List[dict], device, arith: str = "fp32"
                     ) -> dict:
    """The reference (``arith`` fp32; fp8 for the control) over the
    checked steps."""
    ref_model.no_tf32()
    net = ref_model.Model(model, device, ref_model.Arith(arith))
    params = weights.make(shapes, seed, model, device)
    out = ref_optim.train(net, params, batches[:CHECK_STEPS],
                          mix["optimizer"])
    rec = {"losses": out["losses"], "grad1_t": out["grads"],
           "params3_t": params,
           "change3": change_norms(params, shapes, seed, model)}
    return rec


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keys) -> Dict[str, float]:
    """Each leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keys}


def diff_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              scale: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's norm of the difference, over the larger of ``scale``
    of that leaf and of the median leaf."""
    keys = list(keys)
    med = statistics.median(scale[k] for k in keys)
    out = {}
    for k in keys:
        w = want[k]
        out[k] = float(torch.linalg.vector_norm(
            got[k].to(w.device) - w.float())) / max(scale[k], med, 1e-30)
    return out


def per_leaf(got: dict, want: dict) -> Dict[str, Dict[str, float]]:
    """Each leaf's gaps of a run (``got``) against the reference."""
    g_norm = leaf_norms(want["grad1_t"])
    g_med = statistics.median(g_norm.values())
    moved = [k for k, v in g_norm.items() if v >= ROUNDOFF_SHARE * g_med]
    return {
        "grad1": leaf_gaps(leaf_norms(got["grad1_t"]), g_norm, g_norm),
        "change3": leaf_gaps(got["change3"], want["change3"], moved),
        "grad1_diff": diff_gaps(got["grad1_t"], want["grad1_t"], g_norm,
                                g_norm),
        "change3_diff": diff_gaps(got["params3_t"], want["params3_t"],
                                  want["change3"], moved)}


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers of a run (``got``) against the reference."""
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(got["losses"], want["losses"])]
    out = {"loss_rel": max(rel), "loss1_rel": rel[0]}
    for what, gaps in per_leaf(got, want).items():
        name = what if what.endswith("diff") else what + "_gap"
        out[name] = max(gaps.values())
        out[name + "_median" if what.endswith("diff") else
            what + "_median"] = statistics.median(gaps.values())
    return out


def summary(rec: dict) -> dict:
    """A record without its tensors: what a run's readings keep."""
    return {k: v for k, v in rec.items() if not k.endswith("_t")}


def run(ctx) -> dict:
    """One run of a training cell (``ctx``: :class:`bench.harness.Run`)."""
    model, mix, seed, dev = ctx.model, ctx.mix, ctx.seed, ctx.device
    o = mix["optimizer"]
    batches = gen.batches(mix, model, seed, dev)
    prog = Program(model, mix, seed, dev)
    rec = prog.first_steps(batches, model, seed, o["b1"])
    dv.sync(dev)
    setup_peak = dv.peak(dev)
    dv.reset_peak(dev)

    t0 = ctx.open_window()
    n, losses = 0, []
    while True:
        losses.append(prog.step(batches[(CHECK_STEPS + n) % len(batches)]))
        dv.sync(dev)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    window_peak = dv.peak(dev)
    failed = sum(1 for x in losses if not torch.isfinite(x).item())

    art = {"kind": "train", "model": model, "window_s": window_s,
           "steps": n, "tokens_per_step": gen.tokens_per_step(mix),
           "flops_per_step": flops.train_step(model, mix["rows"], mix["seq"],
                                              mix.get("frames", 0)),
           "window_peak_bytes": window_peak}
    device = {"memory_peak_bytes": max(setup_peak, window_peak)}
    if ctx.trace:
        art.update(trace_steps(prog, batches, n, mix, model, ctx))
        device["busy_s"] = art["trace"]["busy_s"]
        device["window_s"] = art["trace"]["span_s"]
    shapes = prog.shapes
    del prog
    gc.collect()
    dv.free(dev)

    want = reference_record(model, mix, shapes, seed, batches, dev)
    checks = compare(rec, want)
    metrics = {"train_tok_s": n * art["tokens_per_step"] / window_s}
    return {"attempted": n, "failed": failed, "e2e": metrics, "art": art,
            "device": device, "checks": checks,
            "readings": {"program": summary(rec), "reference": summary(want),
                         "numbers": checks}}


def trace_steps(prog: Program, batches, done: int, mix: dict, model: dict,
                ctx) -> dict:
    """Profile ``trace_steps`` steps after the window."""
    from bench import trace
    from repro_torch.kernels import acdc_cascade_bwd as cbwd
    from repro_torch.kernels import acdc_cascade_fused as cfwd
    from repro_torch.kernels import scaled_matmul as smm

    steps = mix["trace_steps"]
    counters = (smm, cfwd, cbwd)
    before = [c.launches for c in counters]
    prof = trace.start(ctx.device)
    for i in range(steps):
        with torch.profiler.record_function("train_step"):
            prog.step(batches[(CHECK_STEPS + done + i) % len(batches)])
            dv.sync(ctx.device)
    got = trace.stop(prof, ctx.out_dir, "train_step", PATTERNS)
    counted = dict(zip(("scaled_matmul", "acdc_cascade", "acdc_cascade_bwd"),
                       (c.launches - b for c, b in zip(counters, before))))
    inventory = kcount.totals(kcount.train_step(
        model, mix["rows"], mix["seq"], mix.get("frames", 0)))
    return {"trace": got, "trace_steps": steps, "launch_counters": counted,
            "inventory": {k: {"launches": v["launches"] * steps,
                              "bound_s": v["bound_s"] * steps}
                          for k, v in inventory.items()}}
