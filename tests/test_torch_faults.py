"""Port parity, fault injection: ``repro_torch.serving.faults.FaultPlan``,
the allocator's fault hook and audit, the engine's range check and the
seeded chaos replay, each against the live reference.

* the same seed fires the same faults at the same decision points,
  surface by surface, however the surfaces interleave;
* the allocator's audit holds across every release path and a denying
  plan breaks no invariant (both allocators answer alike);
* a chaos run (tight pool, denied pages, spurious stalls, corrupt ticks,
  slow ticks) recovers clean: every request terminal, normal finishes
  stream exactly as a fault-free run, the pool leak-free — and the port
  agrees with the reference on streams, reasons and stats;
* a decode step that returns an out-of-range id is healed by requeue,
  as the reference heals it, and never committed;
* ``wall_clock_limit_s`` ends a livelocked loop with partial results.

Setup as test_torch_engine.py (qwen3 smoke, acdc/pallas, bridged
weights); streams and counts are compared exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import get_model as jget
from repro.optim.optimizers import tree_paths
from repro.serving import BlockAllocator as JAlloc
from repro.serving import Engine as JEngine
from repro.serving import FaultPlan as JFault
from repro.serving import Request as JRequest
from repro.obs import trace as jtrace
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.obs import trace as ttrace
from repro_torch.serving import BlockAllocator as TAlloc
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import FaultPlan as TFault
from repro_torch.serving import FinishReason
from repro_torch.serving import Request as TRequest

from _torch_clock import StepClock
from _torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# FaultPlan.
# ---------------------------------------------------------------------------

def _drive_plan(plan, order):
    """Call the plan's surfaces in ``order`` for 60 decision points and
    return every answer plus the ``injected`` counts."""
    seen = []
    for i in range(60):
        for surface in order:
            if surface == "alloc":
                seen.append(("alloc", plan.alloc_fail()))
            elif surface == "stall":
                seen.append(("stall", plan.spurious_stall(i % 3)))
            elif surface == "nan":
                seen.append(("nan", plan.logits_corrupt(i)))
            else:
                seen.append(("slow", plan.extra_tick_s(i)))
    return seen, dict(plan.injected)


PLANS = [dict(seed=9, p_alloc_fail=0.3, p_spurious_stall=0.2, p_nan=0.1,
              p_slow=0.2, slow_extra_s=1.5),
         dict(seed=3, p_alloc_fail=0.08, p_spurious_stall=0.04,
              nan_ticks=(5, 11), p_slow=0.05, slow_ticks=(6, 7),
              slow_extra_s=123.0),
         dict()]


@pytest.mark.parametrize("kw", PLANS, ids=["random", "chaos", "noop"])
@pytest.mark.parametrize("order", [("alloc", "stall", "nan", "slow"),
                                   ("slow", "nan", "alloc")])
def test_fault_plan_fires_like_reference(kw, order):
    got = _drive_plan(TFault(**kw), order)
    assert got == _drive_plan(JFault(**kw), order)
    if not kw:
        assert not any(v for _, v in got[0])


def test_fault_plan_surfaces_are_independent():
    """A surface's sequence does not depend on how the others are called
    between its draws (each draws from its own stream)."""
    a, b = TFault(seed=9, p_alloc_fail=0.3), TFault(seed=9, p_alloc_fail=0.3,
                                                    p_nan=0.5, p_slow=0.5)
    seq_a = [a.alloc_fail() for _ in range(50)]
    seq_b = []
    for i in range(50):
        b.logits_corrupt(i)
        seq_b.append(b.alloc_fail())
        b.extra_tick_s(i)
    assert seq_a == seq_b
    p = TFault(nan_ticks=(3,), slow_ticks=(5,), slow_extra_s=2.0)
    assert [p.logits_corrupt(t) for t in (2, 3)] == [False, True]
    assert [p.extra_tick_s(t) for t in (5, 6)] == [2.0, 0.0]
    assert p.injected == {"alloc_fail": 0, "spurious_stall": 0, "nan": 1,
                          "slow": 1}


# ---------------------------------------------------------------------------
# Allocator: audit across release paths, the fault hook.
# ---------------------------------------------------------------------------

def _release_paths(alloc_cls, trace_mod):
    tr = trace_mod.SpanTracer(clock=lambda: 0.0)
    trace_mod.set_global_tracer(tr)
    try:
        a = alloc_cls(n_blocks=6, block_size=4, n_slots=2,
                      max_blocks_per_slot=4)
        out = [a.audit()]
        a.alloc_slot(0, 7)
        out += [a.audit(), a.ensure_range(0, 8, 3), a.audit(),
                a.trim_slot(0, 9), a.audit()]
        a.alloc_slot(1, 3)
        out += [a.ensure_range(1, 4, 12), a.audit()]
        a.free_slot(0)
        a.free_slot(1)
        out.append(a.audit())
    finally:
        trace_mod.set_global_tracer(None)
    return out, [(i.track, i.name, i.args) for i in tr.instants]


def test_audit_clean_across_release_paths_like_reference():
    got = _release_paths(TAlloc, ttrace)
    assert got == _release_paths(JAlloc, jtrace)
    assert got[0][-1] == {"free": 6, "held": 0, "mapped": 0}
    assert len(got[1]) == 6          # one "audit" instant a call


def test_allocator_fault_denies_without_breaking_invariants():
    out = []
    for alloc_cls, fault_cls in ((TAlloc, TFault), (JAlloc, JFault)):
        plan = fault_cls(p_alloc_fail=1.0)
        a = alloc_cls(n_blocks=6, block_size=4, n_slots=2,
                      max_blocks_per_slot=4, fault=plan)
        out.append([a.can_admit(3), a.ensure_range(0, 0, 1), a.n_free,
                    a.audit(), dict(plan.injected)])
    assert out[0] == out[1]
    assert out[0][:3] == [False, False, 6]
    assert out[0][4]["alloc_fail"] == 2


# ---------------------------------------------------------------------------
# Engine.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jreg.with_sell(jreg.get_smoke_config("qwen3_1_7b"), "acdc",
                          method="pallas")
    tcfg = treg.with_sell(treg.get_smoke_config("qwen3_1_7b"), "acdc",
                          method="pallas")
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    flat = dict(zip(jax.tree.leaves(tree_paths(jp)),
                    (np.asarray(x) for x in jax.tree.leaves(jp))))
    return ((JEngine, JRequest, JFault, jm, jcfg, jp),
            (TEngine, TRequest, TFault, tm, tcfg,
             bridge.to_torch(flat, device="cpu")))


def _mk_requests(req_cls, vocab, n=7, seed=11):
    rs = np.random.RandomState(seed)
    return [req_cls(rid=i,
                    prompt=rs.randint(0, vocab,
                                      size=int(rs.randint(4, 17))).tolist(),
                    max_new_tokens=int(rs.randint(8, 13)))
            for i in range(n)]


def _streams(reqs):
    return [list(map(int, r.generated)) for r in reqs]


def test_chaos_run_recovers_clean_like_reference(models):
    """The reference's seeded chaos replay (tests/test_serving_faults.py)
    on both engines: recovery invariants on the port, and the port's
    streams, reasons and stats equal to the reference's."""
    runs = []
    for eng_cls, req_cls, fault_cls, model, cfg, params in models:
        def build(fault=None):
            # its own step clock: on the wall clock a loaded machine's
            # slow ticks moved one engine's ladder and not the other's
            return eng_cls(model, cfg, params, n_slots=3, max_len=48,
                           max_prompt_len=24, paged=True, block_size=8,
                           n_blocks=10, fault=fault, clock=StepClock())

        base = _mk_requests(req_cls, cfg.vocab_size)
        build().run(base, max_ticks=2000)
        reqs = _mk_requests(req_cls, cfg.vocab_size)
        fault = fault_cls(seed=3, p_alloc_fail=0.08, p_spurious_stall=0.04,
                          nan_ticks=(5, 11), p_slow=0.05, slow_extra_s=123.0)
        eng = build(fault)
        eng.run(reqs, max_ticks=4000)
        runs.append((base, reqs, eng, fault))
    (jbase, jreqs, jeng, jfault), (base, reqs, eng, fault) = runs
    assert all(r.finish_reason == "length" for r in base)
    assert all(r.done and r.finish_reason in FinishReason.ALL for r in reqs)
    assert eng.stats["corrupt_ticks"] >= 1 and eng.stats["requeued"] >= 1
    for b, r in zip(base, reqs):
        if r.finish_reason in ("eos", "length"):
            assert r.generated == b.generated
        else:
            assert b.generated[:len(r.generated)] == r.generated
    eng.allocator.audit()
    assert eng.allocator.n_free == eng.allocator.n_blocks
    assert _streams(reqs) == _streams(jreqs)
    assert _streams(base) == _streams(jbase)
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in jreqs]
    for key in ("prefill_dispatches", "decode_ticks", "tokens_out",
                "finished", "preempted", "requeued", "corrupt_ticks",
                "stalled_slot_ticks", "degrade_down", "degrade_up",
                "attn_gather_bytes", "attn_kernel_bytes"):
        assert eng.stats[key] == jeng.stats[key], key
    assert fault.injected == jfault.injected


@pytest.mark.parametrize("paged", [False, True])
def test_out_of_range_decode_ids_requeue_like_reference(models, paged):
    """The decode step returns an id outside the vocabulary for slot 0 on
    its third call (a corrupt decode): the slot is requeued and
    re-prefilled, the id never enters a stream, and streams, reasons and
    counts equal the reference's."""
    runs = []
    for side, bad in zip(models, (
            lambda tok, v: tok.at[0].set(v),
            lambda tok, v: torch.where(torch.arange(tok.shape[0]) == 0,
                                       torch.full_like(tok, v), tok))):
        eng_cls, req_cls, _, model, cfg, params = side
        kw = dict(n_slots=2, max_len=32, max_prompt_len=24)
        if paged:
            kw.update(paged=True, block_size=4)
        eng = eng_cls(model, cfg, params, clock=StepClock(), **kw)
        decode, calls = eng._decode, [0]

        def corrupt(*args, decode=decode, calls=calls, bad=bad,
                    vocab=cfg.vocab_size):
            tok, cache = decode(*args)
            calls[0] += 1
            return (bad(tok, vocab) if calls[0] == 3 else tok), cache

        eng._decode = corrupt
        reqs = _mk_requests(req_cls, cfg.vocab_size, n=4, seed=2)
        eng.run(reqs, max_ticks=400)
        runs.append((reqs, eng))
    (jreqs, jeng), (reqs, eng) = runs
    assert eng.stats["requeued"] == jeng.stats["requeued"] == 1
    assert sum(r.n_preemptions for r in reqs) == 1
    assert all(0 <= t < models[1][4].vocab_size
               for r in reqs for t in r.generated)
    assert _streams(reqs) == _streams(jreqs)
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in jreqs]
    for key in ("tokens_out", "prefill_dispatches", "decode_ticks"):
        assert eng.stats[key] == jeng.stats[key], key


def test_wall_clock_limit_exits_livelock(models):
    """A plan that denies every page livelocks the loop (nothing admits);
    ``wall_clock_limit_s`` exits with partial results."""
    _, (eng_cls, req_cls, fault_cls, model, cfg, params) = models
    eng = eng_cls(model, cfg, params, n_slots=2, max_len=48,
                  max_prompt_len=16, paged=True, block_size=8,
                  fault=fault_cls(p_alloc_fail=1.0))
    reqs = _mk_requests(req_cls, cfg.vocab_size, n=3)
    for r in reqs:
        r.prompt = r.prompt[:16]
    out = eng.run(reqs, wall_clock_limit_s=0.5)
    assert eng.wall_clock_exceeded
    assert all(not r.done for r in out)
    assert eng.stats["tokens_out"] == 0
    eng.allocator.audit()

