"""Port parity, overload resilience: preempt-and-requeue with recompute,
deadline-aware scheduling, aging and the degradation ladder of
``repro_torch.serving.Engine``, each held against the live
``repro.serving.Engine`` under the same ``FakeClock``.

The acceptance criterion is the reference's: a greedy stream disturbed by
preemption, deadline eviction or a ladder move is identical to (or a
prefix of) the undisturbed run — and here, also identical to what the
reference engine does in the same situation (streams, finish reasons and
counts, exactly).  Setup as test_torch_engine.py (qwen3 smoke,
acdc/pallas, bridged weights).
"""

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import get_model as jget
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import FaultPlan as JFault
from repro.serving import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import FaultPlan as TFault
from repro_torch.serving import Request as TRequest
from repro_torch.serving import RequestStatus
from repro_torch.serving import Scheduler as TScheduler

from _torch_threads import one_torch_thread  # noqa: F401


class FakeClock:
    """Deterministic wall clock the deadline tests advance by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------------
# Scheduler copy: EDF order, priority, expiry, aging.
# ---------------------------------------------------------------------------

def _edf(sched_cls, req_cls):
    s = sched_cls(n_slots=3)
    reqs = [req_cls(rid=0, prompt=[1]), req_cls(rid=1, prompt=[1],
                                                deadline_s=5.0),
            req_cls(rid=2, prompt=[1], deadline_s=1.0)]
    for r in reqs:
        r.t_submit = 0.0
        s.submit(r)
    return [r.rid for _, r in s.admit()]


def _priority(sched_cls, req_cls):
    s = sched_cls(n_slots=3)
    for rid, prio in ((0, 0), (1, 3), (2, 0)):
        s.submit(req_cls(rid=rid, prompt=[1], priority=prio))
    return [r.rid for _, r in s.admit()]


def _expire(sched_cls, req_cls):
    s = sched_cls(n_slots=1)
    for rid, d in ((0, 1.0), (1, 9.0), (2, None)):
        r = req_cls(rid=rid, prompt=[1], deadline_s=d)
        r.t_submit = 0.0
        s.submit(r)
    return [r.rid for r in s.expire(2.0)], [r.rid for r in s.queue]


def _aging(sched_cls, req_cls):
    cap = [1]
    s = sched_cls(n_slots=1, admit_ok=lambda r: r.prompt_len <= cap[0],
                  window=4, age_limit=2)
    big = req_cls(rid=0, prompt=[0] * 5)
    s.submit(big)
    for i in range(1, 5):
        s.submit(req_cls(rid=100 + i, prompt=[0]))
    seen = []
    for _ in range(5):
        adm = s.admit()
        seen.append([r.rid for _, r in adm])
        for slot, _ in adm:
            s.release(slot)
    cap[0] = 5
    seen.append([r.rid for _, r in s.admit()])
    return seen, big.sched_skips


@pytest.mark.parametrize("script", [_edf, _priority, _expire, _aging],
                         ids=lambda f: f.__name__.strip("_"))
def test_scheduler_copy_matches_reference(script):
    got = script(TScheduler, TRequest)
    assert got == script(JScheduler, JRequest)
    if script is _edf:
        assert got == [2, 1, 0]
    if script is _aging:
        assert got[0][:2] == [[101], [102]] and got[0][-1] == [0]


# ---------------------------------------------------------------------------
# Engine fixtures.
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


def _mk_requests(req_cls, vocab, n=4, seed=5, max_new=10, **kw):
    rs = np.random.RandomState(seed)
    return [req_cls(rid=i,
                    prompt=rs.randint(0, vocab,
                                      size=int(rs.randint(4, 12))).tolist(),
                    max_new_tokens=max_new, **kw)
            for i in range(n)]


def _drain(eng, limit=600):
    ticks = 0
    while eng.has_work:
        eng.tick()
        ticks += 1
        assert ticks < limit, "engine failed to drain"
    return ticks


def _outcome(reqs, eng, keys=("tokens_out", "prefill_dispatches",
                              "decode_ticks", "preempted", "requeued",
                              "timeout", "rejected", "deadline_preempts",
                              "degrade_down", "degrade_up", "finished")):
    return ([list(map(int, r.generated)) for r in reqs],
            [r.finish_reason for r in reqs],
            [r.n_preemptions for r in reqs],
            {k: eng.stats[k] for k in keys})


def _both(models, scenario):
    """Run ``scenario(engine class, request class, fault class, model,
    cfg, params)`` on the reference and the port; assert the outcomes are
    equal and return the port's."""
    jout, tout = (scenario(*side) for side in models)
    assert tout == jout
    return tout


# ---------------------------------------------------------------------------
# Preempt-and-requeue with recompute.
# ---------------------------------------------------------------------------

def test_preempt_requeue_streams_unchanged_like_reference(models):
    def scenario(eng_cls, req_cls, _, model, cfg, params):
        def build():
            return eng_cls(model, cfg, params, n_slots=2, max_len=64,
                           max_prompt_len=32, paged=True, block_size=8)

        base = _mk_requests(req_cls, cfg.vocab_size)
        build().run(base, max_ticks=600)
        reqs = _mk_requests(req_cls, cfg.vocab_size)
        eng = build()
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.tick()
        victims = [slot for slot, r in eng.scheduler.active()
                   if not r.done]
        for slot in victims:
            eng.preempt(slot)
        _drain(eng)
        eng.allocator.audit()
        assert [r.generated for r in reqs] == [r.generated for r in base]
        return _outcome(reqs, eng), len(victims)

    out, victims = _both(models, scenario)
    assert victims == 2 and out[3]["requeued"] >= 2


@pytest.mark.parametrize("max_preemptions", [4, 0])
def test_all_stalled_deadlock_like_reference(models, max_preemptions):
    """Both slots admit then deadlock on growth: the victim requeues (or,
    with no budget, is evicted as ``preempted_limit`` with a clean
    prefix), as the reference does."""
    def scenario(eng_cls, req_cls, _, model, cfg, params):
        rs = np.random.RandomState(7)
        prompts = [rs.randint(0, cfg.vocab_size, size=15).tolist()
                   for _ in range(2)]
        base = [req_cls(rid=i, prompt=p, max_new_tokens=10)
                for i, p in enumerate(prompts)]
        eng_cls(model, cfg, params, n_slots=2, max_len=64,
                max_prompt_len=24, paged=True,
                block_size=8).run(base, max_ticks=600)
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=10,
                        max_preemptions=max_preemptions)
                for i, p in enumerate(prompts)]
        eng = eng_cls(model, cfg, params, n_slots=2, max_len=64,
                      max_prompt_len=24, paged=True, block_size=8,
                      n_blocks=4)
        eng.run(reqs, max_ticks=600)
        eng.allocator.audit()
        assert eng.allocator.n_free == eng.allocator.n_blocks
        for b, r in zip(base, reqs):
            assert b.generated[:len(r.generated)] == r.generated
        return _outcome(reqs, eng)

    out = _both(models, scenario)
    if max_preemptions:
        assert out[3]["requeued"] >= 1 and out[1] == ["length", "length"]
    else:
        assert out[3]["requeued"] == 0
        assert sorted(out[1]) == ["length", "preempted_limit"]


# ---------------------------------------------------------------------------
# Deadlines (virtual clock).
# ---------------------------------------------------------------------------

def test_deadline_timeout_queued_and_active_like_reference(models):
    def scenario(eng_cls, req_cls, _, model, cfg, params):
        clock = FakeClock()
        eng = eng_cls(model, cfg, params, n_slots=1, max_len=48,
                      max_prompt_len=16, clock=clock)
        rs = np.random.RandomState(2)
        hog = req_cls(rid=0, prompt=rs.randint(0, cfg.vocab_size,
                                               size=6).tolist(),
                      max_new_tokens=12, deadline_s=100.0)
        late = req_cls(rid=1, prompt=rs.randint(0, cfg.vocab_size,
                                                size=6).tolist(),
                       max_new_tokens=12, deadline_s=1.0)
        eng.submit(hog)
        eng.tick()
        eng.submit(late)
        clock.t = 2.0                   # past late's deadline, queued
        eng.tick()
        assert late.finish_reason == "timeout" and late.generated == []
        clock.t = 101.0                 # past hog's deadline, mid-stream
        eng.tick()
        assert hog.finish_reason == "timeout"
        assert 0 < len(hog.generated) < 12
        return _outcome([hog, late], eng), (hog.t_finish, late.t_finish)

    out, t_finish = _both(models, scenario)
    assert out[3]["timeout"] == 2 and t_finish == (101.0, 2.0)


def test_engine_admits_earliest_deadline_first_like_reference(models):
    def scenario(eng_cls, req_cls, _, model, cfg, params):
        eng = eng_cls(model, cfg, params, n_slots=1, max_len=48,
                      max_prompt_len=16, clock=FakeClock())
        rs = np.random.RandomState(3)
        reqs = [req_cls(rid=i, prompt=rs.randint(0, cfg.vocab_size,
                                                 size=5).tolist(),
                        max_new_tokens=4, deadline_s=d)
                for i, d in enumerate([None, 50.0, 5.0])]
        for r in reqs:
            eng.submit(r)
        eng.tick()
        first = [r.rid for r in reqs if r.status.value != "queued"]
        _drain(eng)
        return _outcome(reqs, eng), [str(first)]

    out, first = _both(models, scenario)
    assert first == ["[2]"] and out[1] == ["length"] * 3


def test_deadline_preempts_slack_rich_request_like_reference(models):
    def scenario(eng_cls, req_cls, _, model, cfg, params):
        rs = np.random.RandomState(4)
        hog_prompt = rs.randint(0, cfg.vocab_size, size=6).tolist()
        urgent_prompt = rs.randint(0, cfg.vocab_size, size=6).tolist()
        base = req_cls(rid=0, prompt=hog_prompt, max_new_tokens=10)
        eng_cls(model, cfg, params, n_slots=1, max_len=48,
                max_prompt_len=32).run([base], max_ticks=200)
        clock = FakeClock()
        eng = eng_cls(model, cfg, params, n_slots=1, max_len=48,
                      max_prompt_len=32, clock=clock)
        hog = req_cls(rid=0, prompt=hog_prompt, max_new_tokens=10)
        eng.submit(hog)
        eng.tick()
        urgent = req_cls(rid=1, prompt=urgent_prompt, max_new_tokens=4,
                         deadline_s=0.5)
        eng.submit(urgent)              # t_submit = 0.0
        clock.t = 0.46                  # slack 0.04 < margin 0.05
        eng.tick()
        states = [hog.status.value, urgent.status.value]
        _drain(eng)
        assert hog.generated == base.generated
        return _outcome([hog, urgent], eng), states

    out, states = _both(models, scenario)
    assert out[3]["deadline_preempts"] == 1 and out[2] == [1, 0]
    assert states == [RequestStatus.QUEUED.value, RequestStatus.ACTIVE.value]


def test_requeue_preserves_first_token_mark_like_reference(models):
    def scenario(eng_cls, req_cls, _, model, cfg, params):
        clock = FakeClock()
        eng = eng_cls(model, cfg, params, n_slots=1, max_len=48,
                      max_prompt_len=32, paged=True, block_size=8,
                      clock=clock)
        rs = np.random.RandomState(8)
        req = req_cls(rid=0, prompt=rs.randint(0, cfg.vocab_size,
                                               size=6).tolist(),
                      max_new_tokens=8)
        eng.submit(req)
        clock.t = 1.0
        eng.tick()
        eng.preempt(0)
        clock.t = 5.0
        _drain(eng)
        return _outcome([req], eng), (req.t_submit, req.t_first_token,
                                      req.t_finish)

    out, marks = _both(models, scenario)
    assert marks == (0.0, 1.0, 5.0) and out[1] == ["length"]


# ---------------------------------------------------------------------------
# Graceful-degradation ladder.
# ---------------------------------------------------------------------------

def test_ladder_steps_down_and_up_like_reference(models):
    """Simulated slow ticks push the watchdog past its threshold: the
    ladder (``full``, ``shed``) steps down, then back up after sustained
    calm; the greedy streams never change."""
    def scenario(eng_cls, req_cls, fault_cls, model, cfg, params):
        def build(fault=None):
            return eng_cls(model, cfg, params, n_slots=2, max_len=64,
                           max_prompt_len=16, fault=fault,
                           clock=FakeClock(), degrade_down_after=2,
                           degrade_up_after=3)

        base = _mk_requests(req_cls, cfg.vocab_size, max_new=12)
        build().run(base, max_ticks=600)
        reqs = _mk_requests(req_cls, cfg.vocab_size, max_new=12)
        fault = fault_cls(slow_ticks=(4, 5, 6, 7), slow_extra_s=300.0)
        eng = build(fault)
        eng.run(reqs, max_ticks=600)
        levels = [eng.degrade_level]
        for _ in range(50):             # idle ticks are calm: step back up
            if eng.degrade_level == "full":
                break
            eng.tick()
        levels.append(eng.degrade_level)
        assert [r.generated for r in reqs] == [r.generated for r in base]
        return _outcome(reqs, eng), levels, fault.injected["slow"]

    out, levels, slow = _both(models, scenario)
    assert out[3]["degrade_down"] >= 1 and out[3]["degrade_up"] >= 1
    assert levels[-1] == "full" and slow >= 2


def test_shed_level_bounds_queue_like_reference(models):
    def scenario(eng_cls, req_cls, _, model, cfg, params):
        eng = eng_cls(model, cfg, params, n_slots=1, max_len=48,
                      max_prompt_len=16, queue_bound=2,
                      degrade_down_after=1, degrade_up_after=1000,
                      clock=FakeClock())
        rs = np.random.RandomState(6)

        def mk(rid, priority=0):
            return req_cls(rid=rid, prompt=rs.randint(
                0, cfg.vocab_size, size=5).tolist(), max_new_tokens=4,
                priority=priority)

        first = [mk(i) for i in range(5)]
        for r in first:
            eng.submit(r)               # 1 admits, 4 queued > bound of 2
        eng.tick()
        level = eng.degrade_level
        walkup, vip = mk(100), mk(101, priority=5)
        eng.submit(walkup)              # lowest priority newcomer: shed
        eng.submit(vip)                 # displaces a queued peer instead
        status = [walkup.finish_reason, vip.status.value]
        _drain(eng)
        return _outcome(first + [walkup, vip], eng), level, status

    out, level, status = _both(models, scenario)
    assert level == "shed" and status == ["rejected", "queued"]
    assert out[3]["rejected"] == 2
    assert out[1].count("rejected") == 2


def test_spec_ladder_walks_every_rung_like_reference(models):
    """Speculative (``spec_k=4``): three pairs of simulated slow ticks,
    each after the watchdog's re-warm-up, walk the ladder ``full`` ->
    ``spec_half`` -> ``spec_off`` -> ``shed`` (k shrinks to 2, then
    speculation stops), and sustained calm walks it back to ``full``;
    the greedy streams never change and equal the non-speculative
    run's.  Paged: the reference's dense decode adds into K/V rows a
    rejected draft left, so its dense streams change at ``spec_off``
    (tests/test_torch_spec.py, ROADMAP.md §3)."""
    def scenario(eng_cls, req_cls, fault_cls, model, cfg, params):
        base = _mk_requests(req_cls, cfg.vocab_size, max_new=24)
        eng_cls(model, cfg, params, n_slots=2, max_len=64,
                max_prompt_len=16).run(base, max_ticks=600)
        reqs = _mk_requests(req_cls, cfg.vocab_size, max_new=24)
        fault = fault_cls(slow_ticks=(4, 5, 9, 10, 14, 15),
                          slow_extra_s=300.0)
        eng = eng_cls(model, cfg, params, n_slots=2, max_len=64,
                      max_prompt_len=16, fault=fault, clock=FakeClock(),
                      degrade_down_after=2, degrade_up_after=6, spec_k=4,
                      paged=True, block_size=8)
        for r in reqs:
            eng.submit(r)
        seen = []
        while eng.has_work:
            eng.tick()
            seen.append((eng.degrade_level, eng.spec_k_eff))
            assert len(seen) < 600
        for _ in range(50):             # idle ticks are calm: step back up
            if eng.degrade_level == "full":
                break
            eng.tick()
            seen.append((eng.degrade_level, eng.spec_k_eff))
        assert [r.generated for r in reqs] == [r.generated for r in base]
        walk = [lv for i, (lv, _) in enumerate(seen)
                if i == 0 or seen[i - 1][0] != lv]
        return (_outcome(reqs, eng, keys=("tokens_out", "decode_ticks",
                                          "drafted", "accepted",
                                          "degrade_down", "degrade_up")),
                walk, sorted(set(seen)))

    out, walk, seen = _both(models, scenario)
    assert walk[:4] == ["full", "spec_half", "spec_off", "shed"], walk
    assert walk[-1] == "full"
    assert {("spec_half", 2), ("spec_off", 0), ("shed", 0),
            ("full", 4)} <= set(seen)
