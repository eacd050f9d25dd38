"""Port parity, serving: the ``repro_torch`` continuous-batching engine
against the live ``repro.serving.Engine`` on bridged weights.

The setup is the one tests/test_families.py:237 pins (qwen3 smoke,
``with_sell(cfg, "acdc", method="pallas")``, 2 slots, ``max_len`` 24,
``max_prompt_len`` 12, 5 ragged requests of 8 tokens).  Greedy streams
must be TOKEN-IDENTICAL, dense and paged (``block_size=4``), and so must
the finish reasons.  A pool tighter than dense parity checks stalls and
the deadlock breaker: with a prefill window wide enough to re-prefill, it
preempts and requeues exactly as the reference does (streams, finish
reasons and counts identical), and evicts once the requeue budget is
spent.  The allocator and request-stream copies are held against the
reference's.
"""

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import get_model as jget
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving.blocks import BlockAllocator as JAlloc
from repro.serving.request import make_ragged_requests as j_ragged
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving.blocks import BlockAllocator as TAlloc
from repro_torch.serving.request import make_ragged_requests as t_ragged


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
    return jcfg, tcfg, jm, tm, jp, bridge.to_torch(flat, device="cpu")


def _prompts(vocab):
    rs = np.random.RandomState(7)
    return [rs.randint(0, vocab, size=rs.randint(4, 12)).tolist()
            for _ in range(5)]


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_streams_identical_to_reference(models, paged):
    jcfg, tcfg, jm, tm, jp, tp = models
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(n_slots=2, max_len=24, max_prompt_len=12)
    if paged:
        kw.update(paged=True, block_size=4)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=8)
             for i, p in enumerate(prompts)]
    treqs = [TRequest(rid=i, prompt=p, max_new_tokens=8)
             for i, p in enumerate(prompts)]
    JEngine(jm, jcfg, jp, **kw).run(jreqs, max_ticks=400)
    eng = TEngine(tm, tcfg, tp, **kw)
    eng.run(treqs, max_ticks=400)
    assert [list(map(int, r.generated)) for r in treqs] == \
        [list(map(int, r.generated)) for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    assert eng.stats["prefill_dispatches"] == 5
    assert eng.stats["tokens_out"] == 40
    if paged:
        eng.allocator.audit()
        assert eng.allocator.in_use == 0


def test_tight_pool_stalls_and_ceiling(models):
    """A pool smaller than dense parity: slots stall (or, when all stall,
    the deadlock breaker evicts one as ``cache_full``) instead of
    corrupting pages.  Every request finishes, every paged stream is a
    prefix of its dense stream, and the pool drains clean."""
    _, tcfg, _, tm, _, tp = models
    prompts = _prompts(tcfg.vocab_size)
    reqs = [[TRequest(rid=i, prompt=p, max_new_tokens=16)
             for i, p in enumerate(prompts)] for _ in range(2)]
    TEngine(tm, tcfg, tp, n_slots=2, max_len=24,
            max_prompt_len=12).run(reqs[0], max_ticks=400)
    eng = TEngine(tm, tcfg, tp, n_slots=2, max_len=24, max_prompt_len=12,
                  paged=True, block_size=4, n_blocks=7)
    eng.run(reqs[1], max_ticks=400)
    assert all(r.done for r in reqs[1])
    assert eng.stats["stalled_slot_ticks"] + eng.stats["preempted"] > 0
    for dense, paged in zip(reqs[0], reqs[1]):
        assert dense.generated[:len(paged.generated)] == paged.generated
        if paged.finish_reason == "length":
            assert paged.generated == dense.generated
    eng.allocator.audit()
    assert eng.allocator.in_use == 0


@pytest.mark.parametrize("max_preemptions", [4, 0])
def test_tight_pool_requeues_like_reference(models, max_preemptions):
    """2 slots, ``max_len`` 24, a prefill window of 23 (so a stalled
    request's context still fits a re-prefill) and 8 pages of 4 tokens:
    the all-stalled breaker preempts and requeues (default budget 4) or,
    with no budget, evicts as ``preempted_limit``, as the reference."""
    jcfg, tcfg, jm, tm, jp, tp = models
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(n_slots=2, max_len=24, max_prompt_len=23, paged=True,
              block_size=4, n_blocks=8)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=16,
                      max_preemptions=max_preemptions)
             for i, p in enumerate(prompts)]
    treqs = [TRequest(rid=i, prompt=p, max_new_tokens=16,
                      max_preemptions=max_preemptions)
             for i, p in enumerate(prompts)]
    jeng = JEngine(jm, jcfg, jp, **kw)
    jeng.run(jreqs, max_ticks=400)
    eng = TEngine(tm, tcfg, tp, **kw)
    eng.run(treqs, max_ticks=400)
    assert [list(map(int, r.generated)) for r in treqs] == \
        [list(map(int, r.generated)) for r in jreqs]
    reasons = [r.finish_reason for r in treqs]
    assert reasons == [r.finish_reason for r in jreqs]
    for key in ("preempted", "requeued", "tokens_out", "finished",
                "prefill_dispatches", "decode_ticks"):
        assert eng.stats[key] == jeng.stats[key], key
    assert [r.n_preemptions for r in treqs] == \
        [r.n_preemptions for r in jreqs]
    if max_preemptions:
        assert reasons == ["cache_full", "length", "length", "cache_full",
                           "length"]
        assert [len(r.generated) for r in treqs] == [14, 16, 16, 14, 16]
        assert eng.stats["requeued"] == 3
    else:
        assert "preempted_limit" in reasons
        assert eng.stats["requeued"] == 0
    eng.allocator.audit()
    assert eng.allocator.in_use == 0


@pytest.mark.parametrize("paged", [False, True])
def test_public_preempt_requeues_like_reference(models, paged):
    """``Engine.preempt(slot)`` mid-run: the request waits out its backoff,
    is re-prefilled over prompt + generated, and its greedy stream
    continues unchanged, as the reference."""
    jcfg, tcfg, jm, tm, jp, tp = models
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(n_slots=2, max_len=24, max_prompt_len=20)
    if paged:
        kw.update(paged=True, block_size=4)
    runs = []
    for eng_cls, req_cls, model, cfg, params in (
            (JEngine, JRequest, jm, jcfg, jp),
            (TEngine, TRequest, tm, tcfg, tp)):
        eng = eng_cls(model, cfg, params, **kw)
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.tick()
        eng.preempt(0)
        with pytest.raises(ValueError):
            eng.preempt(0)          # the slot is free now
        ticks = 0
        while eng.has_work:
            eng.tick()
            ticks += 1
            assert ticks < 400
        runs.append((eng, reqs))
    (jeng, jreqs), (teng, treqs) = runs
    assert [list(map(int, r.generated)) for r in treqs] == \
        [list(map(int, r.generated)) for r in jreqs]
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    assert teng.stats["requeued"] == jeng.stats["requeued"] == 1
    assert sum(r.n_preemptions for r in treqs) == 1
    assert teng.stats["decode_ticks"] == jeng.stats["decode_ticks"]


def test_eos_stops_the_stream(models):
    """A request whose eos_id appears in its greedy stream stops right
    there with ``finish_reason="eos"``; the other requests are unchanged."""
    _, tcfg, _, tm, _, tp = models
    prompts = _prompts(tcfg.vocab_size)
    kw = dict(n_slots=2, max_len=24, max_prompt_len=12)
    free = [TRequest(rid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    TEngine(tm, tcfg, tp, **kw).run(free)
    eos = free[1].generated[3]
    cut = free[1].generated.index(eos) + 1
    reqs = [TRequest(rid=i, prompt=p, max_new_tokens=8,
                     eos_id=eos if i == 1 else None)
            for i, p in enumerate(prompts)]
    TEngine(tm, tcfg, tp, **kw).run(reqs)
    assert reqs[1].finish_reason == "eos"
    assert reqs[1].generated == free[1].generated[:cut]
    assert [r.generated for i, r in enumerate(reqs) if i != 1] == \
        [r.generated for i, r in enumerate(free) if i != 1]


def test_unported_engine_options_raise(models):
    _, tcfg, _, tm, _, tp = models
    for kw in (dict(spec_k=2), dict(fault=object()), dict(obs=object()),
               dict(queue_bound=3)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TEngine(tm, tcfg, tp, **kw)
    eng = TEngine(tm, tcfg, tp, n_slots=1, max_len=24, max_prompt_len=12)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(TRequest(rid=0, prompt=[1, 2], deadline_s=1.0))
    with pytest.raises(ValueError):
        eng.submit(TRequest(rid=1, prompt=[]))


def test_allocator_and_requests_match_reference_copies():
    ta, ja = TAlloc(6, 4, 2, 3), JAlloc(6, 4, 2, 3)
    answers = []
    for alloc in (ta, ja):
        alloc.alloc_slot(0, 5)
        got = [alloc.ensure_range(0, 8, 3)]
        alloc.alloc_slot(1, 2)
        got += [alloc.can_admit(3), alloc.ensure(1, 4), alloc.ensure(1, 8),
                alloc.trim_slot(0, 5)]
        alloc.free_slot(1)
        answers.append(got)
    assert answers[0] == answers[1]
    assert np.array_equal(ta.table, ja.table)
    assert ta.audit() == {k: v for k, v in ja.audit().items()}
    assert np.array_equal(ta.phys_row(0), ja.phys_row(0))
    tr = t_ragged(512, 6, 12, 8, seed=3, vary_budget=True)
    jr = j_ragged(512, 6, 12, 8, seed=3, vary_budget=True)
    assert [(r.prompt, r.max_new_tokens) for r in tr] == \
        [(r.prompt, r.max_new_tokens) for r in jr]
