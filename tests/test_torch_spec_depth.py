"""Port parity, truncated-cascade self-drafting on the reference's own
truncation target (tests/test_spec_decode.py: qwen3 smoke with
un-riffled K = 4 ACDC cascades at a near-converged init scale): at draft
depths 1, 2 and 4, and at depth 2 with the top block skipped, the port's
speculative engine gives the reference's greedy streams, finish reasons,
``stats`` and acceptance rate, dense and paged (4-token pages), and the
non-speculative streams.  Acceptance is not asserted monotone in depth
(that reference test is a known failure, ROADMAP.md §3).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import get_model as jget
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.spec import TruncatedCascadeDraft as JTruncated
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.spec import TruncatedCascadeDraft as TTruncated

from _torch_clock import StepClock
from _torch_threads import one_torch_thread  # noqa: F401

N_SLOTS, MAX_LEN, MAX_PROMPT, SPEC_K = 2, 40, 16, 3


def _to_torch(jparams):
    flat = dict(zip(jax.tree.leaves(tree_paths(jparams)),
                    (np.asarray(x) for x in jax.tree.leaves(jparams))))
    return bridge.to_torch(flat, device="cpu")


def _pair(**overrides):
    """(jcfg, tcfg, jmodel, tmodel, jparams, tparams): the main path's
    smoke config with ``overrides``, one set of weights in both."""
    jcfg = dataclasses.replace(jreg.with_sell(
        jreg.get_smoke_config("qwen3_1_7b"), "acdc", method="pallas"),
        **overrides)
    tcfg = dataclasses.replace(treg.with_sell(
        treg.get_smoke_config("qwen3_1_7b"), "acdc", method="pallas"),
        **overrides)
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jm, tm, jp, _to_torch(jp)


@pytest.fixture(scope="module")
def unriffled():
    """The reference's own truncation target (tests/test_spec_decode.py):
    un-riffled K = 4 cascades at a near-converged init scale."""
    return _pair(sell_k=4, sell_permute=False, sell_init_std=0.02)


def _shapes():
    rs = np.random.RandomState(0)
    return [(int(rs.randint(3, MAX_PROMPT)), int(rs.randint(3, 9)))
            for _ in range(3 * N_SLOTS)]


def _requests(req_cls, vocab, shapes):
    rs = np.random.RandomState(1)
    return [req_cls(rid=i, prompt=rs.randint(0, vocab, size=plen).tolist(),
                    max_new_tokens=budget)
            for i, (plen, budget) in enumerate(shapes)]


STAT_KEYS = ("drafted", "accepted", "acceptance_rate", "decode_ticks",
             "tokens_out", "prefill_dispatches", "preempted",
             "stalled_slot_ticks")


def _serve(eng_cls, req_cls, model, cfg, params, shapes, paged, **kw):
    if paged:
        kw.update(paged=True, block_size=4)
    reqs = _requests(req_cls, cfg.vocab_size, shapes)
    eng = eng_cls(model, cfg, params, clock=StepClock(), n_slots=N_SLOTS, max_len=MAX_LEN,
                  max_prompt_len=MAX_PROMPT, **kw)
    eng.run(reqs, max_ticks=600)
    assert all(r.done for r in reqs)
    if paged:
        assert eng.allocator.in_use == 0
    return ([list(map(int, r.generated)) for r in reqs],
            [r.finish_reason for r in reqs],
            {k: eng.stats[k] for k in STAT_KEYS})


@pytest.fixture(scope="module")
def baseline(unriffled):
    """The port's non-speculative streams of the target (equal to the
    reference's: tests/test_torch_engine.py)."""
    jcfg, tcfg, jm, tm, jp, tp = unriffled
    return _serve(TEngine, TRequest, tm, tcfg, tp, _shapes(), False)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_truncated_cascade_depth_matches_reference(unriffled, baseline,
                                                   depth, paged):
    """The reference's truncation target at each depth: streams, stats
    and acceptance rate equal (full depth: the draft IS the target)."""
    jcfg, tcfg, jm, tm, jp, tp = unriffled
    shapes = _shapes()
    want = _serve(JEngine, JRequest, jm, jcfg, jp, shapes, paged,
                  spec_k=4, draft=JTruncated(jcfg, jp, depth=depth))
    draft = TTruncated(tcfg, tp, depth=depth)
    assert draft.cfg.sell_k == depth
    assert draft.params["layers"]["attn"]["wo"]["sell"]["a"].shape[-2] \
        == depth
    got = _serve(TEngine, TRequest, tm, tcfg, tp, shapes, paged, spec_k=4,
                 draft=draft)
    assert got == want
    assert got[:2] == baseline[:2]
    if depth == 4:
        assert got[2]["acceptance_rate"] == 1.0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_truncated_cascade_skip_layers_matches_reference(unriffled,
                                                         baseline, paged):
    jcfg, tcfg, jm, tm, jp, tp = unriffled
    shapes = _shapes()
    want = _serve(JEngine, JRequest, jm, jcfg, jp, shapes, paged,
                  spec_k=SPEC_K, draft_depth=2, draft_skip_layers=1)
    eng_draft = TTruncated(tcfg, tp, depth=2, skip_layers=1)
    assert eng_draft.cfg.n_layers == tcfg.n_layers - 1
    got = _serve(TEngine, TRequest, tm, tcfg, tp, shapes, paged,
                 spec_k=SPEC_K, draft_depth=2, draft_skip_layers=1)
    assert got == want
    assert got[:2] == baseline[:2]
