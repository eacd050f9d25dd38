"""Port parity, speculative decoding in the engine on the main path
(qwen3 smoke, ``with_sell(cfg, "acdc", method="pallas")``, K = 2,
riffle): greedy streams, finish reasons and ``stats`` (drafted, accepted,
the acceptance rate, decode ticks, tokens out, prefills, preemptions,
stalls) of ``repro_torch.serving.Engine`` equal to the live
``repro.serving.Engine``'s on bridged weights, dense and paged (4-token
pages), for a junk ``ModelDraft`` (fewer layers, the reference's fresh
weights), a perfect draft (the target itself: full acceptance, the bonus
token) and the default ``TruncatedCascadeDraft`` (depth 1); every stream
also equals the non-speculative one and the pool drains to
``in_use == 0``.  Pallas kernels run in interpret mode.  The math, the
verify steps and validation: tests/test_torch_spec.py; the un-riffled
truncation target: tests/test_torch_spec_depth.py.
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
from repro.spec import ModelDraft as JModelDraft
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.spec import ModelDraft as TModelDraft

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
def main_path():
    return _pair()


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
def baseline(main_path):
    """The port's non-speculative streams of the target (equal to the
    reference's: tests/test_torch_engine.py)."""
    jcfg, tcfg, jm, tm, jp, tp = main_path
    return _serve(TEngine, TRequest, tm, tcfg, tp, _shapes(), False)


def _junk_cfg(cfg):
    return dataclasses.replace(cfg, n_layers=max(1, cfg.n_layers - 1))


def _drafts(kind, jcfg, tcfg, jp, tp):
    """(reference draft, port draft) over the same weights."""
    if kind == "junk":
        jd = JModelDraft(_junk_cfg(jcfg), rng=jax.random.PRNGKey(9))
        return jd, TModelDraft(_junk_cfg(tcfg), params=_to_torch(jd.params))
    if kind == "perfect":
        return JModelDraft(jcfg, params=jp), TModelDraft(tcfg, params=tp)
    return None, None            # the engine's default truncated draft


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kind", ["junk", "perfect", "truncated"])
def test_spec_engine_matches_reference(main_path, baseline, kind, paged):
    jcfg, tcfg, jm, tm, jp, tp = main_path
    shapes = _shapes()
    jd, td = _drafts(kind, jcfg, tcfg, jp, tp)
    want = _serve(JEngine, JRequest, jm, jcfg, jp, shapes, paged,
                  spec_k=SPEC_K, draft=jd)
    got = _serve(TEngine, TRequest, tm, tcfg, tp, shapes, paged,
                 spec_k=SPEC_K, draft=td)
    assert got == want
    assert got[:2] == baseline[:2]
    stats = got[2]
    assert stats["drafted"] > 0
    if kind == "perfect":
        assert stats["acceptance_rate"] == 1.0
        assert stats["decode_ticks"] < stats["tokens_out"] - len(shapes)
