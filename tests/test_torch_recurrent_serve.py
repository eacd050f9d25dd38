"""Port parity, serving the recurrent families: greedy engine streams, finish reasons and ``stats`` of
``repro_torch.serving.Engine`` against ``repro.serving.Engine`` on bridged
weights at SMOKE width (fp32, ACDC projections on the ``pallas`` method;
the reference's kernels in interpret mode, the port's plain versions):

* Mamba2 (``ssm``: SSM/conv state in the slot cache, dense only) with
  ``spec_k`` 0 and 3, the default truncated-cascade draft and a
  ``ModelDraft`` (a fresh two-layer Mamba2): the recurrent state's
  snapshot rollback in the verify and in the draft;
* Zamba2 (``hybrid``: SSM state plus the shared block's K/V), dense and
  paged, the same three;
* a perfect draft (the target itself) on Mamba2, every draft accepted.

The vision frontend's requests: ``tests/test_torch_frontend.py``.

Each engine runs on its own ``StepClock`` so the straggler watchdog sees
the same tick durations on every machine.
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

STAT_KEYS = ("drafted", "accepted", "decode_ticks", "tokens_out",
             "prefill_dispatches", "preempted", "stalled_slot_ticks")


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _pair(arch):
    jcfg = jreg.with_sell(jreg.get_smoke_config(arch), "acdc",
                          method="pallas")
    tcfg = treg.with_sell(treg.get_smoke_config(arch), "acdc",
                          method="pallas")
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jm, tm, jp, bridge.to_torch(_flat(jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(arch)
            for arch in ("mamba2_1_3b", "zamba2_1_2b")}


def _prompts(vocab):
    rs = np.random.RandomState(7)
    return [rs.randint(0, vocab, size=rs.randint(4, 12)).tolist()
            for _ in range(5)]


def _run(eng_cls, req_cls, model, cfg, params, prompts, **kw):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    eng = eng_cls(model, cfg, params, clock=StepClock(), **kw)
    eng.run(reqs, max_ticks=400)
    assert all(r.done for r in reqs)
    if kw.get("paged"):
        assert eng.allocator.in_use == 0
    return ([list(map(int, r.generated)) for r in reqs],
            [r.finish_reason for r in reqs],
            {k: eng.stats[k] for k in STAT_KEYS})


def _drafts(kind, jcfg, tcfg, jp, tp):
    """(reference draft, port draft): None for the engine's default
    truncated-cascade draft; ``perfect`` the target itself (every draft
    accepted: the rollback commits the last snapshot); ``model`` a fresh
    two-layer model of the same family on bridged weights."""
    if kind == "truncated":
        return None, None
    if kind == "perfect":
        return JModelDraft(jcfg, params=jp), TModelDraft(tcfg, params=tp)
    jd = JModelDraft(dataclasses.replace(jcfg, n_layers=2),
                     rng=jax.random.PRNGKey(9))
    td = TModelDraft(dataclasses.replace(tcfg, n_layers=2),
                     params=bridge.to_torch(_flat(jd.params), device="cpu"))
    return jd, td


CASES = [("mamba2_1_3b", False, 0, "truncated"),
         ("mamba2_1_3b", False, 3, "truncated"),
         ("mamba2_1_3b", False, 3, "model"),
         ("mamba2_1_3b", False, 3, "perfect"),
         ("zamba2_1_2b", False, 0, "truncated"),
         ("zamba2_1_2b", False, 3, "truncated"),
         ("zamba2_1_2b", False, 3, "model"),
         ("zamba2_1_2b", True, 0, "truncated"),
         ("zamba2_1_2b", True, 3, "truncated"),
         ("zamba2_1_2b", True, 3, "model")]


@pytest.mark.parametrize(
    "arch,paged,spec_k,draft", CASES,
    ids=[f"{a.split('_')[0]}-{'paged' if p else 'dense'}-k{k}-{d}"
         for a, p, k, d in CASES])
def test_recurrent_engine_matches_reference(models, arch, paged, spec_k,
                                            draft):
    jcfg, tcfg, jm, tm, jp, tp = models[arch]
    kw = dict(n_slots=2, max_len=24, max_prompt_len=12, spec_k=spec_k)
    if paged:
        kw.update(paged=True, block_size=4)
    jd, td = (_drafts(draft, jcfg, tcfg, jp, tp) if spec_k
              else (None, None))
    prompts = _prompts(jcfg.vocab_size)
    want = _run(JEngine, JRequest, jm, jcfg, jp, prompts, draft=jd, **kw)
    got = _run(TEngine, TRequest, tm, tcfg, tp, prompts, draft=td, **kw)
    assert got == want
    assert sum(map(len, got[0])) == 40
    if spec_k:
        assert got[2]["drafted"] > 0
        if draft == "perfect":
            assert got[2]["accepted"] > got[2]["drafted"] // 2
        # greedy speculation commits the target's own tokens: the streams
        # are the non-speculative engine's
        base = _run(TEngine, TRequest, tm, tcfg, tp, prompts,
                    **dict(kw, spec_k=0))
        assert got[:2] == base[:2]
