"""Port parity, serving and training the encoder-decoder
(``seamless_m4t_large_v2`` at SMOKE width, fp32, ACDC projections on the
``pallas`` method, bridged weights; each request carries 16 numpy-seeded
stub frames): greedy streams, finish reasons and ``stats`` of
``repro_torch.serving.Engine`` against ``repro.serving.Engine``,

* dense and paged (8-token pages; the reference's paged attention on its
  gather route and, as ``tests/test_paged_attention.py:209`` runs it, its
  Pallas kernel in interpret mode), mirroring
  ``tests/test_serving_paged.py:72``;
* speculative (``spec_k`` 3) with the default truncated-cascade draft and
  with a junk one-layer ``ModelDraft``, dense and paged, mirroring
  ``tests/test_spec_decode.py:32``: streams the non-speculative ones;
* the submit refusals, and the launchers on the CPU (every request, and
  every ``--static`` row, gets frames; training draws ``seq_len // 4``
  frames a row when the config sets none).

Every engine runs on its own ``StepClock``; the reference's dense run is
shared through a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import paged_attn as jpaged_attn
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

ARCH = "seamless_m4t_large_v2"
N_SLOTS, MAX_LEN, MAX_PROMPT, BLOCK, SPEC_K = 3, 40, 16, 8, 3
STAT_KEYS = ("drafted", "accepted", "acceptance_rate", "decode_ticks",
             "tokens_out", "prefill_dispatches", "preempted",
             "stalled_slot_ticks")


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def seamless():
    jcfg = jreg.with_sell(jreg.get_smoke_config(ARCH), "acdc",
                          method="pallas")
    tcfg = treg.with_sell(treg.get_smoke_config(ARCH), "acdc",
                          method="pallas")
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jm, tm, jp, bridge.to_torch(_flat(jp), device="cpu")


def _work():
    """(prompt, budget, frames) of 3 x slots requests (slot reuse)."""
    rs = np.random.RandomState(0)
    return [(rs.randint(0, 512, size=rs.randint(3, MAX_PROMPT)).tolist(),
             int(rs.randint(3, 9)),
             rs.randn(1, 16, 128).astype(np.float32))
            for _ in range(3 * N_SLOTS)]


def _serve(side, arch, paged=False, **kw):
    jcfg, tcfg, jm, tm, jp, tp = arch
    if side == "ref":
        eng_cls, req_cls, model, cfg, params, fe = (JEngine, JRequest, jm,
                                                    jcfg, jp, jnp.asarray)
    else:
        eng_cls, req_cls, model, cfg, params, fe = (TEngine, TRequest, tm,
                                                    tcfg, tp, torch.from_numpy)
    if paged:
        kw.update(paged=True, block_size=BLOCK)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n, frontend_embeds=fe(f))
            for i, (p, n, f) in enumerate(_work())]
    eng = eng_cls(model, cfg, params, clock=StepClock(), n_slots=N_SLOTS,
                  max_len=MAX_LEN, max_prompt_len=MAX_PROMPT, **kw)
    eng.run(reqs, max_ticks=600)
    assert all(r.done for r in reqs)
    if paged:
        assert eng.allocator.in_use == 0
    return ([list(map(int, r.generated)) for r in reqs],
            [r.finish_reason for r in reqs],
            {k: eng.stats[k] for k in STAT_KEYS})


@pytest.fixture(scope="module")
def ref_dense(seamless):
    return _serve("ref", seamless)


@pytest.fixture(scope="module")
def port_dense(seamless):
    return _serve("port", seamless)


def test_dense_engine_matches_reference(seamless, ref_dense, port_dense):
    assert port_dense == ref_dense
    assert sum(map(len, port_dense[0])) == port_dense[2]["tokens_out"]
    # the frames reach the streams: other frames, other tokens
    jcfg, tcfg, jm, tm, jp, tp = seamless
    reqs = [TRequest(rid=i, prompt=p, max_new_tokens=n,
                     frontend_embeds=torch.from_numpy(-f))
            for i, (p, n, f) in enumerate(_work())]
    TEngine(tm, tcfg, tp, clock=StepClock(), n_slots=N_SLOTS,
            max_len=MAX_LEN, max_prompt_len=MAX_PROMPT).run(reqs,
                                                            max_ticks=600)
    assert [list(map(int, r.generated)) for r in reqs] != port_dense[0]


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
def test_paged_engine_matches_reference(seamless, port_dense, fused,
                                        monkeypatch):
    """The reference's paged engine on its gather route and on its Pallas
    kernel (interpret mode) against the port's paged engine; both equal
    the dense streams."""
    monkeypatch.setattr(jpaged_attn, "FORCE_FUSED", fused)
    want = _serve("ref", seamless, paged=True)
    got = _serve("port", seamless, paged=True)
    assert got == want
    assert got[:2] == port_dense[:2]


def _drafts(kind, arch):
    jcfg, tcfg, jm, tm, jp, tp = arch
    if kind == "truncated":
        return None, None        # the engine's default truncated draft
    junk = dict(n_layers=1, n_encoder_layers=1)
    jd = JModelDraft(dataclasses.replace(jcfg, **junk),
                     rng=jax.random.PRNGKey(9))
    td = TModelDraft(dataclasses.replace(tcfg, **junk),
                     params=bridge.to_torch(_flat(jd.params), device="cpu"))
    return jd, td


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kind", ["truncated", "junk"])
def test_spec_engine_matches_reference(seamless, port_dense, kind, paged):
    """Speculative serving with each draft's own cross K/V from its own
    prefill: streams, stats and acceptance the reference's, streams the
    non-speculative engine's."""
    jd, td = _drafts(kind, seamless)
    want = _serve("ref", seamless, paged, spec_k=SPEC_K, draft=jd)
    got = _serve("port", seamless, paged, spec_k=SPEC_K, draft=td)
    assert got == want
    assert got[2]["drafted"] > 0
    assert got[:2] == port_dense[:2]


def test_submit_refusals(seamless):
    """A request without frames is refused as the reference refuses it;
    more frames than a slot's cross cache holds is refused too."""
    jcfg, tcfg, jm, tm, jp, tp = seamless
    kw = dict(n_slots=2, max_len=24, max_prompt_len=12)
    with pytest.raises(ValueError) as want:
        JEngine(jm, jcfg, jp, **kw).submit(JRequest(rid=3, prompt=[1, 2]))
    eng = TEngine(tm, tcfg, tp, **kw)
    with pytest.raises(ValueError) as got:
        eng.submit(TRequest(rid=3, prompt=[1, 2]))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="17 frames > the cross cache's 16"):
        eng.submit(TRequest(rid=4, prompt=[1, 2],
                            frontend_embeds=torch.zeros(1, 17, 128)))


def test_launchers_give_frames(capsys, tmp_path):
    from repro_torch.launch import serve, train

    base = ["--arch", ARCH, "--smoke", "--sell", "acdc", "--sell-method",
            "pallas", "--device", "cpu", "--requests", "3", "--prompt-len",
            "6", "--gen", "4"]
    for extra in ([], ["--paged", "--block-size", "4"],
                  ["--spec", "--spec-k", "2"]):
        eng, reqs = serve.main(base + extra)
        for r in reqs:
            assert r.finish_reason == "length"
            assert tuple(r.frontend_embeds.shape) == (1, 16, 128)
    toks, _, _ = serve.main(base + ["--static"])
    assert tuple(toks.shape) == (4, 4)
    out = capsys.readouterr().out
    assert "[cache] family=encdec" in out
    with pytest.raises(ValueError, match="no vision frontend"):
        serve.main(base + ["--frontend"])
    # train: seq_len // 4 frames a row when the config sets none
    args = train.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--seq-len", "32"])
    cfg, _, _, _, pipeline = train.build(args, n_frontend_tokens=0)
    batch = pipeline.batch_at(0)
    assert tuple(batch["frontend_embeds"].shape) == (
        args.global_batch, 8, cfg.d_model)
    assert (batch["labels"][:, :-1] == batch["tokens"][:, 1:]).all()
    train.main(["--arch", ARCH, "--smoke", "--sell", "acdc",
                "--sell-method", "pallas", "--device", "cpu", "--steps",
                "2", "--seq-len", "16", "--global-batch", "2",
                "--ckpt-dir", str(tmp_path)])
    assert "done." in capsys.readouterr().out
