"""Port parity, the vision frontend (``llava_next_34b``, a decoder whose
first ``n_frontend_tokens`` positions are a stub patch prefix): at SMOKE
width (fp32, ACDC projections on the ``pallas`` method) on bridged
weights and numpy-seeded ``frontend_embeds``:

* ``apply``, ``loss_fn`` (labels -1 over the prefix, as the reference's
  pipeline masks them) and ``prefill`` followed by decode steps, against
  the reference;
* the pipeline's batch specs against the reference's;
* engine streams and stats with requests carrying ``frontend_embeds``,
  dense and paged, against ``repro.serving.Engine`` (each engine on its
  own ``StepClock``), and the prefix reaching the streams;
* the serve launcher's ``--frontend`` flag on the CPU.

Tolerances fp32 atol 2e-4, rtol 1e-3 (tests/test_kernel_grads.py:248).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import DataConfig as JDataConfig
from repro.data import pipeline as jpipe
from repro.models import get_model as jget
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.data import DataConfig as TDataConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.models import get_model as tget
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest

from _torch_clock import StepClock
from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
ARCH = "llava_next_34b"


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def llava():
    jcfg = jreg.with_sell(jreg.get_smoke_config(ARCH), "acdc",
                          method="pallas")
    tcfg = treg.with_sell(treg.get_smoke_config(ARCH), "acdc",
                          method="pallas")
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jm, tm, jp, bridge.to_torch(_flat(jp), device="cpu")


def _inputs(cfg, b=2, s=14, seed=0):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    fe = rs.randn(b, cfg.n_frontend_tokens, cfg.d_model).astype(np.float32)
    return toks, fe


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


def test_apply_with_prefix_matches_reference(llava):
    jcfg, tcfg, jm, tm, jp, tp = llava
    toks, fe = _inputs(tcfg)
    want = jm.apply(jp, jnp.asarray(toks), jcfg, jnp.asarray(fe))
    with torch.no_grad():
        got = tm.apply(tp, torch.from_numpy(toks), tcfg,
                       torch.from_numpy(fe))
        bare = tm.apply(tp, torch.from_numpy(toks), tcfg)
    _close(got, want)
    p = tcfg.n_frontend_tokens
    assert float((got[:, :p] - bare[:, :p]).abs().max()) > 1e-2
    assert float((got[:, p:] - bare[:, p:]).abs().max()) > 1e-2


def test_loss_with_prefix_labels_matches_reference(llava):
    jcfg, tcfg, jm, tm, jp, tp = llava
    toks, fe = _inputs(tcfg, seed=1)
    p = tcfg.n_frontend_tokens
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    labels[:, :p] = -1
    want = jm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                           "labels": jnp.asarray(labels),
                           "frontend_embeds": jnp.asarray(fe)}, jcfg)
    with torch.no_grad():
        got = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels),
                              "frontend_embeds": torch.from_numpy(fe)}, tcfg)
    _close(got, want)


def test_prefill_with_prefix_then_decode_matches_reference(llava):
    jcfg, tcfg, jm, tm, jp, tp = llava
    toks, fe = _inputs(tcfg, seed=2)
    b, smax = 2, 24
    lens = np.array([14, 11], np.int32)
    jl, jc = jm.prefill(jp, jm.init_cache(jcfg, b, smax), jnp.asarray(toks),
                        jcfg, jnp.asarray(lens), jnp.asarray(fe))
    tl, tc = tm.prefill(tp, tm.init_cache(tcfg, b, smax, device="cpu"),
                        torch.from_numpy(toks), tcfg, torch.from_numpy(lens),
                        torch.from_numpy(fe))
    for r in range(b):
        _close(tl[r, :lens[r]], np.asarray(jl)[r, :lens[r]])
    pos = lens.copy()
    tok = np.array(jnp.argmax(jl[np.arange(b), lens - 1], -1), np.int32)
    for _ in range(3):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                                  jcfg)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcfg)
        _close(tlog, jlog)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
        pos = pos + 1


@pytest.mark.parametrize("frontend", [None, "vision"])
def test_batch_specs_match_reference(frontend):
    kw = dict(vocab_size=64, seq_len=12, global_batch=3, frontend=frontend,
              n_frontend_tokens=4 if frontend else 0)
    want = jpipe.make_batch_specs(JDataConfig(**kw), model_d=32)
    got = tpipe.make_batch_specs(TDataConfig(**kw), model_d=32)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        shape, dtype = got[name]
        assert shape == spec.shape
        assert str(dtype).removeprefix("torch.") == str(spec.dtype)


def _serve(eng_cls, req_cls, model, cfg, params, prompts, fes, **kw):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=8,
                    frontend_embeds=None if fes is None else fes[i])
            for i, p in enumerate(prompts)]
    eng = eng_cls(model, cfg, params, clock=StepClock(), **kw)
    eng.run(reqs, max_ticks=400)
    assert all(r.done for r in reqs)
    if kw.get("paged"):
        assert eng.allocator.in_use == 0
    return ([list(map(int, r.generated)) for r in reqs],
            [r.finish_reason for r in reqs],
            {k: eng.stats[k] for k in ("decode_ticks", "tokens_out",
                                       "prefill_dispatches")})


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_frontend_requests_match_reference(llava, paged):
    """Each request's first ``n_frontend_tokens`` positions are
    placeholders whose embeddings it carries; the prefix must reach the
    streams."""
    jcfg, tcfg, jm, tm, jp, tp = llava
    p = tcfg.n_frontend_tokens
    rs = np.random.RandomState(7)
    prompts = [[0] * p + rs.randint(0, tcfg.vocab_size,
                                    size=rs.randint(4, 12)).tolist()
               for _ in range(4)]
    fes = [rs.randn(1, p, tcfg.d_model).astype(np.float32) for _ in prompts]
    kw = dict(n_slots=2, max_len=32, max_prompt_len=p + 12)
    if paged:
        kw.update(paged=True, block_size=4)
    want = _serve(JEngine, JRequest, jm, jcfg, jp, prompts,
                  [jnp.asarray(f) for f in fes], **kw)
    got = _serve(TEngine, TRequest, tm, tcfg, tp, prompts,
                 [torch.from_numpy(f) for f in fes], **kw)
    assert got == want
    bare = _serve(TEngine, TRequest, tm, tcfg, tp, prompts, None, **kw)
    assert bare[0] != got[0]


def test_serve_launcher_frontend_flag(capsys):
    from repro_torch.launch import serve

    eng, reqs = serve.main(["--arch", ARCH, "--smoke", "--sell", "acdc",
                            "--sell-method", "pallas", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "6", "--gen",
                            "4", "--frontend"])
    p = treg.get_smoke_config(ARCH).n_frontend_tokens
    assert eng.max_prompt_len == p + 6
    for r in reqs:
        assert r.prompt[:p] == [0] * p and r.finish_reason == "length"
        assert tuple(r.frontend_embeds.shape) == (1, p, 128)
    out = capsys.readouterr().out
    assert "[cache] family=decoder" in out
    with pytest.raises(ValueError, match="no vision frontend"):
        serve.main(["--arch", "qwen3_1_7b", "--smoke", "--device", "cpu",
                    "--requests", "1", "--frontend"])
