"""Port parity, speculative decoding: ``repro_torch.spec``, the verify
steps and the engine's speculative tick against the live reference
(``repro.spec``, ``repro.serving.Engine``) on bridged weights.

* acceptance math: ``greedy_accept`` / ``committed_tokens`` exact on
  seeded inputs, the p == q fallback of ``rejection_accept`` exact, and
  ``rejection_accept`` held as a distribution (the committed first token
  follows the target's softmax; port of tests/test_spec_decode.py);
* ``verify_step`` / ``verify_step_paged``: logits against the
  reference's (fp32, atol 2e-4, rtol 1e-3) and against T single-token
  ``decode_step``s of the port; the caches they leave against the
  reference's, parked and ceiling rows dropping their writes;
* the engine's streams and stats against the reference's:
  tests/test_torch_spec_engine.py (junk, perfect and truncated drafts on
  the main path) and tests/test_torch_spec_depth.py (truncation depths on
  the un-riffled K = 4 target);
* a ladder step to ``spec_off`` after rejections leaves the port's
  streams equal to the non-speculative run, dense and paged.  The
  reference's dense decode adds K/V into the cache
  (``src/repro/models/attention.py:435-437``), so there its streams
  change: recorded here as the reference's known fault;
* validation: ``draft_depth=0``, a vocabulary mismatch, an over-wide
  paged ``spec_k`` and the reference's truncation errors raise.

Pallas kernels run in interpret mode, as the reference's own tests run
them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import get_model as jget
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.spec import verify as jverify
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.spec import ModelDraft as TModelDraft
from repro_torch.spec import TruncatedCascadeDraft as TTruncated
from repro_torch.spec import verify as tverify

from _torch_clock import StepClock
from _torch_threads import one_torch_thread  # noqa: F401

N_SLOTS, MAX_LEN, MAX_PROMPT, SPEC_K = 2, 40, 16, 3
ATOL, RTOL = 2e-4, 1e-3


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


@pytest.fixture(scope="module")
def unriffled():
    """The reference's own truncation target (tests/test_spec_decode.py):
    un-riffled K = 4 cascades at a near-converged init scale."""
    return _pair(sell_k=4, sell_permute=False, sell_init_std=0.02)


# ---------------------------------------------------------------------------
# Acceptance math.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_greedy_accept_and_committed_tokens_match_reference(seed):
    rs = np.random.RandomState(seed)
    b, k, v = 5, 4, 13
    logits = rs.randn(b, k + 1, v).astype(np.float32)
    greedy = logits.argmax(-1)
    drafts = np.where(rs.rand(b, k) < 0.7, greedy[:, :k],
                      rs.randint(0, v, (b, k))).astype(np.int32)
    drafts[0] = greedy[0, :k]                       # full acceptance row
    jn, jnxt = jverify.greedy_accept(jnp.asarray(logits),
                                     jnp.asarray(drafts))
    tn, tnxt = tverify.greedy_accept(torch.from_numpy(logits),
                                     torch.from_numpy(drafts))
    assert tn.tolist() == np.asarray(jn).tolist()
    assert tnxt.tolist() == np.asarray(jnxt).tolist()
    assert tn[0] == k
    jout = jverify.committed_tokens(jnp.asarray(drafts), jn, jnxt)
    tout = tverify.committed_tokens(torch.from_numpy(drafts), tn, tnxt)
    assert tout.dtype == torch.int32
    assert tout.tolist() == np.asarray(jout).tolist()


def test_greedy_accept_unit_pin():
    """The reference's pin of the prefix-match rule and the correction /
    bonus selection."""
    logits = torch.from_numpy(np.eye(4, dtype=np.float32)[
        np.array([[2, 0, 3, 1], [1, 2, 0, 3]])])
    drafts = torch.tensor([[2, 0, 0], [0, 2, 0]], dtype=torch.int32)
    n, nxt = tverify.greedy_accept(logits, drafts)
    assert n.tolist() == [2, 0]
    assert nxt.tolist() == [3, 1]
    out = tverify.committed_tokens(drafts, n, nxt)
    assert out[0, :3].tolist() == [2, 0, 3]
    assert out[1, 0].item() == 1


def test_rejection_accept_zero_mass_fallback_matches_reference():
    """p == q with the draft outside both top-1 filters: the draft has
    probability 0 under both, so it is rejected, no residual mass is
    left, and the resample falls back to p (its top-1 token)."""
    rs = np.random.RandomState(3)
    b, k, v = 4, 3, 9
    logits = rs.randn(b, k + 1, v).astype(np.float32)
    top = logits.argmax(-1)
    drafts = ((top[:, :k] + 1) % v).astype(np.int32)
    jn, jnxt = jverify.rejection_accept(
        jax.random.PRNGKey(0), jnp.asarray(logits),
        jnp.asarray(logits[:, :k]), jnp.asarray(drafts), top_k=1)
    tn, tnxt = tverify.rejection_accept(
        torch.Generator().manual_seed(0), torch.from_numpy(logits),
        torch.from_numpy(logits[:, :k]), torch.from_numpy(drafts), top_k=1)
    assert tn.tolist() == np.asarray(jn).tolist() == [0] * b
    assert tnxt.tolist() == np.asarray(jnxt).tolist() == top[:, 0].tolist()


@pytest.mark.parametrize("seed", [0, 17, 4242])
def test_rejection_sampling_preserves_target_distribution(seed):
    """Whatever the draft proposes, the FIRST committed token of a
    speculative step follows the target's softmax: the accept / resample
    math over 4000 independent rows (drafts sampled from the draft's
    distribution), in total variation, as the reference's test holds
    its own."""
    vocab, k, n_rows = 5, 2, 4000
    rs = np.random.RandomState(seed)
    t_logits = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        rs.randn(1, k + 1, vocab) * 1.5, (n_rows, k + 1, vocab)))).float()
    d_logits = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        rs.randn(1, k, vocab) * 1.5, (n_rows, k, vocab)))).float()
    gen = torch.Generator().manual_seed(seed)
    drafts = torch.multinomial(torch.softmax(d_logits, -1).reshape(-1, vocab),
                               1, generator=gen).reshape(n_rows, k)
    n, nxt = tverify.rejection_accept(gen, t_logits, d_logits,
                                      drafts.to(torch.int32))
    first = torch.where(n >= 1, drafts[:, 0].to(torch.int32), nxt)
    emp = np.bincount(first.numpy(), minlength=vocab) / n_rows
    target = torch.softmax(t_logits[0, 0], -1).numpy()
    tv = 0.5 * np.abs(emp - target).sum()
    assert tv < 0.06, f"total variation {tv:.3f} (emp={emp}, p={target})"
    # the reference's acceptance rate on the same distributions, in law
    jn, _ = jax.vmap(lambda r, lg, dlg, dr: jverify.rejection_accept(
        r, lg[None], dlg[None], dr[None]))(
        jax.random.split(jax.random.PRNGKey(seed), n_rows),
        jnp.asarray(t_logits.numpy()), jnp.asarray(d_logits.numpy()),
        jnp.asarray(drafts.numpy()))
    assert abs(float(np.asarray(jn).mean()) - float(n.float().mean())) \
        < 0.08


# ---------------------------------------------------------------------------
# verify_step / verify_step_paged.
# ---------------------------------------------------------------------------

#: rows: two live slots (one whose window passes the ceiling) and a
#: parked one; prompts right-padded to 10
PROMPT_LENS = [5, 10, 3]
SMAX, T = 24, 4


def _verify_inputs(vocab):
    rs = np.random.RandomState(11)
    prompts = rs.randint(0, vocab, (len(PROMPT_LENS), 10)).astype(np.int32)
    toks = rs.randint(0, vocab, (len(PROMPT_LENS), T)).astype(np.int32)
    # row 1 sits 2 below the ceiling (two of its T writes drop), row 2 is
    # parked at the row length (all of them drop)
    pos = np.array([PROMPT_LENS[0], SMAX - 2, SMAX], np.int32)
    return prompts, toks, pos


def _ref_verify(jm, jcfg, jp, prompts, toks, pos):
    cache = jm.init_cache(jcfg, len(PROMPT_LENS), SMAX)
    _, cache = jm.prefill(jp, cache, jnp.asarray(prompts), jcfg,
                          jnp.asarray(PROMPT_LENS, jnp.int32))
    logits, cache, states = jm.verify_step(jp, cache, jnp.asarray(toks),
                                           jnp.asarray(pos), jcfg)
    assert states is None
    return np.asarray(logits), {k: np.asarray(v) for k, v in cache.items()}


def _port_prefilled(tm, tcfg, tp, prompts):
    cache = tm.init_cache(tcfg, len(PROMPT_LENS), SMAX, "cpu")
    _, cache = tm.prefill(tp, cache, torch.from_numpy(prompts), tcfg,
                          torch.tensor(PROMPT_LENS, dtype=torch.int32))
    return cache


def test_verify_step_matches_reference_and_decode_steps(main_path):
    jcfg, tcfg, jm, tm, jp, tp = main_path
    prompts, toks, pos = _verify_inputs(jcfg.vocab_size)
    jlogits, jcache = _ref_verify(jm, jcfg, jp, prompts, toks, pos)
    cache = _port_prefilled(tm, tcfg, tp, prompts)
    before = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        logits, cache, states = tm.verify_step(
            tp, cache, torch.from_numpy(toks), torch.from_numpy(pos), tcfg)
    assert states is None and logits.shape == (3, T, tcfg.vocab_size)
    live = [0, 1]
    np.testing.assert_allclose(logits[live].numpy(), jlogits[live],
                               atol=ATOL, rtol=RTOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), jcache[key],
                                   atol=ATOL, rtol=RTOL)
        # the parked row and row 1's positions past the ceiling: no write
        assert torch.equal(cache[key][:, 2], before[key][:, 2])
        assert not torch.equal(cache[key][:, 1, SMAX - 2:],
                               before[key][:, 1, SMAX - 2:])
    # T single-token decode steps of the port from the same prefill
    cache = _port_prefilled(tm, tcfg, tp, prompts)
    steps = []
    with torch.no_grad():
        for i in range(T):
            lg, cache = tm.decode_step(tp, cache,
                                       torch.from_numpy(toks[:, i]),
                                       torch.from_numpy(pos + i), tcfg)
            steps.append(lg)
    np.testing.assert_allclose(
        logits[0].numpy(), torch.stack(steps, 1)[0].numpy(),
        atol=ATOL, rtol=RTOL)
    # row 1 within the ceiling (positions SMAX-2, SMAX-1)
    np.testing.assert_allclose(
        logits[1, :2].numpy(), torch.stack(steps, 1)[1, :2].numpy(),
        atol=ATOL, rtol=RTOL)


def _pool_from_dense(dense_k, dense_v, bs, pages_per_row):
    """A page pool holding each row's dense cache in consecutive pages
    (row r -> pages r*P .. r*P+P-1; the last page the trash)."""
    n_layers, b, smax = dense_k.shape[:3]
    n_blocks = b * pages_per_row
    tables = np.arange(n_blocks, dtype=np.int32).reshape(b, pages_per_row)
    pools = []
    for dense in (dense_k, dense_v):
        pool = np.zeros((n_layers, n_blocks + 1, bs) + dense.shape[3:],
                        dense.dtype)
        pool[:, :n_blocks] = dense.reshape(
            (n_layers, n_blocks, bs) + dense.shape[3:])
        pools.append(pool)
    return pools, tables


def test_verify_step_paged_matches_reference_and_dense(main_path):
    """Through the paged-attention kernel's plain version at T = 4 (the
    kernel itself runs at T = k + 1 on the card): logits against the
    reference's paged verify and the port's dense one; the pools against
    the reference's."""
    jcfg, tcfg, jm, tm, jp, tp = main_path
    prompts, toks, pos = _verify_inputs(jcfg.vocab_size)
    pos = pos.copy()
    pos[1] = 10                  # a live row crossing a page boundary
    dense = _port_prefilled(tm, tcfg, tp, prompts)
    (kp, vp), tables = _pool_from_dense(dense["k"].numpy(),
                                        dense["v"].numpy(), 4, SMAX // 4)
    pos[2] = SMAX                # parked: every write to the trash page
    jlogits, jcache, _ = jm.verify_step_paged(
        jp, {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)},
        jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables), jcfg)
    cache = {"k_pages": torch.from_numpy(kp.copy()),
             "v_pages": torch.from_numpy(vp.copy())}
    with torch.no_grad():
        logits, cache, states = tm.verify_step_paged(
            tp, cache, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(tables), tcfg)
        dlogits, _, _ = tm.verify_step(tp, dense, torch.from_numpy(toks),
                                       torch.from_numpy(pos), tcfg)
    assert states is None
    live = [0, 1]
    np.testing.assert_allclose(logits[live].numpy(),
                               np.asarray(jlogits)[live], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(logits[live].numpy(), dlogits[live].numpy(),
                               atol=ATOL, rtol=RTOL)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(cache[key][:, :-1].numpy(),
                                   np.asarray(jcache[key])[:, :-1],
                                   atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# The engine against the reference.
# ---------------------------------------------------------------------------

def _shapes():
    rs = np.random.RandomState(0)
    return [(int(rs.randint(3, MAX_PROMPT)), int(rs.randint(3, 9)))
            for _ in range(3 * N_SLOTS)]


def _requests(req_cls, vocab, shapes):
    rs = np.random.RandomState(1)
    return [req_cls(rid=i, prompt=rs.randint(0, vocab, size=plen).tolist(),
                    max_new_tokens=budget)
            for i, (plen, budget) in enumerate(shapes)]


# ---------------------------------------------------------------------------
# The ladder's spec_off after rejections.
# ---------------------------------------------------------------------------

def _switch_run(eng_cls, req_cls, model, cfg, params, paged, switch):
    kw = dict(paged=True, block_size=4) if paged else {}
    reqs = _requests(req_cls, cfg.vocab_size, _shapes())
    eng = eng_cls(model, cfg, params, clock=StepClock(), n_slots=N_SLOTS, max_len=MAX_LEN,
                  max_prompt_len=MAX_PROMPT, spec_k=4 if switch else 0,
                  **kw)
    for r in reqs:
        eng.submit(r)
    if switch:
        for _ in range(3):
            eng.tick()
        assert eng.stats["drafted"] > eng.stats["accepted"]  # rejections
        eng._set_level(2)
        assert eng.degrade_level == "spec_off" and eng.spec_k_eff == 0
    ticks = 0
    while eng.has_work:
        eng.tick()
        ticks += 1
        assert ticks < 600
    return [list(map(int, r.generated)) for r in reqs]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_off_after_rejections_keeps_streams(main_path, paged):
    """Tick three speculative ticks (k = 4, the default depth-1 draft
    rejects nearly everything), step the ladder to ``spec_off`` and
    drain: the port's streams equal the non-speculative run, since every
    KV write sets its row.  The reference's dense decode adds into rows a
    rejected draft left behind, so its dense streams change at the
    switch (its paged decode sets, and holds): the reference's fault,
    recorded here and in ROADMAP.md §3."""
    jcfg, tcfg, jm, tm, jp, tp = main_path
    base = _switch_run(TEngine, TRequest, tm, tcfg, tp, paged, False)
    assert _switch_run(TEngine, TRequest, tm, tcfg, tp, paged, True) == base
    jbase = _switch_run(JEngine, JRequest, jm, jcfg, jp, paged, False)
    jswitch = _switch_run(JEngine, JRequest, jm, jcfg, jp, paged, True)
    assert jbase == base
    assert (jswitch == jbase) is paged


# ---------------------------------------------------------------------------
# Validation.
# ---------------------------------------------------------------------------

def test_spec_validation_errors(main_path, unriffled):
    _, tcfg, _, tm, _, tp = unriffled
    with pytest.raises(ValueError, match="depth 0"):
        TEngine(tm, tcfg, tp, n_slots=1, max_len=32, max_prompt_len=8,
                spec_k=2, draft_depth=0)
    with pytest.raises(ValueError, match="outside"):
        TTruncated(tcfg, tp, depth=5)
    with pytest.raises(ValueError, match="cannot skip"):
        TTruncated(tcfg, tp, depth=2, skip_layers=tcfg.n_layers)
    other = dataclasses.replace(tcfg, vocab_size=tcfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        TModelDraft(other, target_cfg=tcfg, device="cpu")
    dense = treg.get_smoke_config("qwen3_1_7b")
    dmodel = tget(dense)
    dparams = dmodel.init(torch.Generator().manual_seed(0), dense, "cpu")
    with pytest.raises(ValueError, match="no stacked cascades"):
        TTruncated(dense, dparams, depth=1)
    assert TTruncated(dense, dparams, depth=1, skip_layers=1).depth is None
    # smoke qwen3 has group 2: the paged kernel's row blocks take any
    # group * T, so a paged spec_k of 8 (18 rows a KV head) is served as
    # the reference serves it
    _, mcfg, _, mm, _, mp = main_path
    for k in (7, 8):
        eng = TEngine(mm, mcfg, mp, n_slots=1, max_len=32, max_prompt_len=8,
                      paged=True, block_size=4, spec_k=k)
        assert eng._levels == ["full", "spec_half", "spec_off", "shed"]
    eng = TEngine(mm, mcfg, mp, n_slots=1, max_len=32, max_prompt_len=8,
                  spec_k=8)
    assert eng.draft.depth == 1 and eng.cache_bytes > 0
    with pytest.raises(ValueError, match="spec_k"):
        TEngine(mm, mcfg, mp, spec_k=-1)


def test_serve_launcher_spec_flags(capsys):
    """``--spec`` on the CPU at smoke width: the ``[spec]`` lines, the
    ``--batch`` alias of ``--slots``, and ``--spec --static`` refused."""
    from repro_torch.launch import serve

    eng, reqs = serve.main(["--smoke", "--sell", "acdc", "--device", "cpu",
                            "--spec", "--spec-k", "3", "--batch", "2",
                            "--requests", "3", "--prompt-len", "8",
                            "--gen", "5", "--paged", "--block-size", "4"])
    out = capsys.readouterr().out
    assert "[spec] k=3 draft=TruncatedCascadeDraft depth=1 skip_layers=0" \
        in out
    assert "drafts accepted" in out
    assert eng.n_slots == 2 and eng.stats["drafted"] > 0
    assert all(r.finish_reason == "length" for r in reqs)
    with pytest.raises(SystemExit):
        serve.parse_args(["--spec", "--static"])
    args = serve.parse_args(["--spec", "--draft-depth", "2",
                             "--spec-skip-layers", "1"])
    assert (args.spec_k, args.draft_depth, args.spec_skip_layers) == (4, 2, 1)
