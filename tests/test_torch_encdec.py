"""Port parity, the encoder-decoder family (``seamless_m4t_large_v2``: a
bidirectional encoder over stub audio frames, a causal decoder with
cross-attention over the encoder states) at SMOKE width (fp32, ACDC
projections on the ``pallas`` method) on weights bridged from the live
JAX reference's ``init`` and numpy-seeded frames:

* the configurations field by field, the registry's ten archs, the
  bridge's trees;
* cross-attention, ``encode``, ``apply``, ``loss_fn`` and its grads, and
  three ``make_train_step`` AdamW steps on the audio pipeline's batches;
* ``prefill`` then dense decode and verify steps, and the paged
  admission then paged decode and verify steps;
* the reference's frame fault, not copied: with ``n_frontend_tokens``
  unset a slot's cross cache holds 128 frames, a request brings 16, and
  the reference's decode attends over the 112 zero frames too.

Greedy engine streams and the launchers: ``tests/test_torch_encdec_serve.py``.
The reference runs its Pallas kernels in interpret mode, as its own tests
do; the port's kernel wrappers run their plain versions on the CPU.
Tolerances fp32 atol 2e-4, rtol 1e-3 (tests/test_kernel_grads.py:248).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import steps as jsteps
from repro.launch.train import SELL_GROUPS as J_SELL_GROUPS
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import get_model as jget
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.optim.optimizers import tree_paths
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.dist import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import get_model as tget
from repro_torch.models.transformer import layer_params
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
ARCH = "seamless_m4t_large_v2"


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _pair(**over):
    jcfg = dataclasses.replace(jreg.with_sell(
        jreg.get_smoke_config(ARCH), "acdc", method="pallas"), **over)
    tcfg = dataclasses.replace(treg.with_sell(
        treg.get_smoke_config(ARCH), "acdc", method="pallas"), **over)
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jm, tm, jp, bridge.to_torch(_flat(jp), device="cpu")


@pytest.fixture(scope="module")
def seamless():
    return _pair()


@pytest.fixture(scope="module")
def jitted(seamless):
    """The reference's model functions, jitted once for the module (cfg
    static)."""
    jm = seamless[2]
    return {
        "apply": jax.jit(jm.apply, static_argnums=(2,)),
        "prefill": jax.jit(jm.prefill, static_argnums=(3,)),
        "decode_step": jax.jit(jm.decode_step, static_argnums=(4,)),
        "verify_step": jax.jit(jm.verify_step, static_argnums=(4,)),
        "decode_step_paged": jax.jit(jm.decode_step_paged,
                                     static_argnums=(5,)),
        "verify_step_paged": jax.jit(jm.verify_step_paged,
                                     static_argnums=(5,)),
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **{**F32, **kw})


def _inputs(cfg, b=2, s=10, frames=16, seed=0):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    fe = rs.randn(b, frames, cfg.d_model).astype(np.float32)
    return toks, fe


def test_registry_holds_the_ten_archs():
    assert len(treg.ARCHS) == 10 and set(treg.ARCHS) == set(jreg.ARCHS)
    for name in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jreg, name)(ARCH))
        got = dataclasses.asdict(getattr(treg, name)(ARCH))
        assert got == want, name
    cfg = treg.get_config(ARCH)
    # the assignment table of tests/test_archs_smoke.py:113-115
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size) == \
        (24, 24, 1024, 16, 16, 8192, 256206)
    assert tget(cfg).module is tencdec


def test_bridge_round_trip(seamless):
    jcfg, tcfg, jm, tm, jp, tp = seamless
    flat = _flat(jp)
    back = bridge.to_numpy(tp)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        assert np.array_equal(back[path], arr), path
    own = bridge.to_numpy(tm.init(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in flat.items()}
    for leaf in ("encoder/attn/wo/sell/a", "decoder/cross/wo/sell/a",
                 "decoder/cross/wk/w", "decoder/norm_x/scale",
                 "enc_norm/scale", "final_norm/scale"):
        assert leaf in flat, leaf
    assert flat["encoder/attn/wo/sell/a"].shape[:2] == (2, tcfg.sell_k)


def test_cross_attention_matches_reference(seamless):
    """``attention(kv=(src,))``: no RoPE, every query sees every key."""
    jcfg, tcfg, jm, tm, jp, tp = seamless
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, tcfg.d_model).astype(np.float32)
    src = rs.randn(2, 9, tcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    jl = jax.tree.map(lambda a: a[0], jp["decoder"]["cross"])
    tl = layer_params(tp["decoder"], 0)["cross"]
    want = jattn.attention(jl, jnp.asarray(x), jnp.asarray(pos),
                           jnp.zeros((), jnp.int32), jcfg,
                           kv=(jnp.asarray(src),))
    with torch.no_grad():
        got = tattn.attention(tl, _t(x), _t(pos), 0, tcfg, kv=(_t(src),))
        # the last key reaches the first query: no causal mask
        moved = src.copy()
        moved[:, -1] += 1.0
        other = tattn.attention(tl, _t(x), _t(pos), 0, tcfg,
                                kv=(_t(moved),))
    _close(got, want)
    assert float((other[:, 0] - got[:, 0]).abs().max()) > 1e-4


def test_encode_is_bidirectional_like_reference(seamless):
    jcfg, tcfg, jm, tm, jp, tp = seamless
    _, fe = _inputs(tcfg, seed=1)
    want = jax.jit(jencdec.encode, static_argnums=(2,))(
        jp, jnp.asarray(fe), jcfg)
    with torch.no_grad():
        got = tencdec.encode(tp, _t(fe), tcfg)
        moved = fe.copy()
        moved[:, -1] += 1.0
        other = tencdec.encode(tp, _t(moved), tcfg)
    _close(got, want)
    # the last frame reaches the first state: the encoder is not causal
    assert float((other[:, 0] - got[:, 0]).abs().max()) > 1e-4


def test_apply_matches_reference(seamless, jitted):
    jcfg, tcfg, jm, tm, jp, tp = seamless
    toks, fe = _inputs(tcfg, seed=2)
    want = jitted["apply"](jp, jnp.asarray(toks), jcfg, jnp.asarray(fe))
    with torch.no_grad():
        got = tm.apply(tp, _t(toks), tcfg, _t(fe))
    _close(got, want)
    with pytest.raises(ValueError, match="frontend_embeds"):
        tm.apply(tp, _t(toks), tcfg)


def test_loss_and_grads_match_reference(seamless):
    jcfg, tcfg, jm, tm, jp, tp = seamless
    toks, fe = _inputs(tcfg, seed=3)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    batch = {"tokens": toks, "labels": labels, "frontend_embeds": fe}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn),
                            static_argnums=(2,))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tloss, tgrads = tsteps.loss_and_grads(
        tm, tcfg, tp, {k: _t(v) for k, v in batch.items()})
    _close(tloss, jloss)
    want = _flat(jgrads)
    got = bridge.to_numpy(tgrads)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **F32)
    # the grads reach the encoder through the cross-attention
    assert np.abs(got["encoder/attn/wo/sell/a"]).max() > 0


def test_train_steps_match_reference():
    """Three AdamW steps on the audio pipeline's batches (16 frames a
    row), every metric a step and every parameter and moment after."""
    jcfg, tcfg = (jreg.with_sell(jreg.get_smoke_config(ARCH), "acdc",
                                 method="pallas"),
                  treg.with_sell(treg.get_smoke_config(ARCH), "acdc",
                                 method="pallas"))
    jm, tm = jget(jcfg), tget(tcfg)
    ocfg = dict(kind="adamw", lr=3e-3, groups=J_SELL_GROUPS)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg),
                             jsched.cosine_schedule(3e-3, 1, 6))
    to = topt.make_optimizer(topt.OptimizerConfig(**ocfg),
                             tsched.cosine_schedule(3e-3, 1, 6))
    jstate = jsteps.init_state(jm, jcfg, jo, jax.random.PRNGKey(0))
    tstate = bridge.state_to_torch(_flat(jstate), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jm, jcfg, jo, 1))
    tstep = tsteps.make_train_step(tm, tcfg, to, 1)
    data = JSyntheticLM(JDataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4,
        frontend="audio", n_frontend_tokens=jcfg.n_frontend_tokens,
        d_model=jcfg.d_model))
    for step in range(3):
        batch = {n: np.array(v) for n, v in data.batch_at(step).items()}
        assert batch["frontend_embeds"].shape == (4, 16, jcfg.d_model)
        jstate, jmet = jstep(jstate, {n: jnp.asarray(v)
                                      for n, v in batch.items()})
        tstate, tmet = tstep(tstate, {n: _t(v) for n, v in batch.items()})
        for name in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                       err_msg=f"{name} step {step}", **F32)
    want = _flat(jstate)
    got = bridge.state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **F32)


def test_prefill_decode_and_verify_match_reference(seamless, jitted):
    """Ragged prefill with frames, then 3 decode steps and a verify of 3
    tokens at each row's frontier, logits and caches."""
    jcfg, tcfg, jm, tm, jp, tp = seamless
    toks, fe = _inputs(tcfg, b=2, s=10, seed=4)
    b, smax = 2, 24
    lens = np.array([10, 6], np.int32)
    jl, jc = jitted["prefill"](jp, jm.init_cache(jcfg, b, smax),
                               jnp.asarray(toks), jcfg, jnp.asarray(lens),
                               jnp.asarray(fe))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, tm.init_cache(tcfg, b, smax, device="cpu"),
                            _t(toks), tcfg, _t(lens), _t(fe))
    for r in range(b):
        _close(tl[r, :lens[r]], np.asarray(jl)[r, :lens[r]])
    for key in ("k", "v", "xk", "xv"):
        _close(tc[key], jc[key])
    assert tc["xlen"].tolist() == [16, 16]
    pos = lens.copy()
    tok = np.array(jnp.argmax(jl[np.arange(b), lens - 1], -1), np.int32)
    with torch.no_grad():
        for _ in range(3):
            jlog, jc = jitted["decode_step"](jp, jc, jnp.asarray(tok),
                                             jnp.asarray(pos), jcfg)
            tlog, tc = tm.decode_step(tp, tc, _t(tok), _t(pos), tcfg)
            _close(tlog, jlog)
            tok = np.array(jnp.argmax(jlog, -1), np.int32)
            pos = pos + 1
        vt = np.random.RandomState(5).randint(
            0, tcfg.vocab_size, size=(b, 3)).astype(np.int32)
        jlog, jc, _ = jitted["verify_step"](jp, jc, jnp.asarray(vt),
                                            jnp.asarray(pos), jcfg)
        tlog, tc, states = tm.verify_step(tp, tc, _t(vt), _t(pos), tcfg)
    assert states is None
    _close(tlog, jlog)
    for key in ("k", "v"):
        _close(tc[key], jc[key])


def test_paged_prefill_decode_and_verify_match_reference(seamless,
                                                         jitted):
    """The paged admission writes each slot's prompt pages and its cross
    K/V row, then 3 paged decode steps and a paged verify of 3 tokens
    (the port's paged-attention plain version, the reference's gather
    route) give the same logits, pools and cross cache."""
    jcfg, tcfg, jm, tm, jp, tp = seamless
    rs = np.random.RandomState(6)
    b, p, bs, mb = 2, 12, 4, 6
    nb = b * mb
    tables = np.arange(nb, dtype=np.int32).reshape(b, mb)
    tables[0, 4:] = -1                          # unmapped tail
    jcache = jm.init_cache_paged(jcfg, b, nb, bs)
    tcache = tm.init_cache_paged(tcfg, b, nb, bs, device="cpu")
    jtpl = jm.init_cache(jcfg, 1, mb * bs)
    ttpl = tm.init_cache(tcfg, 1, mb * bs, device="cpu")
    jpre = jsteps.make_prefill_step(jm, jcfg, paged=True)
    tpre = tsteps.make_prefill_step(tm, tcfg, paged=True)
    lens = [9, 5]
    tok = np.zeros((b,), np.int32)
    for r in range(b):
        toks = np.zeros((1, p), np.int32)
        toks[0, :lens[r]] = rs.randint(0, jcfg.vocab_size, size=lens[r])
        fe = rs.randn(1, 16, jcfg.d_model).astype(np.float32)
        phys = np.where(tables[r] >= 0, tables[r], nb).astype(np.int32)
        jlast, jcache = jpre(jp, jcache, jtpl, jnp.asarray(toks),
                             jnp.asarray([lens[r]], jnp.int32),
                             jnp.asarray(phys), jnp.int32(r),
                             jnp.asarray(fe))
        with torch.no_grad():
            tlast, tcache = tpre(tp, tcache, ttpl, _t(toks),
                                 torch.tensor([lens[r]], dtype=torch.int32),
                                 _t(phys), r, _t(fe))
        _close(tlast, jlast)
        tok[r] = int(np.argmax(np.asarray(jlast)[0]))
    for key in ("xk", "xv"):
        _close(tcache[key], jcache[key])
    pos = np.asarray(lens, np.int32)
    with torch.no_grad():
        for _ in range(3):
            jlog, jcache = jitted["decode_step_paged"](
                jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                jnp.asarray(tables), jcfg)
            tlog, tcache = tm.decode_step_paged(tp, tcache, _t(tok), _t(pos),
                                                _t(tables), tcfg)
            _close(tlog, jlog)
            tok = np.array(jnp.argmax(jlog, -1), np.int32)
            pos = pos + 1
        vt = rs.randint(0, tcfg.vocab_size, size=(b, 3)).astype(np.int32)
        jlog, jcache, _ = jitted["verify_step_paged"](
            jp, jcache, jnp.asarray(vt), jnp.asarray(pos),
            jnp.asarray(tables), jcfg)
        tlog, tcache, _ = tm.verify_step_paged(tp, tcache, _t(vt), _t(pos),
                                               _t(tables), tcfg)
    _close(tlog, jlog)
    for key in ("k_pages", "v_pages"):
        _close(tcache[key][:, :-1], np.asarray(jcache[key])[:, :-1])


def test_frames_short_of_the_cache_decode_like_apply():
    """The reference's fault, not copied.  With ``n_frontend_tokens``
    unset a slot's cross cache holds 128 frames; a request brings 16.
    Prefill into a batch-1 slot, insert into slot 1 of a 2-slot cache,
    then decode 4 tokens: the reference's decode attends over the 112
    zero frames past the request's and departs from its own ``apply``
    (by ~1.7 in max |logit|); the port's masks them and equals its
    ``apply``, and the reference's ``apply``."""
    jcfg, tcfg, jm, tm, jp, tp = _pair(n_frontend_tokens=None)
    assert jm.init_cache(jcfg, 1, 8)["xk"].shape[2] == 128
    rs = np.random.RandomState(8)
    plen, n_dec, smax, slot = 7, 4, 16, 1
    prompt = rs.randint(0, tcfg.vocab_size, size=(1, plen)).astype(np.int32)
    fe = rs.randn(1, 16, tcfg.d_model).astype(np.float32)
    lens = np.array([plen], np.int32)

    jpre = jax.jit(jsteps.make_prefill_step(jm, jcfg))
    jl, jslot = jpre(jp, jm.init_cache(jcfg, 1, smax), jnp.asarray(prompt),
                     jnp.asarray(lens), jnp.asarray(fe))
    jc = jsteps.make_insert_step()(jm.init_cache(jcfg, 2, smax), jslot,
                                   jnp.int32(slot))
    with torch.no_grad():
        tl, tslot = tsteps.make_prefill_step(tm, tcfg)(
            tp, tm.init_cache(tcfg, 1, smax, device="cpu"), _t(prompt),
            _t(lens), _t(fe))
        tc = tsteps.make_insert_step()(
            tm.init_cache(tcfg, 2, smax, device="cpu"), tslot, slot)
    assert tc["xlen"].tolist() == [128, 16]
    _close(tl, jl)        # the prefill attends over the 16 frames alone

    jdec = jax.jit(jm.decode_step, static_argnums=(4,))
    seq = list(prompt[0])
    tok = int(np.argmax(np.asarray(jl)[0]))
    jlogs, tlogs = [], []
    for i in range(n_dec):
        toks = np.array([0, tok], np.int32)
        pos = np.array([smax, plen + i], np.int32)   # slot 0 parked
        jlog, jc = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(pos), jcfg)
        with torch.no_grad():
            tlog, tc = tm.decode_step(tp, tc, _t(toks), _t(pos), tcfg)
        jlogs.append(np.asarray(jlog)[slot])
        tlogs.append(tlog[slot].numpy())
        seq.append(tok)
        tok = int(np.argmax(tlogs[-1]))
    ctx = np.asarray(seq, np.int32)[None]
    japply = np.asarray(jax.jit(jm.apply, static_argnums=(2,))(
        jp, jnp.asarray(ctx), jcfg, jnp.asarray(fe)))[0]
    with torch.no_grad():
        tapply = tm.apply(tp, _t(ctx), tcfg, _t(fe))[0].numpy()
    np.testing.assert_allclose(tapply, japply, **F32)
    np.testing.assert_allclose(tl[0].numpy(), tapply[plen - 1], **F32)
    np.testing.assert_allclose(np.stack(tlogs), tapply[plen:], **F32)
    # recorded: the reference's decode departs from its own apply
    assert np.abs(np.stack(jlogs) - japply[plen:]).max() > 0.5
