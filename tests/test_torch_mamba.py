"""Port parity, the recurrent families' modules: Mamba2's SSD and block
(``mamba2_1_3b``, family ``ssm``) and the Zamba2 hybrid's shared block
(``zamba2_1_2b``, family ``hybrid``), at SMOKE width (fp32) on weights
bridged from the live JAX reference's ``init``:

* the three new configurations field by field (with ``llava_next_34b``);
* ``_segsum`` and ``ssd_chunked`` on numpy-seeded inputs, at one chunk
  (S = chunk) and at three;
* ``mamba_block`` forward;
* ``mamba_block_prefill``'s states against stepping ``mamba_block_decode``
  over the same tokens, in both packages, and against each other;
* ``mamba_block_verify``'s T + 1 snapshots;
* ``zamba2._shared_block``;
* every SELL method on mamba2's logits (``auto``, ``fft``, ``matmul``,
  ``pallas``: the reference's kernels in interpret mode, as its own tests
  run them; the port's wrappers run their plain versions on the CPU);
* prefill, decode and verify steps of both models, dense and (zamba2)
  paged, with the paged decode's parked-row freeze;
* the bridge both ways over the new trees, and the engine's refusal of a
  paged cache for the ssm family.

Tolerances fp32 atol 2e-4, rtol 1e-3 (tests/test_kernel_grads.py:248).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import get_model as jget
from repro.models import mamba2 as jmamba
from repro.models import zamba2 as jzamba
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import zamba2 as tzamba
from repro_torch.serving import Engine as TEngine

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
NEW_ARCHS = ("llava_next_34b", "mamba2_1_3b", "zamba2_1_2b")


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _pair(arch, method="pallas", **over):
    jcfg = dataclasses.replace(jreg.with_sell(
        jreg.get_smoke_config(arch), "acdc", method=method), **over)
    tcfg = dataclasses.replace(treg.with_sell(
        treg.get_smoke_config(arch), "acdc", method=method), **over)
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jm, tm, jp, bridge.to_torch(_flat(jp), device="cpu")


@pytest.fixture(scope="module")
def mamba():
    return _pair("mamba2_1_3b")


@pytest.fixture(scope="module")
def zamba():
    return _pair("zamba2_1_2b")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or F32))


def _layer(params, i):
    """Layer ``i`` of the stacked layers, either package."""
    if isinstance(params, dict):
        return {k: _layer(v, i) for k, v in params.items()}
    return params[i]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_reference_field_by_field(arch):
    for name in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jreg, name)(arch))
        got = dataclasses.asdict(getattr(treg, name)(arch))
        assert got == want, name
    assert tget(treg.get_smoke_config(arch)).module.__name__.endswith(
        {"llava_next_34b": "transformer", "mamba2_1_3b": "mamba2",
         "zamba2_1_2b": "zamba2"}[arch])


def _ssd_inputs(s, seed=0, b=2, h=3, p=4, n=5):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, p).astype(np.float32)
    a = -np.abs(rs.randn(b, s, h)).astype(np.float32) * 0.5
    bm = rs.randn(b, s, n).astype(np.float32)
    cm = rs.randn(b, s, n).astype(np.float32)
    return x, a, bm, cm


def test_segsum_matches_reference():
    a = np.random.RandomState(3).randn(2, 3, 7).astype(np.float32)
    want = np.asarray(jmamba._segsum(jnp.asarray(a)))
    got = tmamba._segsum(_t(a)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **F32)


@pytest.mark.parametrize("n_chunks", [1, 3], ids=["s=chunk", "s=3chunk"])
def test_ssd_chunked_matches_reference(n_chunks):
    chunk = 8
    x, a, bm, cm = _ssd_inputs(chunk * n_chunks, seed=n_chunks)
    want = jmamba.ssd_chunked(*map(jnp.asarray, (x, a, bm, cm)), chunk)
    got = tmamba.ssd_chunked(*map(_t, (x, a, bm, cm)), chunk)
    assert got.dtype == torch.float32
    _close(got, want)
    assert np.isfinite(got.numpy()).all()


def test_mamba_block_matches_reference(mamba):
    jcfg, tcfg, _, _, jp, tp = mamba
    x = np.random.RandomState(1).randn(2, 16, jcfg.d_model).astype(
        np.float32)
    want = jmamba.mamba_block(_layer(jp["layers"], 1)["mixer"],
                              jnp.asarray(x), jcfg)
    got = tmamba.mamba_block(_layer(tp["layers"], 1)["mixer"], _t(x), tcfg)
    _close(got, want)


def _prefill_and_steps(mod, params, x, lengths, cfg, asarr):
    """(prefill's ssm, conv) and, per row, the states after stepping
    decode over its ``length`` tokens from zero state."""
    b, s, _ = x.shape
    mask = np.arange(s)[None, :] < lengths[:, None]
    y, ssm, conv = mod.mamba_block_prefill(params, asarr(x), cfg,
                                           asarr(mask), asarr(lengths))
    _, nh, ns, cd = tmamba._dims(cfg)
    steps = []
    for r in range(b):
        st = asarr(np.zeros((1, nh, cfg.ssm_head_dim, ns), np.float32))
        cv = asarr(np.zeros((1, cfg.conv_width - 1, cd), np.float32))
        ys = []
        for t in range(int(lengths[r])):
            out, st, cv = mod.mamba_block_decode(params,
                                                 asarr(x[r:r + 1, t:t + 1]),
                                                 st, cv, cfg)
            ys.append(np.asarray(out)[0, 0])
        steps.append((np.asarray(st)[0], np.asarray(cv)[0], np.stack(ys)))
    return (np.asarray(y), np.asarray(ssm), np.asarray(conv)), steps


def test_prefill_states_equal_decode_stepping(mamba):
    """In each package the closed-form prefill states equal stepping the
    decode over the same tokens (the outputs too, at real positions), and
    the two packages agree."""
    jcfg, tcfg, _, _, jp, tp = mamba
    rs = np.random.RandomState(2)
    x = rs.randn(2, 10, jcfg.d_model).astype(np.float32)
    lengths = np.array([10, 6], np.int32)
    jblock = _layer(jp["layers"], 0)["mixer"]
    tblock = _layer(tp["layers"], 0)["mixer"]
    jpre, jsteps = _prefill_and_steps(jmamba, jblock, x, lengths, jcfg,
                                      jnp.asarray)
    with torch.no_grad():
        tpre, tsteps = _prefill_and_steps(tmamba, tblock, x, lengths, tcfg,
                                          _t)
    for pre, steps in ((jpre, jsteps), (tpre, tsteps)):
        y, ssm, conv = pre
        for r, (st, cv, ys) in enumerate(steps):
            np.testing.assert_allclose(ssm[r], st, **F32)
            np.testing.assert_allclose(conv[r], cv, **F32)
            np.testing.assert_allclose(y[r, :lengths[r]], ys, **F32)
    for got, want in zip(tpre, jpre):
        np.testing.assert_allclose(got, want, **F32)


def test_mamba_block_verify_snapshots(mamba):
    jcfg, tcfg, _, _, jp, tp = mamba
    rs = np.random.RandomState(4)
    b, t = 2, 4
    x = rs.randn(b, t, jcfg.d_model).astype(np.float32)
    _, nh, ns, cd = tmamba._dims(tcfg)
    ssm = (0.1 * rs.randn(b, nh, tcfg.ssm_head_dim, ns)).astype(np.float32)
    conv = rs.randn(b, tcfg.conv_width - 1, cd).astype(np.float32)
    jblock = _layer(jp["layers"], 2)["mixer"]
    tblock = _layer(tp["layers"], 2)["mixer"]
    jy, js, jc = jmamba.mamba_block_verify(jblock, jnp.asarray(x),
                                           jnp.asarray(ssm),
                                           jnp.asarray(conv), jcfg)
    ty, ts, tc = tmamba.mamba_block_verify(tblock, _t(x), _t(ssm), _t(conv),
                                           tcfg)
    assert ts.shape == (b, t + 1, nh, tcfg.ssm_head_dim, ns)
    assert tc.shape == (b, t + 1, tcfg.conv_width - 1, cd)
    assert torch.equal(ts[:, 0], _t(ssm)) and torch.equal(tc[:, 0], _t(conv))
    for got, want in ((ty, jy), (ts, js), (tc, jc)):
        _close(got, want)
    # every snapshot is the state after that many single-token decodes
    st, cv = _t(ssm), _t(conv)
    for j in range(t):
        _, st, cv = tmamba.mamba_block_decode(tblock, _t(x[:, j:j + 1]), st,
                                              cv, tcfg)
        _close(ts[:, j + 1], st.numpy())
        _close(tc[:, j + 1], cv.numpy())


def test_zamba_shared_block_matches_reference(zamba):
    jcfg, tcfg, _, _, jp, tp = zamba
    rs = np.random.RandomState(5)
    b, s = 2, 9
    x = rs.randn(b, s, jcfg.d_model).astype(np.float32)
    emb = rs.randn(b, s, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    want = jzamba._shared_block(jp["shared"], jnp.asarray(x),
                                jnp.asarray(emb), jnp.asarray(pos), jcfg)
    got = tzamba._shared_block(tp["shared"], _t(x), _t(emb),
                               _t(np.ascontiguousarray(pos)), tcfg)
    _close(got, want)
    assert tzamba._n_groups(tcfg) == jzamba._n_groups(jcfg) == [2, 2]
    assert tzamba._n_groups(treg.get_config("zamba2_1_2b")) == [6] * 6 + [2]


@pytest.mark.parametrize("method", ["auto", "fft", "matmul", "pallas"])
def test_mamba_logits_every_sell_method(method):
    jcfg, tcfg, jm, tm, jp, tp = _pair("mamba2_1_3b", method)
    toks = np.random.RandomState(6).randint(
        0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    want = jm.apply(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = tm.apply(tp, _t(toks), tcfg)
    _close(got, want)


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_1_2b",
                                  "zamba2_uneven"])
def test_prefill_decode_verify_match_reference(arch, mamba, zamba):
    """Both families; ``zamba2_uneven`` has 5 layers, so the shared block
    follows groups of 2, 2 and 1 (the full config's 38 are 6 x 6 + 2)."""
    jcfg, tcfg, jm, tm, jp, tp = (
        mamba if arch == "mamba2_1_3b" else zamba if arch == "zamba2_1_2b"
        else _pair("zamba2_1_2b", n_layers=5))
    if arch == "zamba2_uneven":
        assert tzamba._n_groups(tcfg) == jzamba._n_groups(jcfg) == [2, 2, 1]
    rs = np.random.RandomState(7)
    b, s, smax = 2, 12, 24
    toks = rs.randint(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    jl, jc = jm.prefill(jp, jm.init_cache(jcfg, b, smax), jnp.asarray(toks),
                        jcfg, jnp.asarray(lens))
    tl, tc = tm.prefill(tp, tm.init_cache(tcfg, b, smax, device="cpu"),
                        _t(toks), tcfg, _t(lens))
    for r in range(b):
        _close(tl[r, :lens[r]], np.asarray(jl)[r, :lens[r]])
    assert sorted(tc) == sorted(jc)
    for key in jc:
        _close(tc[key], jc[key])
    pos = lens.copy()
    tok = np.array(jnp.argmax(jl[np.arange(b), lens - 1], -1), np.int32)
    for _ in range(3):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                                  jcfg)
        tlog, tc = tm.decode_step(tp, tc, _t(tok), _t(pos), tcfg)
        _close(tlog, jlog)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
        assert np.array_equal(torch.argmax(tlog, -1).numpy(), tok)
        pos = pos + 1
    vt = rs.randint(0, jcfg.vocab_size, size=(b, 4)).astype(np.int32)
    jl, jc2, js = jm.verify_step(jp, jc, jnp.asarray(vt), jnp.asarray(pos),
                                 jcfg)
    tl, tc2, ts = tm.verify_step(tp, tc, _t(vt), _t(pos), tcfg)
    _close(tl, jl)
    assert sorted(ts) == sorted(js) == ["conv", "ssm"]
    for key in js:
        assert ts[key].shape == js[key].shape == (
            tcfg.n_layers, b, 5) + tuple(tc[key].shape[2:])
        _close(ts[key], js[key])
        _close(tc2[key], jc2[key])
        _close(ts[key][:, :, 0], np.asarray(jc[key]))   # incoming state


def test_zamba_paged_decode_freezes_parked_rows(zamba):
    """Paged: the reference's admission step and decode, with row 1
    parked on the second step (its SSM/conv state must stay put)."""
    from repro.dist import steps as jsteps
    from repro_torch.dist import steps as tsteps

    jcfg, tcfg, jm, tm, jp, tp = zamba
    rs = np.random.RandomState(8)
    b, p, bs, mb = 2, 12, 4, 6
    nb = b * mb
    tables = np.arange(nb, dtype=np.int32).reshape(b, mb)
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
        jlast, jcache = jpre(jp, jcache, jtpl, jnp.asarray(toks),
                             jnp.asarray([lens[r]], jnp.int32),
                             jnp.asarray(tables[r]), jnp.int32(r))
        tlast, tcache = tpre(tp, tcache, ttpl, _t(toks),
                             torch.tensor([lens[r]], dtype=torch.int32),
                             _t(tables[r]), r)
        _close(tlast, jlast)
        tok[r] = int(np.argmax(np.asarray(jlast)[0]))
    for key in jcache:
        _close(tcache[key], jcache[key])
    pos = np.asarray(lens, np.int32)
    for step in range(2):
        if step == 1:
            pos[1] = mb * bs                   # parked at the virtual row
        before = {k: tcache[k].clone() for k in ("ssm", "conv")}
        jlog, jcache = jm.decode_step_paged(jp, jcache, jnp.asarray(tok),
                                            jnp.asarray(pos),
                                            jnp.asarray(tables), jcfg)
        tlog, tcache = tm.decode_step_paged(tp, tcache, _t(tok), _t(pos),
                                            _t(tables), tcfg)
        _close(tlog[0], np.asarray(jlog)[0])
        for key in jcache:
            if step == 1 and key.endswith("_pages"):
                # a parked row writes its K/V nowhere in the port (the
                # trash page) and into its table's clamped last page in
                # the reference's gather route: hold the live row's pages
                live = tables[0]
                _close(tcache[key][:, live], np.asarray(jcache[key])[:, live])
            else:
                _close(tcache[key], jcache[key])
        if step == 1:
            for key in ("ssm", "conv"):
                assert torch.equal(tcache[key][:, 1], before[key][:, 1])
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
        pos = pos + 1


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_bridge_round_trip_new_trees(arch):
    jcfg, tcfg, _, tm, jp, tp = _pair(arch)
    flat = _flat(jp)
    back = bridge.to_numpy(tp)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        assert np.array_equal(back[path], arr), path
    own = bridge.to_numpy(tm.init(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in flat.items()}
    if tcfg.family != "decoder":
        for leaf in ("in_proj/sell/a", "conv_w", "conv_b", "dt_bias",
                     "a_log", "d_skip", "norm/scale", "out_proj/sell/a"):
            assert f"layers/mixer/{leaf}" in flat
    if tcfg.family == "hybrid":
        assert "shared/in_proj/sell/a" in flat and "shared/attn/wq/w" in flat


def test_engine_refuses_paged_ssm_like_reference(mamba):
    jcfg, tcfg, jm, tm, jp, tp = mamba
    with pytest.raises(ValueError) as want:
        JEngine(jm, jcfg, jp, n_slots=2, max_len=24, paged=True)
    with pytest.raises(ValueError) as got:
        TEngine(tm, tcfg, tp, n_slots=2, max_len=24, paged=True)
    assert str(got.value) == str(want.value)
    assert "no paged KV cache" in str(got.value)
