"""Port parity, the decoder configurations beyond qwen3: the dense
``deepseek_67b``, ``chatglm3_6b`` (half-dim RoPE), ``gemma3_27b`` (5 local
: 1 global sliding windows, qk-norm, GeGLU) and the MoE
``deepseek_moe_16b`` and ``moonshot_v1_16b_a3b``, each with ACDC
projections on the ``pallas`` method (``with_sell(cfg, "acdc",
method="pallas")``), on weights bridged from the live JAX reference's
``init``: the configurations field by field, the full configs against the
assignment table of ``tests/test_archs_smoke.py``, and at SMOKE width
(fp32) the forward logits, prefill plus 4 decode steps, and paged
decode.  Greedy engine streams: ``tests/test_torch_archs_serve.py``;
three ``make_train_step`` steps: ``tests/test_torch_archs_train.py``.

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
from repro.dist import steps as jsteps
from repro.models import get_model as jget
from repro.optim.optimizers import tree_paths
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.dist import steps as tsteps
from repro_torch.models import get_model as tget

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
ARCHS = ("deepseek_67b", "chatglm3_6b", "gemma3_27b", "deepseek_moe_16b",
         "moonshot_v1_16b_a3b")


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _pair(arch, **over):
    jcfg = dataclasses.replace(jreg.with_sell(
        jreg.get_smoke_config(arch), "acdc", method="pallas"), **over)
    tcfg = dataclasses.replace(treg.with_sell(
        treg.get_smoke_config(arch), "acdc", method="pallas"), **over)
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(_flat(jp), device="cpu")
    return jcfg, tcfg, jm, tm, jp, tp


def test_registry_holds_the_ported_decoders():
    assert set(treg.ARCHS) == set(ARCHS) | {
        "qwen3_1_7b", "llava_next_34b", "mamba2_1_3b", "zamba2_1_2b",
        "seamless_m4t_large_v2"}
    assert len(treg.ARCHS) == 10 and set(treg.ARCHS) == set(jreg.ARCHS)
    assert treg.get_config("seamless_m4t_large_v2").family == "encdec"
    with pytest.raises(NotImplementedError, match="not ported"):
        treg.get_config("no_such_arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_by_field(arch):
    for name in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jreg, name)(arch))
        got = dataclasses.asdict(getattr(treg, name)(arch))
        assert got == want, name


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_assignment(arch):
    """The assignment table of tests/test_archs_smoke.py:100-131."""
    cfg = treg.get_config(arch)
    expected = {
        "deepseek_67b": dict(n_layers=95, d_model=8192, n_heads=64,
                             n_kv_heads=8, d_ff=22016, vocab_size=102400),
        "chatglm3_6b": dict(n_layers=28, d_model=4096, n_heads=32,
                            n_kv_heads=2, d_ff=13696, vocab_size=65024),
        "gemma3_27b": dict(n_layers=62, d_model=5376, n_heads=32,
                           n_kv_heads=16, d_ff=21504, vocab_size=262144),
        "moonshot_v1_16b_a3b": dict(n_layers=48, d_model=2048, n_heads=16,
                                    n_kv_heads=16, d_ff=1408,
                                    vocab_size=163840, n_experts=64, top_k=6),
        "deepseek_moe_16b": dict(n_layers=28, d_model=2048, n_heads=16,
                                 n_kv_heads=16, d_ff=1408,
                                 vocab_size=102400, n_experts=64, top_k=6),
    }[arch]
    for k, v in expected.items():
        assert getattr(cfg, k) == v, f"{arch}.{k}: {getattr(cfg, k)} != {v}"


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, jm, tm, jp, tp = _pair(arch)
    rs = np.random.RandomState(0)
    b, s, smax = 2, 12, 24
    toks = rs.randint(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    np.testing.assert_allclose(
        tm.apply(tp, torch.from_numpy(toks), tcfg).numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(toks), jcfg)), **F32)
    lens = np.array([12, 7], np.int32)
    jl, jc = jm.prefill(jp, jm.init_cache(jcfg, b, smax), jnp.asarray(toks),
                        jcfg, jnp.asarray(lens))
    tl, tc = tm.prefill(tp, tm.init_cache(tcfg, b, smax, device="cpu"),
                        torch.from_numpy(toks), tcfg, torch.from_numpy(lens))
    for r in range(b):   # logits at the real positions of each row
        np.testing.assert_allclose(tl[r, :lens[r]].numpy(),
                                   np.asarray(jl)[r, :lens[r]], **F32)
    pos = lens.copy()
    tok = np.array(jnp.argmax(jl[np.arange(b), lens - 1], -1), np.int32)
    for _ in range(4):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                                  jcfg)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
        assert np.array_equal(torch.argmax(tlog, -1).numpy(), tok)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_reference(arch):
    """The paged admission steps write the prompt pages, then 4 paged
    decode steps (the port's paged-attention plain version, the
    reference's gather route) give the same logits and pools."""
    jcfg, tcfg, jm, tm, jp, tp = _pair(arch)
    rs = np.random.RandomState(1)
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
        phys = np.where(tables[r] >= 0, tables[r], nb).astype(np.int32)
        jlast, jcache = jpre(jp, jcache, jtpl, jnp.asarray(toks),
                             jnp.asarray([lens[r]], jnp.int32),
                             jnp.asarray(phys), jnp.int32(r))
        tlast, tcache = tpre(tp, tcache, ttpl, torch.from_numpy(toks),
                             torch.tensor([lens[r]], dtype=torch.int32),
                             torch.from_numpy(phys))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **F32)
        tok[r] = int(np.argmax(np.asarray(jlast)[0]))
    pos = np.asarray(lens, np.int32)
    for _ in range(4):
        jlog, jcache = jm.decode_step_paged(jp, jcache, jnp.asarray(tok),
                                            jnp.asarray(pos),
                                            jnp.asarray(tables), jcfg)
        tlog, tcache = tm.decode_step_paged(tp, tcache, torch.from_numpy(tok),
                                            torch.from_numpy(pos),
                                            torch.from_numpy(tables), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
        pos = pos + 1
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tcache[key].numpy()[:, :-1],
                                   np.asarray(jcache[key])[:, :-1], **F32)


def test_gemma3_smoke_window_binds_inside_the_prompt():
    """Gemma3's smoke window (8) on its local layers changes the logits of
    a 12-token prompt from the same model with global attention, and the
    port's windowed logits are the reference's."""
    jcfg, tcfg, jm, tm, jp, tp = _pair("gemma3_27b")
    assert list(tcfg.layer_windows()) == [8, 8, 8, 8, 8, 0]
    toks = np.random.RandomState(5).randint(
        0, tcfg.vocab_size, size=(1, 12)).astype(np.int32)
    got = tm.apply(tp, torch.from_numpy(toks), tcfg).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm.apply(jp, jnp.asarray(toks), jcfg)), **F32)
    wide = tm.apply(tp, torch.from_numpy(toks),
                    dataclasses.replace(tcfg, sliding_window=0)).numpy()
    # inside the window the two agree; past it they do not
    np.testing.assert_allclose(got[0, :8], wide[0, :8], **F32)
    assert np.abs(got[0, 8:] - wide[0, 8:]).max() > 1e-2
