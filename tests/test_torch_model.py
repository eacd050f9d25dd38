"""Port parity, model: the qwen3 decoder of ``repro_torch`` on weights
bridged from ``repro``'s ``model.init(PRNGKey(0), cfg)``, against the
live JAX model on CPU.

Configurations (all ``with_sell(cfg, "acdc", method="pallas")``):

* qwen3 SMOKE, fp32 — the fused-cascade route (N = 128 / 256);
* SMOKE with ``d_ff=1280`` and 2 layers, fp32 — every MLP SELL has
  N_op = 1280 > MAX_FUSED_N, so it runs the two-call scaled-matmul route
  layer by layer, as full width does;
* SMOKE in bfloat16 once.

Each: prefill logits and KV caches, then 4 greedy ``decode_step``
logits; the two fp32 variants also 4 ``decode_step_paged`` logits after
the paged admission step.  fp32 tolerance atol 2e-4, rtol 1e-3 on logits
of magnitude ~4.  bf16: the two frameworks round bf16 at the same ops
but XLA's CPU backend fuses elementwise chains and may keep fp32 inside
a fusion, so values drift by a few bf16 ulps (2^-8 relative) per layer;
the largest logit error seen is ~0.09 (6 ulps of a logit near 4), and
the check bounds it by 0.25 (16 ulps) and requires the same greedy
tokens.
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

F32 = dict(atol=2e-4, rtol=1e-3)
BF16_ATOL = 0.25

VARIANTS = {
    "smoke-fp32": {},
    "two-call-fp32": dict(d_ff=1280, n_layers=2),
    "smoke-bf16": dict(dtype="bfloat16"),
}


def _pair(**over):
    jcfg = dataclasses.replace(jreg.with_sell(
        jreg.get_smoke_config("qwen3_1_7b"), "acdc", method="pallas"),
        **over)
    tcfg = dataclasses.replace(treg.with_sell(
        treg.get_smoke_config("qwen3_1_7b"), "acdc", method="pallas"),
        **over)
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    flat = dict(zip(jax.tree.leaves(tree_paths(jp)),
                    (np.asarray(x) for x in jax.tree.leaves(jp))))
    tp = bridge.to_torch(flat, device="cpu")
    return jcfg, tcfg, jm, tm, jp, tp, flat


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, bf16):
    if bf16:
        assert np.abs(_np(got) - _np(want)).max() <= BF16_ATOL
    else:
        np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(variant):
    jcfg, tcfg, jm, tm, jp, tp, _ = _pair(**VARIANTS[variant])
    bf16 = jcfg.dtype == "bfloat16"
    rs = np.random.RandomState(0)
    b, s, smax = 2, 12, 24
    toks = rs.randint(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    jl, jc = jm.prefill(jp, jm.init_cache(jcfg, b, smax), jnp.asarray(toks),
                        jcfg, jnp.asarray(lens))
    tl, tc = tm.prefill(tp, tm.init_cache(tcfg, b, smax, device="cpu"),
                        torch.from_numpy(toks), tcfg, torch.from_numpy(lens))
    for r in range(b):   # logits at the real positions of each row
        _close(tl[r, :lens[r]], np.asarray(jl)[r, :lens[r]], bf16)
    _close(tc["k"], jc["k"], bf16)
    _close(tc["v"], jc["v"], bf16)

    pos = lens.copy()
    tok = np.array(jnp.argmax(jl[np.arange(b), lens - 1], -1), np.int32)
    for _ in range(4):
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                                  jcfg)
        tlog, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcfg)
        _close(tlog, jlog, bf16)
        tok_t = torch.argmax(tlog, -1).numpy()
        tok = np.array(jnp.argmax(jlog, -1), np.int32)
        assert np.array_equal(tok_t, tok)
        pos = pos + 1


@pytest.mark.parametrize("variant", ["smoke-fp32", "two-call-fp32"])
def test_paged_prefill_and_decode_match_reference(variant):
    """Both packages' paged admission steps write the prompt pages, then
    4 paged decode steps (the port's paged-attention kernel path, the
    reference's gather path) must give the same logits and pools."""
    jcfg, tcfg, jm, tm, jp, tp, _ = _pair(**VARIANTS[variant])
    rs = np.random.RandomState(1)
    b, p, bs, mb = 2, 12, 4, 6                 # virtual row 24
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


def test_apply_matches_reference():
    jcfg, tcfg, jm, tm, jp, tp, _ = _pair()
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                            size=(2, 9)).astype(np.int32)
    want = jm.apply(jp, jnp.asarray(toks), jcfg)
    got = tm.apply(tp, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, 9, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bridge_roundtrip_and_param_paths():
    jcfg, tcfg, jm, tm, jp, tp, flat = _pair()
    back = bridge.to_numpy(tp)
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    # the port's own init builds the same tree of shapes
    own = tm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    shapes = {k: v.shape for k, v in bridge.to_numpy(own).items()}
    assert shapes == {k: v.shape for k, v in flat.items()}
    assert "layers/attn/wo/sell/a" in flat


def _device_defaults():
    import inspect

    from repro_torch.core import acdc, families, sell, transforms
    from repro_torch.dist import steps
    from repro_torch.launch import serve, train
    from repro_torch.models import attention, common, linear, mlp
    from repro_torch.models import transformer

    fns = [bridge.to_torch, transforms.dct_matrix, transforms.idct_matrix,
           transforms.real_fft_matrix, transforms.real_ifft_matrix,
           transforms.hadamard_matrix, families.default_init_diagonals,
           families.TransformFamily.matrices, acdc.init_acdc_params,
           sell.init_sell_params, common.init_rms_norm, common.embed_init,
           linear.linear_init, mlp.init_mlp, attention.init_attention,
           attention.init_kv_cache, attention.init_kv_cache_paged,
           transformer.init_layer, transformer.init, transformer.init_cache,
           transformer.init_cache_paged, bridge.state_to_torch,
           steps.init_state]
    out = {f.__qualname__: inspect.signature(f).parameters["device"].default
           for f in fns}
    out["launch.serve --device"] = serve.parse_args([]).device
    out["launch.train --device"] = train.parse_args([]).device
    return out


@pytest.mark.parametrize("name", sorted(_device_defaults()))
def test_entry_points_default_to_cuda(name):
    # the tests pass device="cpu"; a caller who passes nothing gets the card
    assert _device_defaults()[name] == "cuda"
