"""Port parity, SELL methods and kinds: ``repro_torch.core.acdc`` (the
``fft``/``matmul``/``auto`` methods) and ``repro_torch.core.sell`` (every
kind) against the live JAX reference.

* ``acdc()`` and ``acdc_cascade`` for ``fft``/``matmul``/``auto`` x the
  three transform families x {ReLU, riffle, bias} on/off in fp32, plus a
  bf16 cascade, forward and ``torch.autograd`` gradients against
  ``jax.vjp``; ``auto`` above ``MATMUL_MAX_N`` (the FFT side);
* every SELL kind on parameters drawn by the reference and bridged, its
  forward and gradients, ``param_count`` equal to the bridged tree's
  size, and the port's own init drawing the reference's keys and shapes;
* both dense equivalents, and ``models.linear.linear_param_count``.

Inputs are numpy-seeded.  Tolerance: fp32 atol 2e-4, rtol 1e-3
(tests/test_kernel_grads.py:248); bf16 atol 5e-2, rtol 2^-6
(tests/test_torch_cascade.py).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import acdc as jacdc
from repro.core import sell as jsell
from repro.models import linear as jlinear
from repro_torch.configs import registry as treg
from repro_torch.core import acdc as tacdc
from repro_torch.core import sell as tsell
from repro_torch.models import linear as tlinear

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-4, rtol=1e-3)
BF16 = dict(atol=5e-2, rtol=2 ** -6)
METHODS = ["fft", "matmul", "auto"]
FAMILIES = ["acdc", "circulant", "hadamard"]


def _diag(rs, *shape):
    return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)


def _params(rs, k, n, bias):
    p = {"a": _diag(rs, k, n), "d": _diag(rs, k, n)}
    if bias:
        p["bias"] = (0.1 * rs.randn(k, n)).astype(np.float32)
    return p


def _vjp_both(jfn, tfn, args, g, x_dtype="float32"):
    """(port out, port grads, ref out, ref grads) of fn(*args) with
    cotangent ``g``; args are numpy arrays, all fp32 but the first (the
    activation), which is ``x_dtype``."""
    jdt = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(args[0], jdt)] + [jnp.asarray(a) for a in args[1:]]
    jout, vjp = jax.vjp(jax.jit(jfn), *jargs)
    jgrads = vjp(jnp.asarray(g, jout.dtype))
    targs = [torch.tensor(args[0], dtype=tdt, requires_grad=True)] + [
        torch.tensor(a, requires_grad=True) for a in args[1:]]
    tout = tfn(*targs)
    assert str(tout.dtype) == f"torch.{jout.dtype}"
    (tout.float() * torch.from_numpy(g)).sum().backward()
    return (tout.float().detach().numpy(),
            [t.grad.float().numpy() for t in targs],
            np.asarray(jout, np.float32),
            [np.asarray(j, np.float32) for j in jgrads])


def _hold(got, got_grads, want, want_grads, tol, names):
    np.testing.assert_allclose(got, want, **tol)
    for name, gg, wg in zip(names, got_grads, want_grads):
        np.testing.assert_allclose(gg, wg, err_msg=name, **tol)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("method", METHODS)
def test_acdc_layer_matches_reference(method, family, bias):
    n = 16
    rs = np.random.RandomState(3)
    p = _params(rs, 1, n, bias)
    args = [rs.randn(2, 3, n).astype(np.float32), p["a"][0], p["d"][0]]
    if bias:
        args.append(p["bias"][0])
    g = rs.randn(2, 3, n).astype(np.float32)
    out = _vjp_both(
        lambda *a: jacdc.acdc(*a, method=method, family=family),
        lambda *a: tacdc.acdc(*a, method=method, family=family), args, g)
    _hold(*out, TOL, "xadb")


@pytest.mark.parametrize("relu,permute,bias",
                         list(itertools.product([False, True], repeat=3)))
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("method", METHODS)
def test_acdc_cascade_matches_reference(method, family, relu, permute,
                                        bias):
    n, k = 16, 3
    rs = np.random.RandomState(4)
    kw = dict(n=n, k=k, relu=relu, permute=permute, bias=bias,
              method=method, family=family)
    jcfg, tcfg = jacdc.ACDCConfig(**kw), tacdc.ACDCConfig(**kw)
    p = _params(rs, k, n, bias)
    keys = sorted(p)
    args = [rs.randn(4, n).astype(np.float32)] + [p[key] for key in keys]
    g = rs.randn(4, n).astype(np.float32)
    out = _vjp_both(
        lambda x, *v: jacdc.acdc_cascade(dict(zip(keys, v)), x, jcfg),
        lambda x, *v: tacdc.acdc_cascade(dict(zip(keys, v)), x, tcfg),
        args, g)
    _hold(*out, TOL, ["x"] + keys)


def test_acdc_cascade_bf16_matches_reference():
    n, k = 128, 2
    rs = np.random.RandomState(5)
    kw = dict(n=n, k=k, relu=True, permute=True, bias=True, method="fft")
    jcfg, tcfg = jacdc.ACDCConfig(**kw), tacdc.ACDCConfig(**kw)
    p = _params(rs, k, n, True)
    keys = sorted(p)
    args = [rs.randn(4, n).astype(np.float32)] + [p[key] for key in keys]
    g = rs.randn(4, n).astype(np.float32)
    out = _vjp_both(
        lambda x, *v: jacdc.acdc_cascade(dict(zip(keys, v)), x, jcfg),
        lambda x, *v: tacdc.acdc_cascade(dict(zip(keys, v)), x, tcfg),
        args, g, x_dtype="bfloat16")
    # bf16 activations, fp32 master diagonals (cast down inside the
    # layer, as in the model): forward and dx in bf16
    _hold(*out, BF16, ["x"] + keys)


@pytest.mark.parametrize("n", [128, 4096, 4097, 6144])
def test_auto_resolves_by_reference_rule(n):
    assert tacdc.MATMUL_MAX_N == jacdc.MATMUL_MAX_N
    for method in ("auto", "fft", "matmul", "pallas"):
        assert tacdc._resolve_method(n, method) == \
            jacdc._resolve_method(n, method)


def test_auto_above_crossover_is_the_fft_path():
    n = 4352
    rs = np.random.RandomState(6)
    x = rs.randn(2, n).astype(np.float32)
    a, d = _diag(rs, n), _diag(rs, n)
    want = jacdc.acdc(jnp.asarray(x), jnp.asarray(a), jnp.asarray(d))
    xt, at, dt = (torch.from_numpy(v) for v in (x, a, d))
    got = tacdc.acdc(xt, at, dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, tacdc.acdc(xt, at, dt, method="fft"))


# ---------------------------------------------------------------------------
# SELL kinds
# ---------------------------------------------------------------------------

KINDS = ["dense", "low_rank", "circulant", "fastfood", "acdc", "afdf"]


def _sell_cfgs(kind, n_in=24, n_out=40):
    kw = dict(kind=kind, n_in=n_in, n_out=n_out, k=2, rank=6,
              permute=True, bias=kind != "afdf", method="fft")
    return jsell.SellConfig(**kw), tsell.SellConfig(**kw)


@pytest.mark.parametrize("kind", KINDS)
def test_sell_kind_matches_reference(kind):
    jcfg, tcfg = _sell_cfgs(kind)
    jp = jsell.init_sell_params(jax.random.PRNGKey(1), jcfg)
    if "b" in jp:
        jp["b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(2),
                                          jp["b"].shape)
    keys = sorted(jp)
    flat = {key: np.asarray(jp[key]) for key in keys}
    assert tcfg.n_op == jcfg.n_op
    assert tcfg.param_count() == jcfg.param_count() == \
        sum(v.size for v in flat.values())
    rs = np.random.RandomState(7)
    x = rs.randn(3, 24).astype(np.float32)
    if kind == "afdf":
        # complex output: a real loss over both parts
        g2 = rs.randn(3, 40, 2).astype(np.float32)

        def jfn(x, *v):
            y = jsell.structured_linear(dict(zip(keys, v)), x, jcfg)
            return jnp.stack([y.real, y.imag], axis=-1)

        def tfn(x, *v):
            y = tsell.structured_linear(dict(zip(keys, v)), x, tcfg)
            assert y.dtype == torch.complex64
            return torch.view_as_real(y)

        out = _vjp_both(jfn, tfn, [x] + [flat[k] for k in keys], g2)
    else:
        g = rs.randn(3, 40).astype(np.float32)
        out = _vjp_both(
            lambda x, *v: jsell.structured_linear(dict(zip(keys, v)), x,
                                                  jcfg),
            lambda x, *v: tsell.structured_linear(dict(zip(keys, v)), x,
                                                  tcfg),
            [x] + [flat[k] for k in keys], g)
    _hold(*out, TOL, ["x"] + keys)


@pytest.mark.parametrize("kind", KINDS)
def test_sell_init_draws_reference_keys_and_shapes(kind):
    jcfg, tcfg = _sell_cfgs(kind)
    jp = jsell.init_sell_params(jax.random.PRNGKey(0), jcfg)
    tp = tsell.init_sell_params(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tuple(tp[key].shape) == jp[key].shape, key
        assert tp[key].dtype == torch.float32
    if kind == "circulant":
        assert abs(float(tp["c"][0]) - 1.0) < 0.5
        assert abs(float(tp["c"][1:].std()) - tcfg.init_std) < 0.03


@pytest.mark.parametrize("kind", ["dense", "low_rank", "circulant",
                                  "fastfood", "acdc", "afdf"])
def test_sell_dense_equivalent_matches_reference(kind):
    jcfg, tcfg = _sell_cfgs(kind, n_in=16, n_out=16)
    jp = jsell.init_sell_params(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    want = np.asarray(jsell.sell_dense_equivalent(jp, jcfg))
    got = tsell.sell_dense_equivalent(tp, tcfg).numpy()
    assert got.shape == want.shape == (16, 16)
    np.testing.assert_allclose(got, want, **TOL)
    x = np.random.RandomState(8).randn(5, 16).astype(np.float32)
    if kind != "afdf":
        # the matrix is the layer (less its bias, which rides every row)
        y = tsell.structured_linear(tp, torch.from_numpy(x), tcfg).numpy()
        b = tp["b"].numpy() if "b" in tp else 0.0
        np.testing.assert_allclose(x @ (got - b) + b, y, **TOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("method", METHODS)
def test_acdc_cascade_dense_equivalent_matches_reference(method, family):
    n, k = 16, 3
    rs = np.random.RandomState(9)
    kw = dict(n=n, k=k, permute=True, bias=True, method=method,
              family=family)
    p = _params(rs, k, n, True)
    want = jacdc.acdc_cascade_dense_equivalent(
        {key: jnp.asarray(v) for key, v in p.items()},
        jacdc.ACDCConfig(**kw))
    got = tacdc.acdc_cascade_dense_equivalent(
        {key: torch.from_numpy(v) for key, v in p.items()},
        tacdc.ACDCConfig(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="ReLU"):
        tacdc.acdc_cascade_dense_equivalent(
            {key: torch.from_numpy(v) for key, v in p.items()},
            tacdc.ACDCConfig(relu=True, **kw))


@pytest.mark.parametrize("kind", ["dense", "low_rank", "circulant",
                                  "fastfood", "acdc"])
def test_linear_param_count_matches_reference(kind):
    jcfg = jreg.with_sell(jreg.get_config("qwen3_1_7b"), kind)
    tcfg = treg.with_sell(treg.get_config("qwen3_1_7b"), kind)
    for role, n_in, n_out in (("attn_qkv", 2048, 2048),
                              ("attn_out", 2048, 2048),
                              ("mlp_in", 2048, 6144),
                              ("mlp_out", 6144, 2048)):
        assert tlinear.linear_param_count(tcfg, role, n_in, n_out) == \
            jlinear.linear_param_count(jcfg, role, n_in, n_out)
