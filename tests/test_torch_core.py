"""Port parity, core: transform matrices, families, the ACDC layer and SELL
configs of ``repro_torch`` against the live JAX reference ``repro``.

Inputs are made with numpy from a seed and handed to both packages.  The
family matrices must match BIT FOR BIT (both round the same float64 numpy
matrix to fp32).  Layer outputs compare at the fp32 tolerance of the
reference's own kernel tests (atol 2e-4, rtol 1e-3,
tests/test_kernel_grads.py:248).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acdc as jacdc
from repro.core import families as jfam
from repro.core import sell as jsell
from repro.core import transforms as jtr
from repro.models import common as jcommon
from repro_torch.core import acdc as tacdc
from repro_torch.core import families as tfam
from repro_torch.core import sell as tsell
from repro_torch.core import transforms as ttr
from repro_torch.models import common as tcommon

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("n", [128, 256, 384])
@pytest.mark.parametrize("family", ["acdc", "circulant", "hadamard"])
def test_family_matrices_bit_identical(family, n):
    jf, tf = jfam.get_family(family), tfam.get_family(family)
    if n & (n - 1) and family == "hadamard":
        # not a power of two: both packages refuse the same size
        with pytest.raises(ValueError):
            jf.matrices(n, jnp.float32)
        with pytest.raises(ValueError):
            tf.matrices(n, torch.float32, "cpu")
        assert tf.valid_size(n) == jf.valid_size(n) == 512
        return
    jc, jct = (np.asarray(m) for m in jf.matrices(n, jnp.float32))
    tc, tct = (m.numpy() for m in tf.matrices(n, torch.float32, "cpu"))
    assert tc.dtype == np.float32
    assert np.array_equal(tc.view(np.uint32), jc.view(np.uint32))
    assert np.array_equal(tct.view(np.uint32), jct.view(np.uint32))
    assert np.array_equal(tf.riffle(n), jf.riffle(n))
    assert tf.valid_size(n) == jf.valid_size(n)


def test_registry_and_permutations():
    assert tfam.available() == jfam.available()
    with pytest.raises(ValueError):
        tfam.get_family("nope")
    for n in (7, 128, 255):
        p = ttr.make_riffle(n)
        assert np.array_equal(p, jtr.make_riffle(n))
        assert np.array_equal(ttr.invert_permutation(p),
                              jtr.invert_permutation(jtr.make_riffle(n)))


def test_identity_init_statistics():
    g = torch.Generator().manual_seed(0)
    cfg = tacdc.ACDCConfig(n=256, k=3, init_std=0.061)
    p = tacdc.init_acdc_params(g, cfg, device="cpu")
    assert p["a"].shape == p["d"].shape == p["bias"].shape == (3, 256)
    assert abs(float(p["a"].mean()) - 1.0) < 0.01
    assert abs(float(p["d"].std()) - 0.061) < 0.01
    assert float(p["bias"].abs().max()) == 0.0
    assert cfg.param_count() == jacdc.ACDCConfig(n=256, k=3).param_count()


def _diag(rs, k, n):
    return (1.0 + 0.061 * rs.randn(k, n)).astype(np.float32)


@pytest.mark.parametrize("n_in,n_out", [(100, 128), (128, 100), (96, 200)])
def test_acdc_rectangular_pad_and_truncate(n_in, n_out):
    rs = np.random.RandomState(n_in + n_out)
    scfg_j = jsell.SellConfig(kind="acdc", n_in=n_in, n_out=n_out, k=2,
                              permute=True, bias=True, method="pallas",
                              lane_multiple=128)
    scfg_t = tsell.SellConfig(kind="acdc", n_in=n_in, n_out=n_out, k=2,
                              permute=True, bias=True, method="pallas",
                              lane_multiple=128)
    n = scfg_t.n_op
    assert n == scfg_j.n_op and scfg_t.param_count() == scfg_j.param_count()
    params = {"a": _diag(rs, 2, n), "d": _diag(rs, 2, n),
              "bias": (0.1 * rs.randn(2, n)).astype(np.float32)}
    x = rs.randn(3, 5, n_in).astype(np.float32)
    want = jsell.structured_linear({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   jnp.asarray(x), scfg_j)
    got = tsell.structured_linear({k: torch.from_numpy(v)
                                   for k, v in params.items()},
                                  torch.from_numpy(x), scfg_t)
    assert got.shape == (3, 5, n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_KIND_PARAMS = {
    "dense": {"w": (16, 8), "b": (8,)},
    "low_rank": {"u": (16, 4), "v": (4, 8), "b": (8,)},
    "circulant": {"a": (16,), "c": (16,), "b": (8,)},
    "fastfood": {"d1": (16,), "d2": (16,), "d3": (16,), "b": (8,)},
    "afdf": {"a_re": (2, 16), "a_im": (2, 16), "d_re": (2, 16),
             "d_im": (2, 16)},
}


@pytest.mark.parametrize("kind", sorted(_KIND_PARAMS))
def test_dense_sell_and_unported_kinds(kind):
    """Every SELL kind but ``acdc`` (tested above) on numpy-made params:
    the reference's param count and forward."""
    rs = np.random.RandomState(0)
    params = {name: (0.5 * rs.randn(*shape)).astype(np.float32)
              for name, shape in _KIND_PARAMS[kind].items()}
    x = rs.randn(4, 16).astype(np.float32)
    kw = dict(kind=kind, n_in=16, n_out=8, rank=4, k=2,
              bias=kind != "afdf")
    cfg_j, cfg_t = jsell.SellConfig(**kw), tsell.SellConfig(**kw)
    assert cfg_t.param_count() == cfg_j.param_count() == \
        sum(v.size for v in params.values())
    want = jsell.structured_linear({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   jnp.asarray(x), cfg_j)
    got = tsell.structured_linear({k: torch.from_numpy(v)
                                   for k, v in params.items()},
                                  torch.from_numpy(x), cfg_t)
    assert got.shape == (4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method", ["fft", "matmul", "auto", "pallas"])
def test_only_pallas_method_is_ported(method):
    """Every method of ``acdc_cascade`` against the reference's."""
    rs = np.random.RandomState(1)
    params = {"a": _diag(rs, 2, 128), "d": _diag(rs, 2, 128)}
    x = rs.randn(3, 128).astype(np.float32)
    kw = dict(n=128, k=2, permute=True, bias=False, method=method)
    want = jacdc.acdc_cascade({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), jacdc.ACDCConfig(**kw))
    got = tacdc.acdc_cascade({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x), tacdc.ACDCConfig(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_and_window_mask_match_reference(fraction):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 7, 3, 16).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(3, 10)]).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction,
                              1_000_000.0)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             fraction, 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for window in (0, 3):
        wm = jcommon.causal_window_mask(jnp.asarray(pos), jnp.arange(10),
                                        jnp.int32(window))
        tm = tcommon.causal_window_mask(torch.from_numpy(pos),
                                        torch.arange(10), window)
        assert np.array_equal(tm.numpy(), np.asarray(wm))
