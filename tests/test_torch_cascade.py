"""Port parity, cascade kernel and ops routing: ``repro_torch`` against
the live JAX reference on CPU.

* the whole-cascade kernel wrapper (its plain version on CPU tensors)
  against ``acdc_cascade_pallas`` in interpret mode: relu x permute x bias
  x three families x K in {2, 3}, ragged rows;
* ``ops.acdc_cascade_op`` against the reference op at N = 128 / 256, and
  the two-call route (``MAX_FUSED_N`` monkeypatched down in both
  packages) so the per-layer path's bf16 rounding places are held too;
* the routing decisions themselves: the port's copy of the fused gate
  agrees with the reference's ``fits_vmem``.

fp32 tolerance atol 2e-4, rtol 1e-3 (tests/test_kernel_grads.py:248).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import families as jfam
from repro.kernels import acdc_cascade_fused as jcascade
from repro.kernels import acdc_fused as jfused
from repro.kernels import ops as jops
from repro_torch.core import families as tfam
from repro_torch.kernels import acdc_cascade_fused as tcascade
from repro_torch.kernels import ops as tops
from repro_torch.kernels import scaled_matmul as tsmm

F32 = dict(atol=2e-4, rtol=1e-3)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _params(rs, k, n, bias):
    a = (1 + 0.061 * rs.randn(k, n)).astype(np.float32)
    d = (1 + 0.061 * rs.randn(k, n)).astype(np.float32)
    b = (0.1 * rs.randn(k, n)).astype(np.float32) if bias else None
    return a, d, b


@pytest.mark.parametrize(
    "relu,permute,bias,family,k",
    list(itertools.product([False, True], [False, True], [False, True],
                           ["acdc", "circulant", "hadamard"], [2, 3])))
def test_cascade_kernel_matches_pallas(relu, permute, bias, family, k):
    n, m = 128, 13          # 13 rows: a ragged row block
    rs = np.random.RandomState(k * 10 + relu * 4 + permute * 2 + bias)
    x = rs.randn(m, n).astype(np.float32)
    a, d, b = _params(rs, k, n, bias)
    jf = jfam.get_family(family)
    jc, jct = jf.matrices(n, jnp.float32)
    jmid = jct[:, jf.riffle(n)] if permute else None
    want = jcascade.acdc_cascade_pallas(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(d),
        None if b is None else jnp.asarray(b), jc, jct, jmid, relu=relu,
        bm=8, interpret=True)
    tf = tfam.get_family(family)
    tc, tct = tf.matrices(n, torch.float32, "cpu")
    tmid = tct[:, torch.as_tensor(tf.riffle(n)).long()] if permute else None
    got = tcascade.acdc_cascade(_t(x), _t(a), _t(d),
                                None if b is None else _t(b), tc, tct, tmid,
                                relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("relu,bias", [(False, False), (True, True)])
def test_cascade_op_matches_reference(n, relu, bias):
    rs = np.random.RandomState(n)
    x = rs.randn(2, 5, n).astype(np.float32)
    a, d, b = _params(rs, 2, n, bias)
    want = jops.acdc_cascade_op(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(d),
        None if b is None else jnp.asarray(b), relu=relu, permute=True)
    got = tops.acdc_cascade_op(_t(x), _t(a), _t(d),
                               None if b is None else _t(b), relu=relu,
                               permute=True)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_call_route_matches_reference(monkeypatch, dtype):
    """Above MAX_FUSED_N both packages run each layer as two scaled
    matmuls, h2 rounded to x's dtype between them and the riffle applied
    on the rounded layer output; force that route at N = 256."""
    monkeypatch.setattr(jfused, "MAX_FUSED_N", 128)
    monkeypatch.setattr(jcascade, "MAX_FUSED_N", 128)   # bound at import
    monkeypatch.setattr(tops, "MAX_FUSED_N", 128)
    n = 256
    rs = np.random.RandomState(9)
    x = rs.randn(6, n).astype(np.float32)
    a, d, _ = _params(rs, 2, n, False)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jops.acdc_cascade_op(jnp.asarray(x, jdt), jnp.asarray(a),
                                jnp.asarray(d), None, relu=False,
                                permute=True)
    before = tsmm.launches, tcascade.launches
    got = tops.acdc_cascade_op(_t(x).to(tdt), _t(a), _t(d), None,
                               relu=False, permute=True)
    assert got.dtype == tdt
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tsmm.launches, tcascade.launches) == before
    # bf16: one bf16 ulp (2^-8 relative) per rounding, two roundings per
    # layer, values of order 1
    tol = dict(atol=5e-2, rtol=2 ** -6) if dtype == "bfloat16" else F32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_k1_and_bias_two_call_route(monkeypatch):
    monkeypatch.setattr(jfused, "MAX_FUSED_N", 128)
    monkeypatch.setattr(tops, "MAX_FUSED_N", 128)
    n = 256
    rs = np.random.RandomState(11)
    x = rs.randn(7, n).astype(np.float32)
    a, d, b = _params(rs, 1, n, True)
    want = jops.acdc_cascade_op(jnp.asarray(x), jnp.asarray(a),
                                jnp.asarray(d), jnp.asarray(b))
    got = tops.acdc_cascade_op(_t(x), _t(a), _t(d), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 1280, 2048])
@pytest.mark.parametrize("k", [1, 2, 4, 64])
@pytest.mark.parametrize("permute,bias", [(False, False), (True, True)])
def test_fused_gate_agrees_with_reference(n, k, permute, bias):
    assert tops.MAX_FUSED_N == jfused.MAX_FUSED_N
    assert tops.cascade_fits(n, k, permute=permute, bias=bias) == \
        jcascade.fits_vmem(n, k, permute=permute, bias=bias)


def test_paged_route_counts_cpu_decisions():
    before = dict(tops.PAGED_ATTN_DISPATCHES)
    assert tops.paged_attn_route(8, 128, 2, 1,
                                 torch.device("cpu")) == "plain"
    assert tops.PAGED_ATTN_DISPATCHES["plain"] == before["plain"] + 1
    assert tops.PAGED_ATTN_DISPATCHES["kernel"] == before["kernel"]


def test_fused_kernel_limits():
    assert tcascade.KERNEL_MAX_N == tops.MAX_FUSED_N == 1024
