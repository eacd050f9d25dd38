"""Port parity, gradients: ``loss.backward()`` through the port's ACDC ops
against ``jax.vjp`` of the live JAX reference on the CPU.

* ``ops.acdc_fused_op`` / ``ops.acdc_cascade_op`` (dx, da, dd, db) over
  relu x riffle x bias x K in {1, 2, 3} x N in {128, 256}: K=1 runs the
  layer backward (``acdc_bwd``'s plain version against
  ``acdc_bwd_pallas`` in interpret mode), K >= 2 the reverse sweep
  (``acdc_cascade_bwd`` against ``acdc_cascade_bwd_pallas``);
* the two-call route at N = 2048 (three ``scaled_matmul`` products and
  torch reductions against ``acdc_bwd_two_call``), layer and per-layer
  cascade;
* the per-layer cascade backward (``_cascade_bwd_core``) where only the
  backward gate fails (N = 1024, K = 24), and the gate decisions
  themselves against ``acdc_cascade_bwd.fits_vmem``;
* ``cross_entropy``, both implementations, with masked labels.

fp32 tolerance atol 2e-4, rtol 1e-3 (tests/test_kernel_grads.py:248):
both sides sum in fp32 in different orders.  Diagonal grads are row sums
over M, so they are held relative to their largest entry.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import acdc_cascade_bwd as jcbwd
from repro.kernels import ops as jops
from repro.models import common as jcommon
from repro_torch.kernels import ops as tops
from repro_torch.models import common as tcommon
from repro_torch.models.common import ModelConfig

F32 = dict(atol=2e-4, rtol=1e-3)


def _inputs(seed, m, n, k, bias):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, n).astype(np.float32)
    a = (1 + 0.061 * rs.randn(k, n)).astype(np.float32)
    d = (1 + 0.061 * rs.randn(k, n)).astype(np.float32)
    b = (0.1 * rs.randn(k, n)).astype(np.float32) if bias else None
    g = rs.randn(m, n).astype(np.float32)
    return x, a, d, b, g


def _vjp_pair(x, a, d, b, g, relu, permute, dtype=np.float32):
    """(reference grads, port grads, reference y, port y) of the cascade
    op on the same inputs and cotangent."""
    has_b = b is not None
    jargs = [jnp.asarray(v, dtype) if i == 0 else jnp.asarray(v)
             for i, v in enumerate([x, a, d] + ([b] if has_b else []))]

    def f(*p):
        return jops.acdc_cascade_op(p[0], p[1], p[2],
                                    p[3] if has_b else None, relu=relu,
                                    permute=permute)

    jy, vjp = jax.vjp(f, *jargs)
    jg = vjp(jnp.asarray(g, dtype))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    targs = [torch.tensor(v).to(tdt if i == 0 else torch.float32)
             .requires_grad_() for i, v in
             enumerate([x, a, d] + ([b] if has_b else []))]
    ty = tops.acdc_cascade_op(targs[0], targs[1], targs[2],
                              targs[3] if has_b else None, relu=relu,
                              permute=permute)
    ty.backward(torch.tensor(g).to(tdt))
    return ([np.asarray(v, np.float32) for v in jg],
            [t.grad.float().numpy() for t in targs],
            np.asarray(jy, np.float32), ty.detach().float().numpy())


def _assert_grads(jg, tg, tol):
    names = ["dx", "da", "dd", "db"]
    for name, want, got in zip(names, jg, tg):
        scale = max(float(np.max(np.abs(want))), 1.0)
        np.testing.assert_allclose(got, want, atol=tol["atol"] * scale,
                                   rtol=tol["rtol"], err_msg=name)


@pytest.mark.parametrize(
    "relu,permute,bias,k,n",
    list(itertools.product([False, True], [False, True], [False, True],
                           [1, 2, 3], [128, 256])))
def test_grads_match_reference_vjp(relu, permute, bias, k, n):
    m = 13                  # a ragged row block on both sides
    x, a, d, b, g = _inputs(k * 100 + n + 8 * relu + 4 * permute + bias,
                            m, n, k, bias)
    before = dict(tops.CASCADE_BWD_DISPATCHES)
    jg, tg, jy, ty = _vjp_pair(x, a, d, b, g, relu, permute)
    np.testing.assert_allclose(ty, jy, **F32)
    _assert_grads(jg, tg, F32)
    # K >= 2 at these sizes is a fused cascade whose backward gate passes
    swept = tops.CASCADE_BWD_DISPATCHES["reverse_sweep"] - \
        before["reverse_sweep"]
    assert swept == (1 if k >= 2 else 0)


@pytest.mark.parametrize("relu,bias,k", [(False, True, 1), (True, False, 2)])
def test_two_call_route_grads_match_reference(relu, bias, k):
    # N = 2048 > MAX_FUSED_N: forward and backward are scaled_matmul
    # products (the per-layer cascade for K = 2), small M
    x, a, d, b, g = _inputs(7 + k, 3, 2048, k, bias)
    assert not tops.cascade_fits(2048, k, permute=True, bias=bias)
    jg, tg, jy, ty = _vjp_pair(x, a, d, b, g, relu, True)
    np.testing.assert_allclose(ty, jy, **F32)
    _assert_grads(jg, tg, F32)


def test_per_layer_backward_where_only_the_backward_gate_fails():
    n, k = 1024, 24
    assert tops.cascade_fits(n, k, permute=True, bias=False)
    assert not tops.cascade_bwd_fits(n, k, permute=True, bias=False)
    x, a, d, b, g = _inputs(3, 4, n, k, False)
    jbefore = dict(jops.CASCADE_BWD_DISPATCHES)
    tbefore = dict(tops.CASCADE_BWD_DISPATCHES)
    jg, tg, jy, ty = _vjp_pair(x, a, d, b, g, True, True)
    np.testing.assert_allclose(ty, jy, **F32)
    _assert_grads(jg, tg, F32)
    for counts, before in ((jops.CASCADE_BWD_DISPATCHES, jbefore),
                           (tops.CASCADE_BWD_DISPATCHES, tbefore)):
        assert counts["per_layer_scan"] == before["per_layer_scan"] + 1
        assert counts["reverse_sweep"] == before["reverse_sweep"]


@pytest.mark.parametrize("n", [128, 256])
def test_bf16_reverse_sweep_grads_match_reference(n):
    # bf16 x: the reverse sweep rounds only dx (fp32 resident activation),
    # so both sides agree to one bf16 ulp (2^-8 relative) of dx's scale
    x, a, d, b, g = _inputs(n + 1, 13, n, 2, False)
    jg, tg, jy, ty = _vjp_pair(x, a, d, b, g, True, True, jnp.bfloat16)
    _assert_grads(jg, tg, dict(atol=2 ** -7, rtol=2 ** -7))


@pytest.mark.parametrize(
    "n,k,permute,bias",
    list(itertools.product([128, 512, 1024, 2048], [1, 2, 16, 18, 19, 24],
                           [False, True], [False, True])))
def test_backward_gate_agrees_with_reference(n, k, permute, bias):
    assert tops.cascade_bwd_fits(n, k, permute=permute, bias=bias) == \
        jcbwd.fits_vmem(n, k, permute=permute, bias=bias)
    for bm in tops.CANDIDATE_BMS:
        assert tops.cascade_bwd_vmem_bytes(
            n, k, permute=permute, bias=bias, bm=bm) == \
            jcbwd.cascade_bwd_vmem_bytes(n, k, permute=permute, bias=bias,
                                         bm=bm)


def test_backward_gate_constants_match_reference():
    assert tops.CANDIDATE_BMS == jcbwd.CANDIDATE_BMS
    assert tops.VMEM_BUDGET == jcbwd.VMEM_BUDGET
    # at N = 1024 with riffle and no bias the sweep
    # takes K <= 16 and not K = 24
    assert tops.cascade_bwd_fits(1024, 16, permute=True, bias=False)
    assert not tops.cascade_bwd_fits(1024, 24, permute=True, bias=False)


@pytest.mark.parametrize("impl", ["onehot", "gather"])
def test_cross_entropy_matches_reference(impl):
    rs = np.random.RandomState(5)
    logits = (3 * rs.randn(2, 7, 50)).astype(np.float32)
    labels = rs.randint(0, 50, size=(2, 7)).astype(np.int32)
    labels[0, -1] = labels[1, -1] = -1
    labels[1, 2] = -1
    jcfg = jcommon.ModelConfig(ce_impl=impl)
    tcfg = ModelConfig(ce_impl=impl)

    def jloss(lg):
        return jcommon.cross_entropy(lg, jnp.asarray(labels), jcfg)

    jl, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl_in = torch.tensor(logits, requires_grad=True)
    tl = tcommon.cross_entropy(tl_in, torch.tensor(labels), tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tl_in.grad.numpy(), np.asarray(jgrad),
                               atol=1e-7, rtol=1e-5)


def test_cross_entropy_all_masked_is_zero():
    cfg = ModelConfig()
    logits = torch.randn(1, 3, 11)
    labels = torch.full((1, 3), -1, dtype=torch.int32)
    assert float(tcommon.cross_entropy(logits, labels, cfg)) == 0.0
