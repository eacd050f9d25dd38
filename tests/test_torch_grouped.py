"""Grouped cascades (the MoE experts' per-expert ACDC layers), on the CPU:
the plain versions and the routing that the card runs as grouped kernels.

* ``ref.scaled_matmul_ref`` with grouped vectors (pre (G, K), post and
  bias (G, N) over x (G C, K)) equals a loop of ungrouped calls on each
  group's rows, bit for bit in fp32 (and in bf16 x);
* ``ops._layer_fwd`` / ``ops._layer_bwd`` with grouped (G, N) diagonals
  equal a per-group loop, above ``MAX_FUSED_N`` (one grouped two-call
  layer, per-group diagonal sums) and at or below it (the fused kernels'
  plain versions, once per group); the grouped ``acdc_cascade_op`` and
  its autograd equal per-group ungrouped cascades;
* ``scaled_matmul.plan`` sees ``M = E C`` (the shapes of §4 of the MoE
  slice: decode at cap 1, a 64-token admission at cap 7, the train step at
  cap 60), and the wrapper refuses vectors grouped unlike each other or
  groups that do not divide x's rows;
* ``ops.forward_launches`` counts the grouped calls: one grouped
  ``scaled_matmul`` a call above ``MAX_FUSED_N``, the cascade kernels once
  per group below -- the same count the wrappers are called with.

fp32 atol 2e-4, rtol 1e-3 where the sums are not the same sums.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import acdc_cascade_fused as tcascade
from repro_torch.kernels import acdc_fused as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels import scaled_matmul as tsmm

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)


def _randn(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vectors", ["pre", "pre+bias", "pre+post+bias",
                                     "post"])
def test_grouped_ref_equals_loop_of_ungrouped_calls_bitwise(vectors, dtype):
    rs = np.random.RandomState(0)
    g, c, k, n = 5, 3, 40, 24
    x = _randn(rs, g * c, k).to(dtype)
    w = _randn(rs, k, n)
    vec = {"pre": 1.0 + 0.06 * _randn(rs, g, k),
           "post": 1.0 + 0.06 * _randn(rs, g, n),
           "bias": _randn(rs, g, n)}
    kw = {name: vec[name] for name in vectors.split("+")}
    got = ref.scaled_matmul_ref(x, w, **kw)
    want = torch.cat([
        ref.scaled_matmul_ref(x[i * c:(i + 1) * c], w,
                              **{nm: v[i] for nm, v in kw.items()})
        for i in range(g)])
    assert got.dtype == dtype
    assert torch.equal(got, want)
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(tsmm.scaled_matmul(x, w, **kw), got)


def test_wrapper_refuses_groups_it_cannot_serve():
    x, w = torch.zeros(6, 8), torch.zeros(8, 4)
    with pytest.raises(ValueError, match="divide"):
        tsmm.scaled_matmul(x, w, pre=torch.ones(4, 8))
    with pytest.raises(ValueError, match="like the others"):
        tsmm.scaled_matmul(x, w, pre=torch.ones(3, 8), bias=torch.ones(4))
    with pytest.raises(ValueError, match="like the others"):
        tsmm.scaled_matmul(x, w, pre=torch.ones(3, 8), bias=torch.ones(2, 4))
    with pytest.raises(ValueError, match="shape"):
        tsmm.scaled_matmul(x, w, pre=torch.ones(4))
    assert tsmm.groups_of(6, torch.ones(3, 8), None, torch.ones(3, 4),
                          8, 4) == 3
    assert tsmm.groups_of(6, None, None, None, 8, 4) == 1


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("n", [128, 1280])
def test_grouped_layer_equals_per_group_loop(n, with_bias):
    rs = np.random.RandomState(1)
    g, c = 4, 3
    x2 = _randn(rs, g * c, n)
    g2 = _randn(rs, g * c, n)
    a = 1.0 + 0.06 * _randn(rs, g, n)
    d = 1.0 + 0.06 * _randn(rs, g, n)
    bias = 0.1 * _randn(rs, g, n) if with_bias else None
    y = tops._layer_fwd(x2, a, d, bias, "acdc")
    dx, da, dd, db = tops._layer_bwd(x2, a, d, g2, with_bias, "acdc")
    assert da.shape == dd.shape == (g, n)
    for i in range(g):
        rows = slice(i * c, (i + 1) * c)
        bi = None if bias is None else bias[i]
        np.testing.assert_allclose(
            y[rows].numpy(),
            tops._layer_fwd(x2[rows], a[i], d[i], bi, "acdc").numpy(), **F32)
        want = tops._layer_bwd(x2[rows], a[i], d[i], g2[rows], with_bias,
                               "acdc")
        np.testing.assert_allclose(dx[rows].numpy(), want[0].numpy(), **F32)
        np.testing.assert_allclose(da[i].numpy(), want[1].numpy(), **F32)
        np.testing.assert_allclose(dd[i].numpy(), want[2].numpy(), **F32)
        if with_bias:
            np.testing.assert_allclose(db[i].numpy(), want[3].numpy(),
                                       **F32)
        else:
            assert db is None


@pytest.mark.parametrize("n,k", [(128, 2), (256, 1), (1280, 2), (1280, 1)])
def test_grouped_cascade_and_grads_equal_per_group_cascades(n, k):
    rs = np.random.RandomState(2)
    g, c = 3, 5
    x = _randn(rs, g, c, n).requires_grad_(True)
    a = (1.0 + 0.06 * _randn(rs, g, k, n)).requires_grad_(True)
    d = (1.0 + 0.06 * _randn(rs, g, k, n)).requires_grad_(True)
    gy = _randn(rs, g, c, n)
    y = tops.acdc_cascade_op(x, a, d, relu=True, permute=True)
    got = torch.autograd.grad(y, (x, a, d), gy)
    for i in range(g):
        xi = x.detach()[i].clone().requires_grad_(True)
        ai = a.detach()[i].clone().requires_grad_(True)
        di = d.detach()[i].clone().requires_grad_(True)
        yi = tops.acdc_cascade_op(xi, ai, di, relu=True, permute=True)
        np.testing.assert_allclose(y[i].detach().numpy(),
                                   yi.detach().numpy(), **F32)
        want = torch.autograd.grad(yi, (xi, ai, di), gy[i])
        for got_t, want_t in zip(got, want):
            np.testing.assert_allclose(got_t[i].numpy(), want_t.numpy(),
                                       **F32)


@pytest.mark.parametrize("c,regime", [(1, "tc"), (7, "tc"), (60, "tc")])
def test_plan_sees_every_groups_rows(c, regime):
    # DeepSeekMoE-16B: E = 64 experts, K = N = 2048 (expert projections)
    e, n = 64, 2048
    m = e * c
    assert tsmm.regime(m) == regime
    p = tsmm.plan(m, n, n, torch.bfloat16)
    assert p.regime == regime
    assert p.grid(m, n)[0] * p.bm >= m
    # one small group count stays in the weight stream
    assert tsmm.regime(4 * 4) == "stream"


def _counting(monkeypatch):
    calls = {"scaled_matmul": 0, "acdc_cascade": 0, "acdc_fused": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, counted)

    wrap(tsmm, "scaled_matmul", "scaled_matmul")
    wrap(tcascade, "acdc_cascade", "acdc_cascade")
    wrap(tfused, "acdc_fused", "acdc_fused")
    return calls


@pytest.mark.parametrize("n,k", [(128, 2), (128, 1), (2048, 2), (2816, 1)])
def test_forward_launches_count_grouped_calls(n, k, monkeypatch):
    g, c = 6, 2
    calls = _counting(monkeypatch)
    rs = np.random.RandomState(3)
    x = _randn(rs, g, c, n)
    a = 1.0 + 0.06 * _randn(rs, g, k, n)
    d = 1.0 + 0.06 * _randn(rs, g, k, n)
    tops.acdc_cascade_op(x, a, d, permute=True)
    want = tops.forward_launches(n, k, g * c, permute=True, bias=False,
                                 groups=g)
    assert {key: v for key, v in calls.items() if v} == {
        key: v for key, v in want.items()
        if not key.startswith("scaled_matmul_")}
    if n > tops.MAX_FUSED_N:
        # one grouped call a product, never one a group
        assert want["scaled_matmul"] == 2 * k
        assert want[f"scaled_matmul_{tsmm.regime(g * c)}"] == 2 * k
    else:
        assert sum(want.values()) == (g if k > 1 else g * k)
