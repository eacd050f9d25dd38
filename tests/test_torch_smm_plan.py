"""``scaled_matmul``'s launch plan and the written form of its tensor-core
arithmetic, on the CPU.

``plan()`` is pure Python and decides everything about a launch of
``csrc/scaled_matmul.cu`` that is not in the kernel: the regime (weight
stream for small M, 3xTF32 tensor cores above), the tile, the K splits,
the copy width and the workspace.  The kernel itself runs only on the card
(tests/test_torch_cuda.py); here its plan and its split arithmetic are
held to their contracts: every K split non-empty and all of K covered,
the grid covering M and N, 16-byte copies only where the shapes and
addresses allow them, and ``tf32_split`` reconstructing fp32 to 2^-22 with
the three-product sum as accurate as an fp32 product.

Inputs are numpy-seeded.  The three-product sum is held within 2 x an
fp32 ``torch.matmul``'s error against fp64 (the bound chip_smoke.py holds
the kernel to on the card), and against the JAX Pallas kernel in
interpret mode at the reference kernel tests' fp32 tolerance (atol 2e-4,
rtol 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import scaled_matmul as jsmm
from repro_torch.kernels import scaled_matmul as tsmm

from _torch_threads import one_torch_thread  # noqa: F401

SIZES = (100, 257, 2048, 6144)
MS = (1, 4, 16, 17, 64, 512)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("m", MS)
def test_regime_boundary(m):
    p = tsmm.plan(m, 2048, 2048, torch.bfloat16)
    assert p.regime == ("stream" if m <= tsmm.STREAM_MAX_M else "tc")
    assert tsmm.regime(m) == p.regime
    assert tsmm.STREAM_MAX_M == 16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", SIZES + (0, 1, 32))
@pytest.mark.parametrize("m", (1, 4, 17, 512))
def test_plan_splits_grid_and_workspace(m, k, n, dtype):
    for p in (tsmm.plan(m, n, k, dtype), tsmm.plan_stream(m, n, k, dtype),
              tsmm.plan_tc(m, n, k, dtype)):
        assert p.splits >= 1 and p.k_chunk > 0
        assert p.k_chunk % tsmm.BK == 0
        # the splits cover K, and every split has at least one row of K
        assert p.splits * p.k_chunk >= k
        assert p.splits == 1 or (p.splits - 1) * p.k_chunk < k
        gm, gn, gs = p.grid(m, n)
        assert gs == p.splits
        assert gm * p.bm >= m and (gm - 1) * p.bm < m
        assert gn * p.bn >= n and (gn - 1) * p.bn < n
        assert p.ws_bytes == (4 * p.splits * m * n if p.splits > 1 else 0)
        if p.regime == "stream":
            assert p.bm in tsmm.STREAM_ROWS and p.bn == tsmm.STREAM_BN
            # the ring and the block's x * pre fit one block's shared memory
            assert (tsmm.STREAM_RING_BYTES + 4 * p.bm * p.k_chunk
                    <= tsmm.SMEM_LIMIT)
        else:
            assert (p.bm, p.bn) in {(bm, bn) for bm, bn, _ in tsmm.TC_TILES}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", SIZES)
def test_copy_width(k, n, dtype):
    item = 2 if dtype == torch.bfloat16 else 4
    assert tsmm.plan_stream(4, n, k, dtype).vec == (4 if n % 4 == 0 else 1)
    want_tc = 4 if n % 4 == 0 and (k * item) % 16 == 0 else 1
    assert tsmm.plan_tc(64, n, k, dtype).vec == want_tc
    # an address off 16 bytes forbids 16-byte copies whatever the shapes
    assert tsmm.plan(4, n, k, dtype, align=4).vec == 1
    assert tsmm.plan(64, n, k, dtype, align=8).vec == 1


def test_main_path_plans():
    # decode (4 slots) streams w over >= two waves of the 132 SMs; the
    # full-width training M = 512 takes the 128-row tensor-core tile on
    # (nearly) every SM
    for n in (2048, 6144):
        p = tsmm.plan(4, n, n, torch.bfloat16)
        assert p.regime == "stream" and p.vec == 4
        assert np.prod(p.grid(4, n)) >= 2 * tsmm.SMS
        p = tsmm.plan(512, n, n, torch.float32)
        assert p.regime == "tc" and (p.bm, p.bn) == (128, 128)
        assert np.prod(p.grid(512, n)) >= 0.9 * tsmm.SMS
    assert tsmm.plan(64, 6144, 6144, torch.bfloat16).bm == 64


def test_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tsmm.plan(4, 128, 128, torch.float16)


def test_launch_refuses_cpu_tensors():
    # no fallback: the launch path takes CUDA tensors or raises
    x, w = torch.zeros(4, 64), torch.zeros(64, 32)
    with pytest.raises(ValueError):
        tsmm.launch(x, w, None, None, None,
                    tsmm.plan(4, 32, 64, torch.float32))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed", range(3))
def test_tf32_split_reconstructs(seed):
    rs = np.random.RandomState(seed)
    t = torch.from_numpy((rs.randn(4096) * 10.0 ** rs.uniform(
        -6, 6, 4096)).astype(np.float32))
    big, small = tsmm.tf32_split(t)
    # both parts hold 10 explicit mantissa bits (the low 13 are zero)
    assert int((_bits(big) & 0x1FFF).abs().max()) == 0
    assert int((_bits(small) & 0x1FFF).abs().max()) == 0
    rel = ((big.double() + small.double() - t.double()).abs()
           / t.double().abs())
    assert float(rel.max()) <= 2.0 ** -22
    # big alone is a TF32 rounding: within half a TF32 ulp (2^-11)
    assert float(((big.double() - t.double()).abs()
                  / t.double().abs()).max()) <= 2.0 ** -11


def test_tf32_split_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11          # halfway between two TF32 values
    t = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    big, small = tsmm.tf32_split(t)
    assert big.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    assert (big + small).tolist() == t.tolist()


def _three_products(x, w):
    xb, xs = tsmm.tf32_split(x)
    wb, ws = tsmm.tf32_split(w)
    return xs @ wb + xb @ ws + xb @ wb


@pytest.mark.parametrize("seed", range(2))
def test_three_tf32_products_as_accurate_as_fp32(seed):
    rs = np.random.RandomState(100 + seed)
    m, k, n = 4, 2048, 2048
    x = rs.randn(m, k).astype(np.float32)
    pre = (1.0 + 0.061 * rs.randn(k)).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
    xp = torch.from_numpy(x) * torch.from_numpy(pre)  # rounded to fp32
    wt = torch.from_numpy(w)
    y64 = xp.double() @ wt.double()
    scale = float(y64.abs().max())
    err3 = float((_three_products(xp, wt).double() - y64).abs().max()) / scale
    err32 = float((torch.matmul(xp, wt).double() - y64).abs().max()) / scale
    assert err3 <= 2 * err32, (err3, err32)
    # one TF32 product (the precision rule's "plain TF32, never") is far
    # outside that bound
    xb, _ = tsmm.tf32_split(xp)
    wb, _ = tsmm.tf32_split(wt)
    err1 = float(((xb @ wb).double() - y64).abs().max()) / scale
    assert err1 > 20 * err32


def test_three_tf32_products_match_pallas():
    rs = np.random.RandomState(7)
    m, k, n = 4, 256, 256
    x = rs.randn(m, k).astype(np.float32)
    pre = (1.0 + 0.061 * rs.randn(k)).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
    want = jsmm.scaled_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                     pre=jnp.asarray(pre), bm=8, bn=128,
                                     bk=128, interpret=True)
    got = _three_products(torch.from_numpy(x) * torch.from_numpy(pre),
                          torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-3)
