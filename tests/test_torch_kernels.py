"""Port parity, kernels: each kernel wrapper of ``repro_torch`` on CPU
tensors (i.e. its plain version) against the JAX Pallas kernel it
replaces, run in interpret mode as the reference's own tests run it.

Covers ``scaled_matmul`` (every pre/post/bias combination, ragged M/N/K),
``acdc_fused`` (with and without bias) and ``paged_attention`` (T = 1 and
3, window and softcap, GQA, unmapped table tails, a parked row, fp32 and
bf16 pools, pools compared too).  The cascade sweep is in
tests/test_torch_cascade.py.

Tolerances: fp32 atol 2e-4, rtol 1e-3 (tests/test_kernel_grads.py:248).
bf16 outputs: both sides sum in fp32 in different orders and round once
to bf16, so they may differ by one bf16 ulp (2^-8 relative): rtol 2^-7,
atol 2e-2 for values of order 1.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import families as jfam
from repro.kernels import acdc_fused as jfused
from repro.kernels import paged_attn as jpaged
from repro.kernels import scaled_matmul as jsmm
from repro_torch.core import families as tfam
from repro_torch.kernels import acdc_fused as tfused
from repro_torch.kernels import paged_attn as tpaged
from repro_torch.kernels import scaled_matmul as tsmm

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
BF16 = dict(atol=2e-2, rtol=2 ** -7)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("pre,post,bias",
                         list(itertools.product([False, True], repeat=3)))
@pytest.mark.parametrize("m,k,n", [(13, 100, 72), (8, 128, 256)])
def test_scaled_matmul_matches_pallas(m, k, n, pre, post, bias):
    rs = np.random.RandomState(m * 7 + k + n)
    x = rs.randn(m, k).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
    vec = {"pre": rs.randn(k).astype(np.float32) if pre else None,
           "post": rs.randn(n).astype(np.float32) if post else None,
           "bias": rs.randn(n).astype(np.float32) if bias else None}
    want = jsmm.scaled_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w),
        **{k_: None if v is None else jnp.asarray(v)
           for k_, v in vec.items()}, bm=8, bn=128, bk=128, interpret=True)
    got = tsmm.scaled_matmul(_t(x), _t(w),
                             **{k_: None if v is None else _t(v)
                                for k_, v in vec.items()})
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_scaled_matmul_bf16_output_dtype():
    rs = np.random.RandomState(1)
    x = rs.randn(5, 256).astype(np.float32)
    w = (rs.randn(256, 128) / 16).astype(np.float32)
    pre = (1 + 0.06 * rs.randn(256)).astype(np.float32)
    want = jsmm.scaled_matmul_pallas(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(w), pre=jnp.asarray(pre),
                                     interpret=True)
    got = tsmm.scaled_matmul(_t(x).to(torch.bfloat16), _t(w), pre=_t(pre))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("family", ["acdc", "circulant"])
def test_acdc_fused_matches_pallas(family, with_bias):
    n, m = 256, 21
    rs = np.random.RandomState(3)
    x = rs.randn(m, n).astype(np.float32)
    a = (1 + 0.061 * rs.randn(n)).astype(np.float32)
    d = (1 + 0.061 * rs.randn(n)).astype(np.float32)
    b = (0.1 * rs.randn(n)).astype(np.float32) if with_bias else None
    jc, jct = jfam.get_family(family).matrices(n, jnp.float32)
    want = jfused.acdc_fused_pallas(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(d),
        None if b is None else jnp.asarray(b), jc, jct, bm=8,
        interpret=True)
    tc, tct = tfam.get_family(family).matrices(n, torch.float32, "cpu")
    got = tfused.acdc_fused(_t(x), _t(a), _t(d),
                            None if b is None else _t(b), tc, tct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def _seq_tables(b, mb):
    return np.arange(b * mb, dtype=np.int32).reshape(b, mb)


def _tail_unmapped_tables(b, mb):
    # row 0 mapped only below its frontier, later rows fully mapped; the
    # last row is parked (position == virtual) with an unmapped table
    t = _seq_tables(b, mb)
    t[0, 2:] = -1
    t[-1, :] = -1
    return t


_CASES = {
    "decode-global": dict(b=3, t=1, hkv=4, group=2, dh=8, bs=4, mb=6,
                          window=0, softcap=0.0, positions=[5, 0, 17],
                          tables=_seq_tables),
    "verify-ragged-parked": dict(b=4, t=3, hkv=4, group=2, dh=16, bs=4,
                                 mb=6, window=0, softcap=0.0,
                                 positions=[2, 7, 20, 24],
                                 tables=_seq_tables),
    "verify-window-softcap": dict(b=2, t=3, hkv=2, group=1, dh=8, bs=4,
                                  mb=5, window=6, softcap=50.0,
                                  positions=[9, 14], tables=_seq_tables),
    "decode-unmapped-tail-parked": dict(b=3, t=1, hkv=2, group=4, dh=8,
                                        bs=4, mb=5, window=0, softcap=0.0,
                                        positions=[6, 11, 20],
                                        tables=_tail_unmapped_tables),
    "decode-bf16": dict(b=3, t=1, hkv=4, group=2, dh=8, bs=4, mb=6,
                        window=0, softcap=0.0, positions=[5, 0, 17],
                        tables=_seq_tables, dtype="bfloat16"),
    "verify-bf16-window": dict(b=2, t=3, hkv=2, group=2, dh=16, bs=4, mb=6,
                               window=5, softcap=0.0, positions=[3, 13],
                               tables=_seq_tables, dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_paged_attention_matches_pallas(case):
    c = dict(_CASES[case])
    dtype = c.pop("dtype", "float32")
    b, t, hkv, group, dh = c["b"], c["t"], c["hkv"], c["group"], c["dh"]
    bs, mb = c["bs"], c["mb"]
    nb = b * mb
    rs = np.random.RandomState(len(case))

    def arr(*shape):
        return rs.randn(*shape).astype(np.float32)

    q, kn, vn = arr(b, t, hkv * group, dh), arr(b, t, hkv, dh), \
        arr(b, t, hkv, dh)
    kp, vp = arr(nb + 1, bs, hkv, dh), arr(nb + 1, bs, hkv, dh)
    tbl = c["tables"](b, mb)
    pos = np.asarray(c["positions"], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    jo, jk, jv = jpaged.paged_attention(
        *(jnp.asarray(v, jdt) for v in (q, kn, vn, kp, vp)),
        jnp.asarray(tbl), jnp.asarray(pos), jnp.int32(c["window"]),
        softcap=c["softcap"], page_chunk=2, head_block=1, interpret=True)
    tk, tv = _t(kp).to(tdt), _t(vp).to(tdt)
    to = tpaged.paged_attention(
        *(_t(v).to(tdt) for v in (q, kn, vn)), tk, tv, _t(tbl), _t(pos),
        c["window"], softcap=c["softcap"])
    assert to.shape == q.shape and to.dtype == tdt
    live = pos < mb * bs
    tol = BF16 if dtype == "bfloat16" else F32
    np.testing.assert_allclose(to.float().numpy()[live],
                               np.asarray(jo, np.float32)[live], **tol)
    # pools: the same writes, bit for bit, outside the trash page (several
    # parked rows may write there; nothing reads it)
    assert np.array_equal(tk.float().numpy()[:-1],
                          np.asarray(jk, np.float32)[:-1])
    assert np.array_equal(tv.float().numpy()[:-1],
                          np.asarray(jv, np.float32)[:-1])
    if not live.all():
        # a parked row averages its new values uniformly, as in Pallas
        np.testing.assert_allclose(to.float().numpy()[~live],
                                   np.asarray(jo, np.float32)[~live], **tol)


def test_paged_kernel_limits():
    assert tpaged.fits(hkv=8, dh=128, group=2, t=5)
    assert not tpaged.fits(hkv=8, dh=256, group=2, t=1)
    # any group * T: the rows go in row blocks of 16 (32 and 512 here)
    assert tpaged.fits(hkv=1, dh=64, group=8, t=4)
    assert tpaged.fits(hkv=2, dh=128, group=16, t=32)
    assert not tpaged.fits(hkv=1, dh=64, group=8, t=33)


def test_cuda_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError):
        tsmm.scaled_matmul(x, torch.zeros(4, 4, device="meta"))
    with pytest.raises(ValueError):
        tfused.acdc_fused(x, torch.ones(4, device="meta"),
                          torch.ones(4, device="meta"), None,
                          torch.eye(4, device="meta"),
                          torch.eye(4, device="meta"))
