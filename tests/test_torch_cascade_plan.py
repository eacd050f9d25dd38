"""The cluster plans of the cascade kernels, on the CPU.

``kernels/acdc_cascade_fused.plan`` (forward) and
``kernels/acdc_cascade_bwd.plan_bwd`` (reverse sweep) decide everything
about a launch of ``csrc/acdc_cascade.cu`` / ``csrc/acdc_cascade_bwd.cu``
that is not in the kernel: the cluster size S and the column slices, the
rows a cluster, resident or streamed transforms, the shared memory, where
the backward's stash lives and the workspace shapes.  Held here:

* over N in {1, 37, 100, 128, 256, 384, 1000, 1024}, M in {1, 4, 37, 64,
  256, 512} and K in {1, 2, 3, 24}: every output column is owned by
  exactly one CTA, shared memory is at most 232,448 bytes and is what
  the sources' layout takes, S <= 16, the tiles cover the depth, the
  stash sits in shared memory exactly when its bytes fit, and the
  workspaces have the shapes the C side indexes (the backward at K = 1,
  one layer's and ``acdc_bwd``'s launch, without the riffle);
* the plans' dataflow, emulated in PyTorch (column slices, each warp's
  share of k, partials summed in warp order, the backward's own-column
  stash, ReLU mask and per-cluster column sums written at the C side's
  workspace offsets), against the JAX Pallas kernels in interpret mode on
  numpy-seeded inputs, fp32 atol 2e-4, rtol 1e-3; the backward's K = 1
  launch against ``acdc_bwd_pallas``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import families as jfam
from repro.kernels import acdc_bwd as jbwd
from repro.kernels import acdc_cascade_bwd as jcbwd
from repro.kernels import acdc_cascade_fused as jcascade
from repro_torch.core import families as tfam
from repro_torch.kernels import acdc_cascade_bwd as tcbwd
from repro_torch.kernels import acdc_cascade_fused as tcascade

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
NS = (1, 37, 100, 128, 256, 384, 1000, 1024)
MS = (1, 4, 37, 64, 256, 512)
KS = (1, 2, 3, 24)


def _fwd_smem(p, k, riffle):
    """The forward's layout (acdc_cascade.cu): h, h2 (bm x nk), the warps'
    partials (8 x bm x lw), the transform slices."""
    lw = 32 * p.cpt
    nmats = 3 if riffle and k > 1 else 2
    mats = (nmats * p.nk * lw if p.resident else 4 * p.kt * lw)
    return 4 * (2 * p.bm * p.nk + 8 * p.bm * lw + mats)


def _bwd_smem(p, k, riffle, stash_smem):
    """The backward's layout (acdc_cascade_bwd.cu): s0, s1, s2, own columns
    of x, gc and the stash (or 2 slots), partials, column sums, slices
    (ct_mid also transposed, rows nk + 4 / kt + 4 apart)."""
    lw = 32 * p.cpt
    own = p.bm * lw * (2 + (k - 1 if stash_smem else 2))
    if p.resident:
        mats = (3 if riffle else 2) * p.nk * lw + (lw * (p.nk + 4)
                                                   if riffle else 0)
    else:
        mats = 4 * (lw * (p.kt + 4) if riffle else p.kt * lw)
    return 4 * (3 * p.bm * p.nk + own + 8 * p.bm * lw + 3 * 8 * lw + mats)


def _check_geometry(p, m, n, aligned=True):
    assert 1 <= p.s <= 16
    assert p.bm in tcascade.ROW_BLOCKS and p.cpt in tcascade.COL_GROUPS
    assert p.clusters == -(-m // p.bm)
    assert p.smem_bytes <= 232448
    # every output column owned by exactly one CTA, none idle
    owned = np.zeros(n, np.int64)
    for j0, j1 in p.slices():
        assert 0 <= j0 < j1 <= n and j1 - j0 <= 32 * p.cpt
        owned[j0:j1] += 1
    assert (owned == 1).all()
    # the depth: whole 32-row warp shares, whole tiles
    assert p.nk >= n and p.nk % 32 == 0 and p.nk - n < 32
    assert p.kt % 32 == 0 and p.nk % p.kt == 0
    assert (p.kt == p.nk) == p.resident
    if p.vec == 4:
        assert n % 4 == 0 and p.width % 4 == 0
    else:
        assert p.vec == 1 and (n % 4 or not aligned)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("n", NS)
def test_plans(n, m, k):
    for riffle in (False, True):
        p = tcascade.plan(m, n, k, riffle)
        _check_geometry(p, m, n)
        assert p.smem_bytes == _fwd_smem(p, k, riffle)
        if k < 2 and riffle:
            continue      # one layer has no mid matrix
        q = tcbwd.plan_bwd(m, n, k, riffle)
        _check_geometry(q, m, n)
        assert q.smem_bytes == _bwd_smem(q, k, riffle, q.stash_smem)
        # the stash is on chip exactly when its bytes fit
        fits = _bwd_smem(q, k, riffle, True) <= 232448
        assert q.stash_smem == fits
        stash, part = tcbwd.workspaces(q, m, n, k)
        assert stash == (None if fits else (k - 1, m, n))
        assert part == (q.clusters, 3, k, n)


def test_plans_refuse_what_the_kernels_do_not_take():
    for bad in ((4, 0, 2), (4, 1025, 2), (0, 128, 2), (4, 128, 0)):
        with pytest.raises(ValueError):
            tcascade.plan(*bad, True)
    with pytest.raises(ValueError):
        tcbwd.plan_bwd(4, 128, 1, True)


def test_unaligned_transforms_take_four_byte_copies():
    p = tcascade.plan(4, 256, 2, True, vec_ok=False)
    assert p.vec == 1
    _check_geometry(p, 4, 256, aligned=False)
    assert tcascade.plan(4, 256, 2, True).vec == 4


def test_main_path_plans_spread_over_the_card():
    # the decode tick's cascades run on S SMs, not one block of 32 rows
    for n, s in ((128, 4), (256, 8)):
        p = tcascade.plan(4, n, 2, True)
        assert (p.s, p.bm, p.clusters) == (s, 4, 1)
    assert tcbwd.plan_bwd(256, 256, 2, True).ctas() >= 64


# ---------------------------------------------------------------------------
# the plans' dataflow against the JAX kernels
# ---------------------------------------------------------------------------

def _warp_ranges(p):
    """Each warp's k ranges of one product, in its summation order."""
    if p.resident:
        step = p.nk // 8
        return [[(w * step, (w + 1) * step)] for w in range(8)]
    step = p.kt // 8
    return [[(t * p.kt + w * step, t * p.kt + (w + 1) * step)
             for t in range(p.nk // p.kt)] for w in range(8)]


def _product(src, wt, p, n):
    """src (bm, nk) times W (n x n, as ``wt(k0, k1, j0, j1)`` slices):
    each CTA's column slice, each warp's share of k, warps in order."""
    out = torch.zeros(src.shape[0], n, dtype=torch.float32)
    for j0, j1 in p.slices():
        total = None
        for ranges in _warp_ranges(p):
            acc = torch.zeros(src.shape[0], j1 - j0)
            for k0, k1 in ranges:
                k1c = min(k1, n)
                if k0 < k1c:
                    acc = acc + src[:, k0:k1c] @ wt(k0, k1c, j0, j1)
            total = acc if total is None else total + acc
        out[:, j0:j1] = total
    return out


def _normal(w):
    return lambda k0, k1, j0, j1: w[k0:k1, j0:j1]


def _transposed(w):
    # contraction against w's second axis: W(k, j) = w[j, k]
    return lambda k0, k1, j0, j1: w[j0:j1, k0:k1].T


def _emulate_fwd(x, a, d, b, c, ct, mid, relu, p):
    m, n = x.shape
    k = a.shape[0]
    y = torch.empty(m, n)
    for cb in range(p.clusters):
        rows = x[cb * p.bm:(cb + 1) * p.bm]
        r = rows.shape[0]
        h = torch.zeros(p.bm, p.nk)
        h[:r, :n] = rows * a[0]
        for i in range(k):
            z = _product(h, _normal(c), p, n) * d[i]
            if b is not None:
                z = z + b[i]
            h2 = torch.zeros(p.bm, p.nk)
            h2[:r, :n] = z[:r]
            last = i == k - 1
            z = _product(h2, _normal(ct if last or mid is None else mid),
                         p, n)
            if last:
                y[cb * p.bm:cb * p.bm + r] = z[:r]
            else:
                z = torch.clamp_min(z, 0.0) if relu else z
                h = torch.zeros(p.bm, p.nk)
                h[:r, :n] = z[:r] * a[i + 1]
    return y


def _emulate_bwd(x, g, a, d, b, c, ct, mid, relu, p):
    """The reverse sweep as the kernel runs it; the per-cluster sums are
    written at the C side's offsets into flat workspaces of
    ``workspaces()``'s shapes (every element of the partials once)."""
    m, n = x.shape
    k = a.shape[0]
    stash_shape, part_shape = tcbwd.workspaces(p, m, n, k)
    part = torch.full((math.prod(part_shape),), float("nan"))
    stash_g = (None if stash_shape is None
               else torch.full((math.prod(stash_shape),), float("nan")))
    dx = torch.empty(m, n)
    for cb in range(p.clusters):
        m0 = cb * p.bm
        r = min(p.bm, m - m0)

        def full(v):
            t = torch.zeros(p.bm, p.nk)
            t[:r, :n] = v[:r]
            return t

        s0 = full(x[m0:m0 + r] * a[0])
        s2 = full(g[m0:m0 + r])
        hs = [x[m0:m0 + r]]
        for i in range(k - 1):
            z = _product(s0, _normal(c), p, n) * d[i]
            if b is not None:
                z = z + b[i]
            z = _product(full(z), _normal(ct if mid is None else mid), p, n)
            z = torch.clamp_min(z, 0.0) if relu else z
            hs.append(z[:r])
            if stash_g is not None:
                for rr in range(r):
                    at = (i * m + m0 + rr) * n
                    stash_g[at:at + n] = z[rr]
            s0 = full(z * a[i + 1])
        if stash_g is not None:      # the sweep reads the workspace back
            hs = [hs[0]] + [stash_g.view(k - 1, m, n)[i, m0:m0 + r]
                            for i in range(k - 1)]
        for i in range(k - 1, -1, -1):
            w = (_normal(c) if i == k - 1 or mid is None
                 else _transposed(mid))
            gc = _product(s2, w, p, n)[:r]
            h2 = _product(s0, _normal(c), p, n)[:r]
            dh1 = _product(full(gc * d[i]), _normal(ct), p, n)[:r]
            sums = (torch.sum(hs[i] * dh1, 0), torch.sum(h2 * gc, 0),
                    torch.sum(gc, 0))
            for which, col in enumerate(sums):
                if which == 2 and b is None:
                    continue
                at = ((cb * 3 + which) * k + i) * n
                part[at:at + n] = col
            gn = a[i] * dh1
            if i == 0:
                dx[m0:m0 + r] = gn
            else:
                if relu:
                    gn = torch.where(hs[i] > 0, gn, torch.zeros_like(gn))
                s2 = full(gn)
                s0 = full(hs[i - 1] * a[i - 1])
    grads = part.view(part_shape).sum(0)   # the second kernel's sum
    assert not torch.isnan(grads[:3 if b is not None else 2]).any()
    return dx, grads[0], grads[1], grads[2] if b is not None else None


def _inputs(seed, m, n, k, bias, permute, family="acdc"):
    rs = np.random.RandomState(seed)
    x = rs.randn(m, n).astype(np.float32)
    gy = rs.randn(m, n).astype(np.float32)
    a = (1 + 0.061 * rs.randn(k, n)).astype(np.float32)
    d = (1 + 0.061 * rs.randn(k, n)).astype(np.float32)
    b = (0.1 * rs.randn(k, n)).astype(np.float32) if bias else None
    jf = jfam.get_family(family)
    jc, jct = jf.matrices(n, jnp.float32)
    jmid = jct[:, jf.riffle(n)] if permute else None
    tf = tfam.get_family(family)
    tc, tct = tf.matrices(n, torch.float32, "cpu")
    tmid = (tct[:, torch.as_tensor(tf.riffle(n)).long()].contiguous()
            if permute else None)
    return (x, gy, a, d, b, (jc, jct, jmid), (tc, tct, tmid))


def _t(v):
    return None if v is None else torch.from_numpy(np.asarray(v))


def _j(v):
    return None if v is None else jnp.asarray(v)


# (m, n, k, relu, permute, bias, streamed): the smoke decode tick and
# train step, ragged rows and ragged column slices, a streamed plan
DATAFLOW = [(4, 128, 2, False, True, False, False),
            (13, 128, 2, True, True, True, False),
            (37, 100, 3, True, True, True, False),
            (9, 96, 2, False, False, True, True)]
# one layer's backward (K = 1, acdc_bwd's launch): the smoke K=1 train
# step's rows, ragged M with and without bias, a streamed plan
LAYER = [(256, 128, 1, False, False, False, False),
         (37, 256, 1, False, False, True, False),
         (13, 100, 1, False, False, False, False),
         (9, 96, 1, False, False, True, True)]


@pytest.mark.parametrize("m,n,k,relu,permute,bias,streamed", DATAFLOW)
def test_forward_dataflow_matches_pallas(m, n, k, relu, permute, bias,
                                         streamed):
    x, _, a, d, b, jm, tm = _inputs(m + n + k, m, n, k, bias, permute)
    p = tcascade.plan(m, n, k, permute)
    if streamed:   # force a streamed plan: tiles of 32 rows
        import dataclasses
        p = dataclasses.replace(p, kt=32, resident=False)
    got = _emulate_fwd(_t(x), _t(a), _t(d), _t(b), *tm, relu, p)
    want = jcascade.acdc_cascade_pallas(
        _j(x), _j(a), _j(d), _j(b), *jm, relu=relu, bm=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("m,n,k,relu,permute,bias,streamed",
                         DATAFLOW + LAYER)
def test_backward_dataflow_matches_pallas(m, n, k, relu, permute, bias,
                                          streamed):
    x, gy, a, d, b, jm, tm = _inputs(m * n + k, m, n, k, bias, permute)
    p = tcbwd.plan_bwd(m, n, k, permute)
    if streamed:   # streamed slices and the stash in the workspace
        import dataclasses
        p = dataclasses.replace(p, kt=32, resident=False, stash_smem=False)
    got = _emulate_bwd(_t(x), _t(gy), _t(a), _t(d), _t(b), *tm, relu, p)
    if k == 1:      # no re-walk: the bias is never read, only db made
        want = jbwd.acdc_bwd_pallas(
            _j(x), _j(gy), _j(a[0]), _j(d[0]), jm[0], jm[1],
            with_bias=bias, interpret=True)
    else:
        want = jcbwd.acdc_cascade_bwd_pallas(
            _j(x), _j(gy), _j(a), _j(d), _j(b), *jm, relu=relu, bm=16,
            interpret=True)
    for name, u, w in zip(("dx", "da", "dd", "db"), got, want):
        if w is None:
            assert u is None
            continue
        w = np.asarray(w).reshape(u.shape)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(u.numpy(), w, rtol=1e-3,
                                   atol=2e-4 * scale, err_msg=name)
