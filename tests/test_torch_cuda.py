"""CUDA kernels of ``repro_torch`` against their plain versions, on the
card.  Every test here needs an NVIDIA GPU with nvcc: it is marked
``cuda`` and skips (with its reason) where there is none, as on a CPU
test machine.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports neither JAX nor the JAX package (the GPU machine has
neither; ``--noconftest`` skips tests/conftest.py, which imports JAX);
the parity of the plain versions with the JAX kernels is held
by the other ``test_torch_*`` files on the CPU.

Tolerances: fp32 atol 2e-4, rtol 1e-3 (the reference's kernel tests);
bf16 outputs one bf16 ulp apart at most (rtol 2^-7, atol 2e-2), since
kernel and plain version sum in fp32 in different orders and round once.
The backward kernels' diagonal grads are fp32 row sums, held with atol
relative to their largest entry; their outputs must repeat bit for bit.
"""

import itertools

import pytest
import torch

from repro_torch.core import families
from repro_torch.kernels import acdc_bwd as bwd_mod
from repro_torch.kernels import acdc_cascade_bwd as cbwd_mod
from repro_torch.kernels import acdc_cascade_fused as cascade_mod
from repro_torch.kernels import acdc_fused as fused_mod
from repro_torch.kernels import autotune
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as pa_mod
from repro_torch.kernels import ref
from repro_torch.kernels import scaled_matmul as smm_mod

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-4, rtol=1e-3)
BF16 = dict(atol=2e-2, rtol=2 ** -7)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def autotune_file(tmp_path_factory):
    """The autotune winners of this module's sweeps in a file of its own
    (the launches through ``ops`` and ``paged_attention`` sweep a key's
    plans at its first call), not the repository's ``build/``."""
    mp = pytest.MonkeyPatch()
    mp.setenv(autotune.CACHE_ENV + "_PATH",
              str(tmp_path_factory.mktemp("autotune") / "cache.json"))
    yield
    mp.undo()


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), **tol)


#: both regimes of scaled_matmul and the boundary between them (M <= 16
#: streams w, above runs 3xTF32 on the tensor cores), against K and N
#: that are aligned to 16 bytes and that are not, one K slice and many
SMM_SHAPES = [(3, 100, 72), (70, 257, 130)] + [
    (m, k, n) for m in (1, 4, 16, 17, 64, 512)
    for k, n in ((100, 72), (257, 130), (24, 136), (512, 384))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pre,post,bias",
                         list(itertools.product([False, True], repeat=3)))
@pytest.mark.parametrize("m,k,n", SMM_SHAPES)
def test_scaled_matmul(dev, m, k, n, pre, post, bias, dtype):
    g = torch.Generator(device=dev).manual_seed(m + k + n)

    def r(*s):
        return torch.randn(s, generator=g, device=dev)

    x = r(m, k).to(dtype)
    w = r(k, n) / k ** 0.5
    vec = dict(pre=r(k) if pre else None, post=r(n) if post else None,
               bias=r(n) if bias else None)
    got = smm_mod.scaled_matmul(x, w, **vec)
    want = ref.scaled_matmul_ref(x, w, **vec)
    assert got.dtype == dtype
    _close(got, want, BF16 if dtype == torch.bfloat16 else F32)


@pytest.mark.parametrize("regime", ["stream", "tc"])
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (16, 257, 130),
                                   (17, 2048, 384), (64, 6144, 256),
                                   (512, 1024, 512)])
def test_scaled_matmul_both_regimes_repeat_bitwise(dev, m, k, n, regime):
    # each design at each shape (the plan picks one; the other is forced):
    # right, and the same bits on a repeat (fixed split order, no atomics)
    g = torch.Generator(device=dev).manual_seed(m * k + n)
    x = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
    pre = 1 + 0.061 * torch.randn(k, generator=g, device=dev)
    bias = torch.randn(n, generator=g, device=dev)
    planner = smm_mod.plan_stream if regime == "stream" else smm_mod.plan_tc
    p = planner(m, n, k, x.dtype)
    before = smm_mod.launches
    got = smm_mod.launch(x, w, pre, None, bias, p)
    assert smm_mod.launches == before + 1   # one call, whatever it launched
    _close(got, ref.scaled_matmul_ref(x, w, pre, None, bias), F32)
    assert torch.equal(got, smm_mod.launch(x, w, pre, None, bias, p))


@pytest.mark.parametrize("m", [4, 16, 17, 64, 512])
def test_scaled_matmul_bf16_x_sums_as_fp32_x(dev, m):
    # bf16 x is widened exactly, so its sums are those of fp32 x holding
    # the same values: the bf16 output is the fp32 output rounded, to the
    # bit, in both regimes
    n = 2048
    g = torch.Generator(device=dev).manual_seed(m + 1)
    x = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(n, n, generator=g, device=dev) / n ** 0.5
    pre = 1 + 0.061 * torch.randn(n, generator=g, device=dev)
    got = smm_mod.scaled_matmul(x, w, pre=pre)
    want = smm_mod.scaled_matmul(x.float(), w, pre=pre).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [4, 16, 64, 512])
def test_scaled_matmul_fp32_error_within_cublas(dev, m):
    # K = 6144 (the full-width d_ff): the kernel's fp32 error against an
    # fp64 product, relative to max |y|, within 2 x cuBLAS fp32's
    from repro_torch.core import families as fam_mod

    n = 6144
    c, _ = fam_mod.get_family("acdc").matrices(n, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn(m, n, generator=g, device=dev)
    pre = 1 + 0.061 * torch.randn(n, generator=g, device=dev)
    y64 = (x.double() * pre.double()) @ c.double()
    scale = float(y64.abs().max())
    err = {name: float((fn(x, c, pre=pre).double() - y64).abs().max())
           / scale for name, fn in (("kernel", smm_mod.scaled_matmul),
                                    ("cublas", ref.scaled_matmul_ref))}
    assert err["kernel"] <= 2 * err["cublas"], err


def _cascade_case(dev, m, n, k, relu, permute, bias, family):
    fam = families.get_family(family)
    c, ct = fam.matrices(n, torch.float32, dev)
    mid = ct[:, torch.as_tensor(fam.riffle(n), device=dev).long()] \
        if permute else None
    g = torch.Generator(device=dev).manual_seed(n + k)
    x = torch.randn(m, n, generator=g, device=dev)
    a = 1 + 0.061 * torch.randn(k, n, generator=g, device=dev)
    d = 1 + 0.061 * torch.randn(k, n, generator=g, device=dev)
    b = 0.1 * torch.randn(k, n, generator=g, device=dev) if bias else None
    return x, a, d, b, c, ct, mid


# M: ragged (37), one row, the decode tick (4), the train step (256); N:
# ragged column slices (100, 1000: 4-column multiples that S does not
# divide; 384: S = 12) beside the main path's and the largest
@pytest.mark.parametrize("m", [37, 1, 4, 256])
@pytest.mark.parametrize("n", [100, 128, 384, 1000, 1024])
@pytest.mark.parametrize("k,relu,permute,bias",
                         [(1, False, False, True), (2, True, True, False),
                          (3, True, True, True)])
@pytest.mark.parametrize("family", ["acdc", "circulant"])
def test_cascade(dev, m, n, k, relu, permute, bias, family):
    x, a, d, b, c, ct, mid = _cascade_case(dev, m, n, k, relu, permute,
                                           bias, family)
    got = cascade_mod.acdc_cascade(x, a, d, b, c, ct, mid, relu=relu)
    want = ref.acdc_cascade_ref(x, a, d, b, c, ct, mid, relu)
    _close(got, want, F32)
    # fixed summation order: the same bits on a repeat
    assert torch.equal(got, cascade_mod.acdc_cascade(x, a, d, b, c, ct, mid,
                                                     relu=relu))
    if k == 1:
        got1 = fused_mod.acdc_fused(x, a[0], d[0], None if b is None
                                    else b[0], c, ct)
        _close(got1, want, F32)


@pytest.mark.parametrize("m", [4, 37])
def test_cascade_deep(dev, m):
    # K = 24 at N = 1024: the streamed slices over 48 products
    x, a, d, b, c, ct, mid = _cascade_case(dev, m, 1024, 24, False, True,
                                           False, "acdc")
    got = cascade_mod.acdc_cascade(x, a, d, b, c, ct, mid)
    _close(got, ref.acdc_cascade_ref(x, a, d, b, c, ct, mid), F32)
    assert torch.equal(got, cascade_mod.acdc_cascade(x, a, d, b, c, ct, mid))


def _drift(got, want64):
    return float((got.double() - want64).abs().max()
                 / want64.abs().max())


@pytest.mark.parametrize("m,n", [(4, 128), (64, 256), (256, 256),
                                 (4, 1024), (512, 1024)])
def test_cascade_fp32_error_within_plain(dev, m, n):
    # the kernel's fp32 error against an fp64 cascade, relative to max |y|,
    # within 2 x the plain version's (cuBLAS fp32 products)
    x, a, d, _, c, ct, mid = _cascade_case(dev, m, n, 2, False, True,
                                           False, "acdc")
    h = x.double()
    for i, w in enumerate((mid, ct)):
        h = ((h * a[i].double()) @ c.double()) * d[i].double() @ w.double()
    err = {name: _drift(fn(x, a, d, None, c, ct, mid), h)
           for name, fn in (("kernel", cascade_mod.acdc_cascade),
                            ("plain", ref.acdc_cascade_ref))}
    assert err["kernel"] <= 2 * err["plain"], err


def test_cascade_plan_unschedulable_raises(dev):
    # a plan whose cluster the card cannot hold raises; there is no
    # fallback to another launch or to the plain version
    import dataclasses

    x, a, d, _, c, ct, mid = _cascade_case(dev, 4, 256, 2, False, True,
                                           False, "acdc")
    p = cascade_mod.plan(4, 256, 2, True)
    bad = dataclasses.replace(p, smem_bytes=p.smem_bytes + 4)
    with pytest.raises((ValueError, RuntimeError)):
        cascade_mod.launch_cascade(x, a, d, None, c, ct, mid, False, bad)


def _long_paged_case(dev, b, length, t, dtype, seed, hkv=8, group=2,
                     dh=128, bs=16):
    """Every slot at ``length`` with just enough pages, scattered over
    the pool; returns q, new k/v, pools, tables, positions."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)

    mb = -(-(length + t) // bs)
    nb = b * mb
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(seed))
    tables = perm.to(device=dev, dtype=torch.int32).reshape(b, mb)
    pos = torch.full((b,), length, device=dev, dtype=torch.int32)
    return (r(b, t, hkv * group, dh), r(b, t, hkv, dh), r(b, t, hkv, dh),
            r(nb + 1, bs, hkv, dh), r(nb + 1, bs, hkv, dh), tables, pos)


def _paged_pair(args, window=0, softcap=0.0, p=None):
    """(kernel out, plain out, pools equal) on one set of inputs; the
    kernel under plan ``p`` when given."""
    q, kn, vn, kp, vp, tables, pos = args
    kp2, vp2 = kp.clone(), vp.clone()
    if p is None:
        got = pa_mod.paged_attention(q, kn, vn, kp, vp, tables, pos, window,
                                     softcap=softcap)
    else:
        got = pa_mod.launch(q, kn, vn, kp, vp, tables, pos, window, softcap,
                            p)
    want = ref.paged_attention_ref(q, kn, vn, kp2, vp2, tables, pos, window,
                                   softcap)
    same = torch.equal(kp[:-1], kp2[:-1]) and torch.equal(vp[:-1], vp2[:-1])
    return got, want, same


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,window,softcap", [(1, 0, 0.0), (3, 6, 30.0),
                                              (5, 0, 0.0)])
def test_paged_attention(dev, t, window, softcap, dtype):
    b, hkv, group, dh, bs, mb = 4, 4, 2, 64, 4, 6
    nb = b * mb
    g = torch.Generator(device=dev).manual_seed(t)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)

    tables = torch.arange(nb, device=dev, dtype=torch.int32).reshape(b, mb)
    tables[0, 3:] = -1
    pos = torch.tensor([5, 0, 17, mb * bs], device=dev, dtype=torch.int32)
    q, kn, vn = r(b, t, hkv * group, dh), r(b, t, hkv, dh), r(b, t, hkv, dh)
    kp, vp = r(nb + 1, bs, hkv, dh), r(nb + 1, bs, hkv, dh)
    kp2, vp2 = kp.clone(), vp.clone()
    before = pa_mod.launches
    got = pa_mod.paged_attention(q, kn, vn, kp, vp, tables, pos, window,
                                 softcap=softcap)
    want = ref.paged_attention_ref(q, kn, vn, kp2, vp2, tables, pos, window,
                                   softcap)
    assert pa_mod.launches == before + 1
    _close(got, want, BF16 if dtype == torch.bfloat16 else F32)
    assert torch.equal(kp[:-1], kp2[:-1]) and torch.equal(vp[:-1], vp2[:-1])


# the long rows of chip_smoke.py (a - d) at fewer slots, one row of each
# shape: (slots, position, T)
LONG_ROWS = [(2, 4096, 1), (4, 1024, 1), (1, 16384, 1), (2, 4096, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,length,t", LONG_ROWS)
def test_paged_attention_long(dev, b, length, t, dtype):
    args = _long_paged_case(dev, b, length, t, dtype, b + length + t)
    before = pa_mod.launches
    got, want, same = _paged_pair(args)
    assert pa_mod.launches == before + 1
    _close(got, want, BF16 if dtype == torch.bfloat16 else F32)
    assert same
    # fixed merge orders: the same bits on a repeat
    assert torch.equal(got, _paged_pair(args)[0])


@pytest.mark.parametrize("window,softcap", [(1000, 0.0), (0, 30.0),
                                            (3000, 50.0)])
def test_paged_attention_long_window_softcap(dev, window, softcap):
    # a window skips whole splits before its start
    args = _long_paged_case(dev, 2, 4096, 3, torch.float32, window)
    got, want, same = _paged_pair(args, window, softcap)
    _close(got, want, F32)
    assert same


@pytest.mark.parametrize("b,length,t", LONG_ROWS)
def test_paged_combine_routes_agree_bitwise(dev, b, length, t):
    # the cluster combine and the workspace's second pass merge the same
    # split states in the same order: identical bits, and the plain
    # version's result
    args = _long_paged_case(dev, b, length, t, torch.bfloat16, length + t)
    q, _, _, kp, _, tables, _ = args
    base = pa_mod.plan_of(q, kp, tables)
    outs = []
    for cluster in (True, False):
        p = pa_mod.make_plan(b, 8, tables.shape[1], 16, 2, t, 128, 2, 4,
                             base.kt, cluster=cluster)
        assert p.route == ("cluster" if cluster else "two_pass")
        got, want, same = _paged_pair(args, p=p)
        _close(got, want, BF16)
        assert same
        outs.append(got)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("b,length,t", LONG_ROWS[:1] + LONG_ROWS[3:])
def test_paged_attention_fp32_error_within_plain(dev, b, length, t):
    # fp32 pools: the kernel's error against an fp64 attention, relative
    # to max |out|, within 2 x the plain version's
    args = _long_paged_case(dev, b, length, t, torch.float32, 7 * b + t)
    got, want, _ = _paged_pair(args)
    want64 = _paged_fp64(*args)
    err = {name: _drift(o, want64) for name, o in (("kernel", got),
                                                   ("plain", want))}
    assert err["kernel"] <= 2 * err["plain"], err


def _paged_fp64(q, kn, vn, kp, vp, tables, pos):
    """Attention of every slot (all at one position, no window or
    softcap) over its prefix and new tokens, in fp64."""
    b, t, hq, dh = q.shape
    hkv, bs = kn.shape[2], kp.shape[1]
    length = int(pos[0])
    kpos = torch.arange(length, device=q.device)
    pages = tables.long()[:, kpos // bs]
    keys = torch.cat([kp[pages, kpos % bs], kn], 1).double()  # (B, L+T, .)
    vals = torch.cat([vp[pages, kpos % bs], vn], 1).double()
    qg = q.double().reshape(b, t, hkv, hq // hkv, dh)
    s = torch.einsum("bthgd,bkhd->bhgtk", qg, keys) * dh ** -0.5
    causal = torch.arange(length + t, device=q.device)[None, :] \
        <= length + torch.arange(t, device=q.device)[:, None]
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhgtk,bkhd->bthgd", torch.softmax(s, -1), vals)
    return o.reshape(b, t, hq, dh)


def test_paged_smem_layout_matches_the_source(dev):
    from repro_torch.kernels import build

    fn = build.bind("paged_attn", "paged_attn_smem_bytes", [build.I32] * 6)
    for group, t in ((1, 1), (2, 1), (1, 3), (2, 2), (2, 5), (8, 2), (1, 16),
                     (8, 5), (16, 5), (16, 32), (7, 5)):
        for dh, item in ((16, 4), (48, 2), (64, 2), (128, 2), (128, 4)):
            for kt in (16, 32, 64, 128):
                for pps in (1, 6, 29, 1025):
                    rows = group * t
                    # every row block's CTAs are laid out for its rows
                    assert fn(rows, t, dh, item, kt, pps) == \
                        pa_mod.smem_bytes(pa_mod.block_rows(rows), t, dh,
                                          item, kt, pps)


def _bwd_inputs(dev, seed, m, n, k, dtype, bias, relu_mid=None):
    """x, g, a, d, bias; with ``relu_mid`` (the mid matrix of a ReLU
    cascade, with C) x is solved in fp64 so that the first layer's output
    lies at least 0.05 from 0: its ReLU mask cannot flip between kernel
    and plain version (fp32 sums in other orders), which would change one
    cotangent element by its whole value."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, device=dev)

    x, gy = r(m, n), r(m, n).to(dtype)
    a, d = 1 + 0.061 * r(k, n), 1 + 0.061 * r(k, n)
    b = 0.1 * r(k, n) if bias else None
    if relu_mid is not None:
        c, mid = relu_mid
        z = x.sign() * (0.05 + x.abs())
        h = z.double() @ mid.double().T
        if b is not None:
            h = h - b[0].double()
        x = ((h / d[0].double()) @ c.double().T / a[0].double()).float()
    return x.to(dtype), gy, a, d, b


def _close_grads(got, want, dtype):
    names = ("dx", "da", "dd", "db")
    for name, x, y in zip(names, got, want):
        assert (x is None) == (y is None), name
        if x is None:
            continue
        if name == "dx" and dtype == torch.bfloat16:
            _close(x, y, BF16)
            continue
        scale = max(float(y.abs().max()), 1.0)
        torch.testing.assert_close(x.float(), y.float(), rtol=1e-3,
                                   atol=2e-4 * scale, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,n", [(37, 128), (512, 256), (37, 384),
                                 (512, 1024), (256, 128), (256, 256),
                                 (4, 1024)])
def test_acdc_bwd(dev, m, n, bias, dtype):
    c, ct = families.get_family("acdc").matrices(n, torch.float32, dev)
    x, gy, a, d, _ = _bwd_inputs(dev, m + n, m, n, 1, dtype, False)
    before = (bwd_mod.launches, cbwd_mod.launches)
    got = bwd_mod.acdc_bwd(x, gy, a[0], d[0], c, ct, with_bias=bias)
    # its own count: the cascade backward's is not moved
    assert (bwd_mod.launches, cbwd_mod.launches) == (before[0] + 1,
                                                     before[1])
    want = ref.acdc_bwd_ref(x, gy, a[0], d[0], c, ct, bias)
    assert got[0].dtype == dtype
    _close_grads(got, want, dtype)
    again = bwd_mod.acdc_bwd(x, gy, a[0], d[0], c, ct, with_bias=bias)
    assert all(p is None or torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,relu,permute,bias",
                         [(2, False, False, False), (2, True, True, False),
                          (2, True, True, True), (2, True, False, True),
                          (3, False, False, True), (3, False, True, False)])
@pytest.mark.parametrize("m,n", [(37, 128), (512, 256), (512, 1024),
                                 (4, 256), (37, 100), (4, 100)])
def test_acdc_cascade_bwd(dev, m, n, k, relu, permute, bias, dtype):
    fam = families.get_family("acdc")
    c, ct = fam.matrices(n, torch.float32, dev)
    mid = ct[:, torch.as_tensor(fam.riffle(n), device=dev).long()] \
        .contiguous() if permute else None
    x, gy, a, d, b = _bwd_inputs(
        dev, m + n + k, m, n, k, dtype, bias,
        (c, ct if mid is None else mid) if relu else None)
    got = cbwd_mod.acdc_cascade_bwd(x, gy, a, d, b, c, ct, mid, relu=relu)
    want = ref.acdc_cascade_bwd_ref(x, gy, a, d, b, c, ct, mid, relu)
    assert got[0].dtype == dtype
    _close_grads(got, want, dtype)
    again = cbwd_mod.acdc_cascade_bwd(x, gy, a, d, b, c, ct, mid, relu=relu)
    assert all(p is None or torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("m", [4, 512])
def test_seamless_attn_out_cascade_forward_and_backward(dev, m):
    # Seamless-M4T's attn_out at full width (self, cross and encoder): N =
    # 1024, K = 2 with the riffle, at the decode tick (M = 4) and the
    # decoder's train step (M = 512); both gates pass, so the forward and
    # the backward are the whole-cascade kernels
    n, k = 1024, 2
    assert ops.cascade_route(n, k, permute=True, bias=False) == "cascade"
    assert ops.cascade_bwd_fits(n, k, permute=True, bias=False)
    x, a, d, _, c, ct, mid = _cascade_case(dev, m, n, k, False, True, False,
                                           "acdc")
    mid = mid.contiguous()
    got = cascade_mod.acdc_cascade(x, a, d, None, c, ct, mid)
    _close(got, ref.acdc_cascade_ref(x, a, d, None, c, ct, mid), F32)
    assert torch.equal(got, cascade_mod.acdc_cascade(x, a, d, None, c, ct,
                                                     mid))
    gy = torch.randn(m, n, generator=torch.Generator(device=dev)
                     .manual_seed(m), device=dev)
    grads = cbwd_mod.acdc_cascade_bwd(x, gy, a, d, None, c, ct, mid)
    _close_grads(grads, ref.acdc_cascade_bwd_ref(x, gy, a, d, None, c, ct,
                                                 mid), torch.float32)
    again = cbwd_mod.acdc_cascade_bwd(x, gy, a, d, None, c, ct, mid)
    assert all(p is None or torch.equal(p, q) for p, q in zip(grads, again))


@pytest.mark.parametrize("m,n", [(256, 128), (256, 256), (512, 1024)])
def test_acdc_bwd_fp32_error_within_plain(dev, m, n):
    # one layer is the K = 1 cascade: every gradient's fp32 error against
    # fp64 within 2 x the plain version's
    c, ct = families.get_family("acdc").matrices(n, torch.float32, dev)
    x, gy, a, d, _ = _bwd_inputs(dev, m + n + 1, m, n, 1, torch.float32,
                                 False)
    x64, g64, a64, d64 = (t.double() for t in (x, gy, a[0], d[0]))
    gc = g64 @ c.double()
    dh1 = (gc * d64) @ ct.double()
    want = (a64 * dh1, (x64 * dh1).sum(0),
            (((x64 * a64) @ c.double()) * gc).sum(0), gc.sum(0))
    err = {}
    for name, fn in (("kernel", bwd_mod.acdc_bwd), ("plain", ref.acdc_bwd_ref)):
        got = (fn(x, gy, a[0], d[0], c, ct, with_bias=True)
               if name == "kernel" else fn(x, gy, a[0], d[0], c, ct, True))
        err[name] = max(_drift(u, w) for u, w in zip(got, want))
    assert err["kernel"] <= 2 * err["plain"], err


def test_per_layer_cascade_backward_launches_acdc_bwd(dev):
    # N = 1024, K = 24 fails only the reverse sweep's gate: the cascade's
    # backward runs one acdc_bwd launch a layer
    n, k = 1024, 24
    assert ops.cascade_fits(n, k, permute=True, bias=False)
    assert not ops.cascade_bwd_fits(n, k, permute=True, bias=False)
    g = torch.Generator(device=dev).manual_seed(k)
    ts = [torch.randn(64, n, generator=g, device=dev).requires_grad_(),
          (1 + 0.061 * torch.randn(k, n, generator=g, device=dev))
          .requires_grad_(),
          (1 + 0.061 * torch.randn(k, n, generator=g, device=dev))
          .requires_grad_()]
    before = (bwd_mod.launches, cbwd_mod.launches)
    ops.acdc_cascade_op(*ts, permute=True).backward(
        torch.randn(64, n, generator=g, device=dev))
    assert (bwd_mod.launches - before[0], cbwd_mod.launches - before[1]) \
        == (k, 0)


def _cascade_bwd_fp64(x, g, a, d, c, ct, mid):
    """(dx, da, dd) of the riffled cascade without bias or ReLU, in fp64
    (``ref.acdc_cascade_bwd_ref``'s steps)."""
    k = a.shape[0]
    x, g, a, d, c, ct, mid = (t.double() for t in (x, g, a, d, c, ct, mid))
    hs = [x]
    for i in range(k - 1):
        hs.append((((hs[-1] * a[i]) @ c) * d[i]) @ mid)
    da, dd = torch.zeros_like(a), torch.zeros_like(d)
    gcur = g
    for i in range(k - 1, -1, -1):
        gc = gcur @ c if i == k - 1 else gcur @ mid.T
        dd[i] = (((hs[i] * a[i]) @ c) * gc).sum(0)
        dh1 = (gc * d[i]) @ ct
        da[i] = (hs[i] * dh1).sum(0)
        gcur = a[i] * dh1
    return gcur, da, dd


@pytest.mark.parametrize("m,n,k", [(256, 128, 2), (256, 256, 2),
                                   (256, 256, 3), (512, 1024, 2)])
def test_acdc_cascade_bwd_fp32_error_within_plain(dev, m, n, k):
    # every gradient's fp32 error against fp64 gradients, relative to its
    # max |.|, within 2 x the plain version's (the worst of dx, da, dd)
    fam = families.get_family("acdc")
    c, ct = fam.matrices(n, torch.float32, dev)
    mid = ct[:, torch.as_tensor(fam.riffle(n), device=dev).long()] \
        .contiguous()
    x, gy, a, d, _ = _bwd_inputs(dev, m + n + k, m, n, k, torch.float32,
                                 False)
    want = _cascade_bwd_fp64(x, gy, a, d, c, ct, mid)
    err = {}
    for name, fn in (("kernel", cbwd_mod.acdc_cascade_bwd),
                     ("plain", ref.acdc_cascade_bwd_ref)):
        got = fn(x, gy, a, d, None, c, ct, mid)
        err[name] = max(_drift(u, w.double()) for u, w in zip(got[:3],
                                                              want[:3]))
    assert err["kernel"] <= 2 * err["plain"], err


@pytest.mark.parametrize("n,k", [(256, 2), (1024, 24), (2048, 2)])
def test_autograd_through_cascade_op(dev, n, k):
    # reverse sweep, per-layer backward, two-call route: the card's
    # kernels against the CPU's plain versions, one backward each (no
    # ReLU, whose masks could flip between the two, see _bwd_inputs)
    g = torch.Generator(device=dev).manual_seed(n + k)
    leaves = [torch.randn(40, n, generator=g, device=dev),
              1 + 0.061 * torch.randn(k, n, generator=g, device=dev),
              1 + 0.061 * torch.randn(k, n, generator=g, device=dev)]
    gy = torch.randn(40, n, generator=g, device=dev)
    grads = []
    for where in (dev, torch.device("cpu")):
        ts = [t.detach().to(where).requires_grad_() for t in leaves]
        y = ops.acdc_cascade_op(*ts, permute=True)
        y.backward(gy.to(where))
        grads.append([t.grad.cpu() for t in ts])
    _close_grads(grads[0], grads[1], torch.float32)


#: grouped scaled_matmul (the MoE experts' two-call layers): (groups, rows
#: a group, K, N) in the weight stream (M <= 16) and on the tensor cores,
#: aligned to 16 bytes and not, one group a row (decode at cap 1) and
#: groups spanning tiles
GROUPED_SHAPES = [(4, 4, 256, 136), (8, 2, 100, 72), (3, 5, 2048, 2048),
                  (64, 1, 2048, 2048), (64, 7, 512, 384), (5, 13, 257, 130),
                  (6, 60, 256, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vectors", ["pre", "pre+bias", "pre+post+bias",
                                     "bias"])
@pytest.mark.parametrize("g,c,k,n", GROUPED_SHAPES)
def test_scaled_matmul_grouped(dev, g, c, k, n, vectors, dtype):
    gen = torch.Generator(device=dev).manual_seed(g * c + k + n)

    def r(*s):
        return torch.randn(s, generator=gen, device=dev)

    x = r(g * c, k).to(dtype)
    w = r(k, n) / k ** 0.5
    vec = {"pre": 1.0 + 0.06 * r(g, k), "post": 1.0 + 0.06 * r(g, n),
           "bias": r(g, n)}
    kw = {name: vec[name] for name in vectors.split("+")}
    before = smm_mod.launches
    got = smm_mod.scaled_matmul(x, w, **kw)
    assert smm_mod.launches == before + 1          # one launch, all groups
    want = ref.scaled_matmul_ref(x, w, **kw)
    _close(got, want, BF16 if dtype == torch.bfloat16 else F32)
    assert torch.equal(got, smm_mod.scaled_matmul(x, w, **kw))
    # each group as its own ungrouped call computes the same function
    for i in (0, g - 1):
        rows = slice(i * c, (i + 1) * c)
        one = smm_mod.scaled_matmul(x[rows], w,
                                    **{nm: v[i] for nm, v in kw.items()})
        _close(got[rows], one, BF16 if dtype == torch.bfloat16 else F32)


@pytest.mark.parametrize("n,k", [(2048, 2), (2816, 1), (256, 2)])
def test_grouped_cascade_autograd_matches_plain(dev, n, k):
    # the grouped cascade (two-call at N > 1024: grouped scaled_matmul;
    # the cascade kernels once a group below), forward and backward,
    # against the plain versions on the CPU
    gen = torch.Generator().manual_seed(n + k)
    g, c = 8, 5
    x = torch.randn(g, c, n, generator=gen)
    a = 1.0 + 0.06 * torch.randn(g, k, n, generator=gen)
    d = 1.0 + 0.06 * torch.randn(g, k, n, generator=gen)
    gy = torch.randn(g, c, n, generator=gen)
    outs = []
    for device in (dev, torch.device("cpu")):
        leaves = [t.to(device).requires_grad_(True) for t in (x, a, d)]
        y = ops.acdc_cascade_op(*leaves, permute=True)
        grads = torch.autograd.grad(y, leaves, gy.to(device))
        outs.append([y.detach().cpu()] + [t.cpu() for t in grads])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=2e-4 * float(
            want.abs().max()), rtol=1e-3)


#: group * T past one 16-row block: DeepSeek-67B (group 8) and
#: ChatGLM3-6B (group 16) at decode and verify T
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,t", [(8, 1), (8, 5), (8, 8), (16, 1),
                                     (16, 5), (16, 8), (7, 5)])
def test_paged_attention_row_blocks(dev, group, t, dtype):
    hkv = 4 if group < 16 else 2
    args = _long_paged_case(dev, 3, 700, t, dtype, group * t, hkv=hkv,
                            group=group)
    for window, softcap in ((0, 0.0), (300, 30.0)):
        got, want, same = _paged_pair(args, window, softcap)
        _close(got, want, BF16 if dtype == torch.bfloat16 else F32)
        assert same
        assert torch.equal(got, _paged_pair(args, window, softcap)[0])
    # every split route of the row blocks: one split, the workspace
    q, _, _, kp, _, tables, _ = args
    base = pa_mod.plan_of(q, kp, tables)
    for splits in (1, 5):
        p = pa_mod.make_plan(3, hkv, tables.shape[1], 16, group, t, 128,
                             kp.element_size(), splits, base.kt)
        got, want, same = _paged_pair(args, p=p)
        _close(got, want, BF16 if dtype == torch.bfloat16 else F32)
        assert same


#: the recurrent families' and LLaVA-NeXT's operating sizes (K = N after
#: the 128-lane padding): Mamba2's ssm_in 8576 and Zamba2's 8448 (not
#: multiples of 256: the vector paths and the split-K slices must cover
#: the tail), ssm_out / shared_in 4096, Zamba2's MLP 8192, LLaVA's
#: attn_out 7168 and MLP 20480; M = 4 (decode), 20 (a 4-slot verify at
#: k = 4) and 64 (a prefill) in bf16, and 512 in fp32 (the training step)
SLICE_SMM = [(4, 8576), (20, 8576), (64, 8576), (512, 8576), (4, 8448),
             (20, 8448), (4, 4096), (4, 8192), (4, 7168), (4, 20480)]


@pytest.mark.parametrize("m,n", SLICE_SMM)
def test_scaled_matmul_slice_shapes(dev, m, n):
    g = torch.Generator(device=dev).manual_seed(m + n)
    dtype = torch.float32 if m == 512 else torch.bfloat16
    c, _ = families.get_family("acdc").matrices(n, torch.float32, dev)
    x = torch.randn((m, n), generator=g, device=dev).to(dtype)
    pre = 1.0 + 0.061 * torch.randn((n,), generator=g, device=dev)
    got = smm_mod.scaled_matmul(x, c, pre=pre)
    want = ref.scaled_matmul_ref(x, c, pre=pre)
    _close(got, want, BF16 if dtype == torch.bfloat16 else F32)
    assert torch.equal(got, smm_mod.scaled_matmul(x, c, pre=pre))


#: the smoke Mamba2 / Zamba2 ssm_in's operating size N = 640 through the
#: cascade (K = 2, the riffle), the fused K = 1 layer and both backwards
@pytest.mark.parametrize("m", [4, 64, 256])
def test_cascade_kernels_at_n640(dev, m):
    n = 640
    g = torch.Generator(device=dev).manual_seed(m)

    def r(*s):
        return torch.randn(s, generator=g, device=dev)

    fam = families.get_family("acdc")
    c, ct = fam.matrices(n, torch.float32, dev)
    perm = torch.as_tensor(fam.riffle(n), dtype=torch.long, device=dev)
    mid = ct[:, perm].contiguous()
    x, gy = r(m, n), r(m, n)
    a, d = 1.0 + 0.061 * r(2, n), 1.0 + 0.061 * r(2, n)
    _close(cascade_mod.acdc_cascade(x, a, d, None, c, ct, mid),
           ref.acdc_cascade_ref(x, a, d, None, c, ct, mid), F32)
    _close(fused_mod.acdc_fused(x, a[0], d[0], None, c, ct),
           ref.acdc_cascade_ref(x, a[:1], d[:1], None, c, ct, None), F32)
    _close_grads(cbwd_mod.acdc_cascade_bwd(x, gy, a, d, None, c, ct, mid),
                 ref.acdc_cascade_bwd_ref(x, gy, a, d, None, c, ct, mid,
                                          False), torch.float32)
    _close_grads(bwd_mod.acdc_bwd(x, gy, a[0], d[0], c, ct, with_bias=False),
                 ref.acdc_bwd_ref(x, gy, a[0], d[0], c, ct, False),
                 torch.float32)


#: Zamba2's shared attention: group 1 (32 query and KV heads of 64 dims at
#: full width, 8 of 16 at smoke) at decode (T = 1) and verify (T = 5)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,dh", [(32, 64), (8, 16)])
@pytest.mark.parametrize("t", [1, 5])
def test_paged_attention_group_one(dev, hkv, dh, t, dtype):
    args = _long_paged_case(dev, 4, 80, t, dtype, hkv + t, hkv=hkv,
                            group=1, dh=dh)
    got, want, same = _paged_pair(args)
    _close(got, want, BF16 if dtype == torch.bfloat16 else F32)
    assert same
    assert torch.equal(got, _paged_pair(args)[0])


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099, 1 << 20])
def test_quantize_int8_on_the_card_equals_the_cpu(dev, n):
    """The int8 gradient quantizer (plain PyTorch, no kernel of its own)
    gives the CPU's ``q`` and ``scale`` bit for bit on the card, and the
    compressed all-reduce over no group the CPU's transmitted values."""
    from repro_torch.dist import compression

    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=gen) * 10.0 ** torch.randint(
        -20, 20, (n,), generator=gen).float()
    x[::97] = 0.0
    q, s = compression.quantize_int8(x)
    qd, sd = compression.quantize_int8(x.to(dev))
    assert torch.equal(qd.cpu(), q) and torch.equal(sd.cpu(), s)
    e = 1e-3 * torch.randn(n, generator=gen)
    x[::101] = float("inf")
    ghat, new_e = compression.compressed_all_reduce(x, e)
    ghat_d, new_e_d = compression.compressed_all_reduce(x.to(dev), e.to(dev))
    assert torch.equal(ghat_d.cpu(), ghat)
    flat = torch.where(torch.isfinite(x + e), x + e, 0.0)
    torch.testing.assert_close(new_e_d.cpu(), new_e, rtol=0,
                               atol=2 * float(torch.finfo(torch.float32).eps
                                              * flat.abs().max()))


@pytest.mark.parametrize("n", [256, 2048, 6144])
def test_dct_matrices_on_the_card_match_numpy(dev, n):
    """The DCT pair computed on the card (the same float64 operations as
    the numpy build, only ``cos`` the card's) rounds to the CPU's fp32
    matrices but for at most one ulp at a few entries; C^-1 is C^T bit
    for bit."""
    import numpy as np

    from repro_torch.core import transforms

    c = transforms.dct_matrix(n, torch.float32, dev).cpu()
    ct = transforms.idct_matrix(n, torch.float32, dev).cpu()
    want = torch.from_numpy(transforms._dct_matrix_np(n)).float()
    assert torch.equal(ct, c.t())
    ulp = torch.from_numpy(np.spacing(want.abs().numpy()))
    diff = (c - want).abs()
    assert (diff <= ulp).all(), float((diff / ulp).max())
    differ = int((diff > 0).sum())
    print(f"dct_matrix({n}) on the card: {differ} of {n * n} fp32 entries "
          f"one ulp from numpy's")
    assert differ <= max(4, n * n // 10 ** 6)


#: one small key of each autotuned direction: (direction, dims, permute)
AUTOTUNE_KEYS = [("fwd", (37, 256, 1), False), ("bwd", (37, 256, 1), False),
                 ("cascade", (64, 256, 2), True),
                 ("cascade_bwd", (64, 256, 2), True),
                 ("paged_attn", (2, 2, 3, 16, 2, 5, 64, 4), False)]


def _plan_vs_plain(dev, direction, dims, permute, p):
    """Run plan ``p`` at ``dims`` on random inputs (ragged rows past the
    bucket's) against the plain version, twice for identical bits."""
    g = torch.Generator(device=dev).manual_seed(11)

    def r(*s):
        return torch.randn(s, generator=g, device=dev)

    if direction == "paged_attn":
        b, hkv, mb, bs, group, t, dh, _ = dims
        args = _long_paged_case(dev, b, mb * bs - t, t, torch.float32, 5,
                                hkv=hkv, group=group, dh=dh, bs=bs)
        got, want, same = _paged_pair(args, p=p)
        _close(got, want, F32)
        assert same and torch.equal(got, _paged_pair(args, p=p)[0])
        return
    m, n, k = dims
    fam = families.get_family("acdc")
    c, ct = fam.matrices(n, torch.float32, dev)
    mid = None
    if permute and k > 1:
        perm = torch.as_tensor(fam.riffle(n), dtype=torch.long, device=dev)
        mid = ct[:, perm].contiguous()
    x, a, d = r(m, n), 1.0 + 0.061 * r(k, n), 1.0 + 0.061 * r(k, n)
    if direction in ("fwd", "cascade"):
        got = cascade_mod.launch_cascade(x, a, d, None, c, ct, mid, False, p)
        _close(got, ref.acdc_cascade_ref(x, a, d, None, c, ct, mid), F32)
        assert torch.equal(got, cascade_mod.launch_cascade(
            x, a, d, None, c, ct, mid, False, p))
        return
    gy = r(m, n)
    got = cbwd_mod.launch_bwd(x, gy, a, d, None, c, ct, mid, False, p)
    _close_grads(got, ref.acdc_cascade_bwd_ref(x, gy, a, d, None, c, ct, mid,
                                               False), torch.float32)
    again = cbwd_mod.launch_bwd(x, gy, a, d, None, c, ct, mid, False, p)
    assert all(u is None or torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.parametrize("direction,dims,permute", AUTOTUNE_KEYS)
def test_autotune_sweeps_persists_and_reloads(dev, tmp_path, monkeypatch,
                                              direction, dims, permute):
    """A key's first call on the card sweeps once (no wrapper launch
    counted); the winner is held against the plain version at the call's
    own M, lands in the file, and a fresh memo reads it back without a
    sweep."""
    monkeypatch.setenv(autotune.CACHE_ENV + "_PATH",
                       str(tmp_path / "cache.json"))
    for name, value in (("_CACHE", {}), ("_PERSIST_LOADED", set()),
                        ("SWEEPS", [])):
        monkeypatch.setattr(autotune, name, value)
    counts = [mod.launches for mod in (cascade_mod, fused_mod, bwd_mod,
                                       cbwd_mod, pa_mod)]
    before = autotune.totals()[0]
    p = autotune.autotuned_plan(direction, *dims, device=dev,
                                permute=permute)
    assert autotune.totals()[0] == before + 1
    rec = autotune.SWEEPS[-1]
    assert rec.winner_s <= rec.cost_model_s
    assert counts == [mod.launches for mod in (cascade_mod, fused_mod,
                                               bwd_mod, cbwd_mod, pa_mod)]
    _plan_vs_plain(dev, direction, dims, permute, p)
    assert (tmp_path / "cache.json").exists()
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_PERSIST_LOADED", set())
    assert autotune.autotuned_plan(direction, *dims, device=dev,
                                   permute=permute) == p
    assert autotune.totals()[0] == before + 1


def test_placed_step_equals_replicated_on_a_world_of_one(dev, tmp_path):
    """Smoke Qwen3-1.7B (the cascade kernels at N = 128 / 256) trained
    two steps with its state placed at rest on a world-of-one NCCL (1, 1)
    mesh: every leaf spec'd over a size-1 axis is gathered, its gradient
    reduce-scattered, the norm reduced, and the step equals the
    replicated one bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import steps
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import SELL_GROUPS
    from repro_torch.models import get_model
    from repro_torch.optim import optimizers as opt_mod
    from repro_torch.optim import schedules

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_host_mesh(1, "cuda")
        cfg = registry.with_sell(registry.get_smoke_config("qwen3_1_7b"),
                                 "acdc", method="pallas")
        model = get_model(cfg)
        opt = opt_mod.make_optimizer(
            opt_mod.OptimizerConfig(kind="adamw", lr=3e-3,
                                    groups=SELL_GROUPS),
            schedules.cosine_schedule(3e-3, 1, 6))
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=4))
        out = {}
        for side, m in (("replicated", None), ("placed", mesh)):
            gen = torch.Generator(device=dev).manual_seed(0)
            state = steps.init_state(model, cfg, opt, gen, dev, mesh=m)
            step = steps.make_train_step(model, cfg, opt,
                                         group=mesh.get_group("data"),
                                         mesh=m)
            before = cbwd_mod.launches
            mets = []
            for s in range(2):
                batch = {k: t.to(dev) for k, t in data.batch_at(s).items()}
                state, met = step(state, batch)
                mets.append([float(met[k]) for k in sorted(met)])
            out[side] = (mets, cbwd_mod.launches - before,
                         opt_mod.tree_flatten({k: state[k]
                                               for k in ("params", "opt")}))
        (rm, rn, (rp, rl)), (pm, pn, (pp, pl)) = (out["replicated"],
                                                  out["placed"])
        assert rm == pm and rn == pn == 24 and rp == pp
        assert all(torch.equal(a, b) for a, b in zip(rl, pl))
    finally:
        mesh_mod.shutdown()
