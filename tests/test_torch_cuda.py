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


@pytest.mark.parametrize("n", [128, 384, 1024])
@pytest.mark.parametrize("k,relu,permute,bias",
                         [(1, False, False, True), (2, True, True, False),
                          (3, True, True, True)])
@pytest.mark.parametrize("family", ["acdc", "circulant"])
def test_cascade(dev, n, k, relu, permute, bias, family):
    fam = families.get_family(family)
    c, ct = fam.matrices(n, torch.float32, dev)
    mid = ct[:, torch.as_tensor(fam.riffle(n), device=dev).long()] \
        if permute else None
    g = torch.Generator(device=dev).manual_seed(n + k)
    x = torch.randn(37, n, generator=g, device=dev)
    a = 1 + 0.061 * torch.randn(k, n, generator=g, device=dev)
    d = 1 + 0.061 * torch.randn(k, n, generator=g, device=dev)
    b = 0.1 * torch.randn(k, n, generator=g, device=dev) if bias else None
    got = cascade_mod.acdc_cascade(x, a, d, b, c, ct, mid, relu=relu)
    want = ref.acdc_cascade_ref(x, a, d, b, c, ct, mid, relu)
    _close(got, want, F32)
    if k == 1:
        got1 = fused_mod.acdc_fused(x, a[0], d[0], None if b is None
                                    else b[0], c, ct)
        _close(got1, want, F32)


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
                                 (512, 1024)])
def test_acdc_bwd(dev, m, n, bias, dtype):
    c, ct = families.get_family("acdc").matrices(n, torch.float32, dev)
    x, gy, a, d, _ = _bwd_inputs(dev, m + n, m, n, 1, dtype, False)
    got = bwd_mod.acdc_bwd(x, gy, a[0], d[0], c, ct, with_bias=bias)
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
@pytest.mark.parametrize("m,n", [(37, 128), (512, 256), (512, 1024)])
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
