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
"""

import itertools

import pytest
import torch

from repro_torch.core import families
from repro_torch.kernels import acdc_cascade_fused as cascade_mod
from repro_torch.kernels import acdc_fused as fused_mod
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pre,post,bias",
                         list(itertools.product([False, True], repeat=3)))
@pytest.mark.parametrize("m,k,n", [(3, 100, 72), (70, 257, 130)])
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
