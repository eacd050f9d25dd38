"""Port parity, fast transforms: ``repro_torch.core.transforms`` and the
families' ``apply``/``inverse`` against the live JAX reference.

Inputs are made with numpy from a seed and handed to both packages.
Every fast transform (``dct``, ``idct``, ``real_fft``, ``real_ifft``,
``fwht``, the ``*_via_matmul`` forms) is held against the reference's
function AND against its explicit matrix, at N in {6, 7, 128, 384}
(``fwht`` at powers of two), forward and ``torch.autograd`` gradients
against ``jax.vjp``; the Makhoul permutations are exact.  Tolerance: fp32
atol 2e-4, rtol 1e-3 (tests/test_kernel_grads.py:248); bf16 atol 5e-2,
rtol 2^-6 (tests/test_torch_cascade.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import families as jfam
from repro.core import transforms as jtr
from repro_torch.core import families as tfam
from repro_torch.core import transforms as ttr

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-4, rtol=1e-3)
BF16 = dict(atol=5e-2, rtol=2 ** -6)
SIZES = [6, 7, 128, 384]
POW2 = [8, 128, 256]

#: (fast transform, its explicit matrix)
PAIRS = {
    "dct": ("dct_matrix", SIZES),
    "idct": ("idct_matrix", SIZES),
    "real_fft": ("real_fft_matrix", SIZES),
    "real_ifft": ("real_ifft_matrix", SIZES),
    "fwht": ("hadamard_matrix", POW2),
    "dct_via_matmul": ("dct_matrix", SIZES),
    "idct_via_matmul": ("idct_matrix", SIZES),
}

CASES = [(name, n) for name, (_, ns) in PAIRS.items() for n in ns]


def _x(n, rows=(3, 5), seed=0):
    rs = np.random.RandomState(seed + n)
    return rs.randn(*rows, n).astype(np.float32)


@pytest.mark.parametrize("name,n", CASES)
def test_fast_transform_matches_reference_and_matrix(name, n):
    x = _x(n)
    want = np.asarray(jax.jit(getattr(jtr, name))(jnp.asarray(x)))
    got = getattr(ttr, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    mat = getattr(ttr, PAIRS[name][0])(n, torch.float32, "cpu")
    np.testing.assert_allclose(got.numpy(), x @ mat.numpy(), **TOL)


@pytest.mark.parametrize("name,n", [c for c in CASES
                                    if not c[0].endswith("via_matmul")])
def test_fast_transform_grads_match_reference(name, n):
    x = _x(n, seed=1)
    g = _x(n, seed=2)
    _, vjp = jax.vjp(jax.jit(getattr(jtr, name)), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    (getattr(ttr, name)(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", SIZES)
def test_makhoul_permutations_exact(n):
    x = _x(n)
    v = ttr._makhoul_permute(torch.from_numpy(x))
    assert np.array_equal(v.numpy(),
                          np.asarray(jtr._makhoul_permute(jnp.asarray(x))))
    back = ttr._makhoul_unpermute(v)
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(
        back.numpy(),
        np.asarray(jtr._makhoul_unpermute(jnp.asarray(v.numpy()))))


@pytest.mark.parametrize("name", ["dct", "idct", "real_fft", "real_ifft",
                                  "fwht"])
def test_bf16_in_bf16_out(name):
    n = 128
    x = _x(n)
    want = jax.jit(getattr(jtr, name))(jnp.asarray(x, jnp.bfloat16))
    got = getattr(ttr, name)(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("n", [6, 384])
def test_round_trips_are_identity(n):
    x = torch.from_numpy(_x(n))
    for fwd, inv in (("dct", "idct"), ("real_fft", "real_ifft")):
        back = getattr(ttr, inv)(getattr(ttr, fwd)(x))
        np.testing.assert_allclose(back.numpy(), x.numpy(), **TOL)


def test_fwht_refuses_non_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        ttr.fwht(torch.zeros(2, 12))
    with pytest.raises(ValueError):
        jtr.fwht(jnp.zeros((2, 12)))


@pytest.mark.parametrize("family", ["acdc", "circulant", "hadamard"])
def test_family_fast_pair_wired_like_reference(family):
    jf, tf = jfam.get_family(family), tfam.get_family(family)
    assert tf.complex_diagonals is jf.complex_diagonals is False
    for attr in ("apply", "inverse"):
        assert getattr(tf, attr).__name__ == getattr(jf, attr).__name__
    n = 128
    x = _x(n)
    c, ct = tf.matrices(n, torch.float32, "cpu")
    y = tf.apply(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), x @ c.numpy(), **TOL)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jf.apply(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tf.inverse(y).numpy(), x, **TOL)
    np.testing.assert_allclose(
        tf.inverse(y).numpy(),
        np.asarray(jf.inverse(jnp.asarray(y.numpy()))), **TOL)


def test_device_constants_made_once():
    """A transform's constants are made once per (n, dtype, device): a
    second call hands back the same tensor (no new host-to-device copy)."""
    a = ttr.dct_matrix(128, torch.float32, "cpu")
    assert ttr.dct_matrix(128, torch.float32, "cpu") is a
    assert ttr.dct_matrix(128, torch.bfloat16, "cpu") is not a
    idx = ttr.constant(ttr._makhoul_index, 384, torch.long, "cpu")
    assert ttr.constant(ttr._makhoul_index, 384, torch.long,
                        torch.device("cpu")) is idx
    assert set(ttr.__all__) == set(jtr.__all__)
