"""Orthonormal fast transforms used by SELL layers.

Port of :mod:`repro.core.transforms`.  The DCT-II / DCT-III pair, the
real-DFT basis and the normalized Walsh-Hadamard transform, each in two
interchangeable forms:

* the explicit ``N x N`` orthonormal matrices (``dct_matrix``,
  ``real_fft_matrix``, ``hadamard_matrix`` and their inverses), built by
  the SAME float64 numpy code as the reference and rounded to the
  requested dtype, so the fp32 operands match the reference bit for bit;
  on a CUDA device the DCT pair is computed there instead, by the same
  float64 operations in the same order (a 22016-point pair took tens of
  seconds of host time through numpy): only ``cos`` differs, the card's
  float64 one, so an entry of a large matrix can round to the
  neighbouring fp32 value (tests/test_torch_cuda.py counts them);
  ``dct_via_matmul`` / ``idct_via_matmul`` multiply by them;
* the O(N log N) transforms over ``torch.fft``: ``dct`` / ``idct``
  (Makhoul's even permutation), ``real_fft`` / ``real_ifft`` and ``fwht``.
  ``torch.fft`` has no bf16, so ``dct``/``idct``/``real_fft``/``real_ifft``
  compute in fp32 (fp64 for fp64 input) and cast the result back to the
  input dtype, as the reference does; ``fwht`` works in the input dtype.

Every constant a transform needs on the device (the matrices, the
Makhoul and spectrum index tensors, the twiddles and scales) is made once
per ``(n, dtype, device)`` by :func:`constant` and shared read-only, so a
projection issues no host-to-device copy.  The reference's slice, flip
and scatter permutations are one gather each with a cached index: the
same values, fewer launches.

All transforms act on the LAST axis, use the row-vector convention
``y = x @ C`` and satisfy ``C^-1 = C^T``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE

__all__ = [
    "dct_matrix",
    "idct_matrix",
    "dct",
    "idct",
    "dct_via_matmul",
    "idct_via_matmul",
    "real_fft_matrix",
    "real_ifft_matrix",
    "real_fft",
    "real_ifft",
    "hadamard_matrix",
    "fwht",
    "make_riffle",
    "invert_permutation",
]


@functools.lru_cache(maxsize=256)
def _constant(build: Callable[[int], np.ndarray], n: int, dtype,
              device: torch.device) -> torch.Tensor:
    # float64 -> float32 rounds to nearest, exactly like jnp.asarray(...,
    # dtype=float32) in the reference
    return torch.from_numpy(np.ascontiguousarray(build(n))).to(
        device=device, dtype=dtype)


def constant(build: Callable[[int], np.ndarray], n: int, dtype,
             device=DEFAULT_DEVICE) -> torch.Tensor:
    """``build(n)`` (a numpy array) as a ``dtype`` tensor on ``device``,
    made once per key and shared: callers must not write to it."""
    return _constant(build, n, dtype, torch.device(device))


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype an FFT-based transform computes in: fp32, or fp64
    for fp64 input (which the reference, without x64, never sees)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _complex(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


# ---------------------------------------------------------------------------
# Explicit DCT matrices (paper eq. 9, orthonormal convention).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix as float64 numpy (paper eq. 9)."""
    k = np.arange(n)[None, :]          # frequency index
    m = np.arange(n)[None, :].T        # sample index
    mat = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    mat *= np.sqrt(2.0 / n)
    mat[:, 0] *= 1.0 / np.sqrt(2.0)    # eps_0 = 1/sqrt(2)
    return mat  # (n_in, n_freq): y = x @ mat  is the DCT-II of x


def _idct_matrix_np(n: int) -> np.ndarray:
    return _dct_matrix_np(n).T


@functools.lru_cache(maxsize=256)
def _dct_matrix_cuda(n: int, dtype, device: torch.device) -> torch.Tensor:
    """:func:`_dct_matrix_np` computed on a CUDA ``device`` in float64, a
    block of rows at a time (~128 MB of float64 a temporary), each block
    rounded to ``dtype``; cached as :func:`constant` caches."""
    out = torch.empty((n, n), dtype=dtype, device=device)
    k = torch.arange(n, dtype=torch.float64, device=device)[None, :]
    # a divisor on the device: CUDA divides by a host scalar through its
    # reciprocal, which rounds the angle differently from numpy
    two_n = torch.tensor(2.0 * n, dtype=torch.float64, device=device)
    rows = max(1, (1 << 24) // n)
    for lo in range(0, n, rows):
        m = torch.arange(lo, min(lo + rows, n), dtype=torch.float64,
                         device=device)[:, None]
        blk = torch.cos(math.pi * (2.0 * m + 1.0) * k / two_n)
        blk *= math.sqrt(2.0 / n)
        blk[:, 0] *= 1.0 / math.sqrt(2.0)
        out[lo:lo + blk.shape[0]] = blk
    return out


@functools.lru_cache(maxsize=256)
def _idct_matrix_cuda(n: int, dtype, device: torch.device) -> torch.Tensor:
    return _dct_matrix_cuda(n, dtype, device).t().contiguous()


def dct_matrix(n: int, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> torch.Tensor:
    """Orthonormal DCT-II matrix ``C`` with ``y = x @ C``; ``C^-1 = C.T``
    (cached: do not write to it)."""
    device = torch.device(device)
    if device.type == "cuda":
        return _dct_matrix_cuda(n, dtype, device)
    return constant(_dct_matrix_np, n, dtype, device)


def idct_matrix(n: int, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> torch.Tensor:
    """Inverse (DCT-III) matrix, the transpose of :func:`dct_matrix`."""
    device = torch.device(device)
    if device.type == "cuda":
        return _idct_matrix_cuda(n, dtype, device)
    return constant(_idct_matrix_np, n, dtype, device)


def dct_via_matmul(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """DCT-II along the last axis via a dense matmul."""
    return torch.matmul(x, dct_matrix(x.shape[-1], dtype or x.dtype,
                                      x.device))


def idct_via_matmul(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    return torch.matmul(x, idct_matrix(x.shape[-1], dtype or x.dtype,
                                       x.device))


# ---------------------------------------------------------------------------
# FFT-based DCT (Makhoul 1980) -- the O(N log N) path.
# ---------------------------------------------------------------------------

def _makhoul_index(n: int) -> np.ndarray:
    """v = x[idx]: v[j] = x[2j] for j < ceil(N/2), v[N-1-j] = x[2j+1]."""
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)[::-1]])


def _makhoul_inverse_index(n: int) -> np.ndarray:
    return invert_permutation(_makhoul_index(n))


def _makhoul_permute(x: torch.Tensor) -> torch.Tensor:
    """The reference's slice-flip-concat as one gather."""
    idx = constant(_makhoul_index, x.shape[-1], torch.long, x.device)
    return torch.index_select(x, -1, idx)


def _makhoul_unpermute(v: torch.Tensor) -> torch.Tensor:
    """The reference's two scatters as one gather (the inverse index)."""
    idx = constant(_makhoul_inverse_index, v.shape[-1], torch.long, v.device)
    return torch.index_select(v, -1, idx)


def _dct_twiddle(n: int) -> np.ndarray:
    # W = 2 exp(-i pi k / 2N): Re(W * V) is 2x the unnormalised DCT-II
    return 2.0 * np.exp(-1j * np.pi * np.arange(n) / (2.0 * n))


def _dct_scale(n: int) -> np.ndarray:
    # orthonormal scaling of un = 2X: sqrt(2/N) eps_k / 2, eps_0 = 1/sqrt 2
    s = np.full((n,), 0.5 * np.sqrt(2.0 / n))
    s[0] = 0.5 * np.sqrt(1.0 / n)
    return s


def _idct_scale(n: int) -> np.ndarray:
    return 1.0 / _dct_scale(n)


def _idct_twiddle(n: int) -> np.ndarray:
    # 0.5 * exp(i pi k / 2N), the factor rebuilding V from un
    return 0.5 * np.exp(1j * np.pi * np.arange(n) / (2.0 * n))


def _flip_tail_index(n: int) -> np.ndarray:
    """un_flip = un[idx] * mask: [0, un[N-1], ..., un[1]]."""
    return np.concatenate([[0], np.arange(n - 1, 0, -1)])


def _flip_tail_mask(n: int) -> np.ndarray:
    m = np.ones((n,))
    m[0] = 0.0
    return m


def dct(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis, O(N log N) via the FFT.

    Matches ``x @ dct_matrix(N)`` to float tolerance."""
    n, dev = x.shape[-1], x.device
    wd = work_dtype(x.dtype)
    v = _makhoul_permute(x.to(wd))
    vf = torch.fft.fft(v, dim=-1)
    un = (vf * constant(_dct_twiddle, n, _complex(wd), dev)).real
    return (un * constant(_dct_scale, n, wd, dev)).to(x.dtype)


def idct(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-III (inverse of :func:`dct`) along the last axis."""
    n, dev = y.shape[-1], y.device
    wd = work_dtype(y.dtype)
    # undo the orthonormal scaling back to the un[k] = 2 X[k] spectrum
    un = y.to(wd) * constant(_idct_scale, n, wd, dev)
    un_flip = (torch.index_select(un, -1, constant(_flip_tail_index, n,
                                                   torch.long, dev))
               * constant(_flip_tail_mask, n, wd, dev))
    # for a real v, V[k] = 0.5 w[k] (un[k] - i un_flip[k])
    vf = torch.complex(un, -un_flip) * constant(_idct_twiddle, n,
                                                _complex(wd), dev)
    v = torch.fft.ifft(vf, dim=-1).real
    return _makhoul_unpermute(v).to(y.dtype)


# ---------------------------------------------------------------------------
# Real FFT basis (the ``circulant`` family: the real 2x2-block form of the
# DFT, columns [dc, cos_1, sin_1, cos_2, sin_2, ..., (nyquist if n even)]).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _real_fft_matrix_np(n: int) -> np.ndarray:
    """Orthonormal real-DFT basis as float64 numpy: columns
    [dc, cos_1, sin_1, ..., (nyquist if n even)]."""
    m = np.arange(n)[:, None].astype(np.float64)
    cols = [np.full((n, 1), 1.0 / np.sqrt(n))]
    for k in range(1, (n - 1) // 2 + 1):
        theta = 2.0 * np.pi * k * m / n
        cols.append(np.sqrt(2.0 / n) * np.cos(theta))
        cols.append(np.sqrt(2.0 / n) * np.sin(theta))
    if n % 2 == 0:
        cols.append(((-1.0) ** np.arange(n))[:, None] / np.sqrt(n))
    return np.concatenate(cols, axis=1)  # (n, n): y = x @ F


def _real_ifft_matrix_np(n: int) -> np.ndarray:
    return _real_fft_matrix_np(n).T


def real_fft_matrix(n: int, dtype=torch.float32,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Orthonormal real-DFT basis ``F`` with ``y = x @ F`` (cached)."""
    return constant(_real_fft_matrix_np, n, dtype, device)


def real_ifft_matrix(n: int, dtype=torch.float32,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    """Inverse of :func:`real_fft_matrix`, i.e. its transpose."""
    return constant(_real_ifft_matrix_np, n, dtype, device)


def _rfft_index(n: int) -> np.ndarray:
    """Positions in the interleaved (re, im) rfft spectrum of the basis
    coordinates: [re 0, (re k, im k) for 1 <= k <= (n-1)//2, re n/2]."""
    npair = (n - 1) // 2
    idx = [0] + list(range(2, 2 + 2 * npair))
    if n % 2 == 0:
        idx.append(n)
    return np.asarray(idx)


def _rfft_coef(n: int) -> np.ndarray:
    npair = (n - 1) // 2
    s = np.sqrt(2.0 / n)
    # cos_k picks up Re X[k], sin_k picks up -Im X[k]
    coef = [1.0 / np.sqrt(n)] + [s, -s] * npair
    if n % 2 == 0:
        coef.append(1.0 / np.sqrt(n))
    return np.asarray(coef)


def _irfft_index(n: int) -> np.ndarray:
    """Basis coordinate feeding each (re, im) slot of the one-sided
    spectrum (slot 0 where the coefficient is 0)."""
    npair = (n - 1) // 2
    idx = [0, 0]
    for k in range(npair):
        idx += [1 + 2 * k, 2 + 2 * k]
    if n % 2 == 0:
        idx += [n - 1, 0]
    return np.asarray(idx)


def _irfft_coef(n: int) -> np.ndarray:
    # X[0] = y_dc sqrt(n); X[k] = (y_cos - i y_sin) sqrt(n/2);
    # X[n/2] = y_nyq sqrt(n)  (the "backward"-norm irfft's input)
    npair = (n - 1) // 2
    h = np.sqrt(n / 2.0)
    coef = [np.sqrt(n), 0.0] + [h, -h] * npair
    if n % 2 == 0:
        coef += [np.sqrt(n), 0.0]
    return np.asarray(coef)


def real_fft(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal real-DFT along the last axis, O(N log N) via rFFT.

    Matches ``x @ real_fft_matrix(N)`` to float tolerance."""
    n, dev = x.shape[-1], x.device
    wd = work_dtype(x.dtype)
    xf = torch.view_as_real(torch.fft.rfft(x.to(wd), dim=-1))
    flat = xf.reshape(*xf.shape[:-2], -1)          # re 0, im 0, re 1, ...
    y = torch.index_select(flat, -1, constant(_rfft_index, n, torch.long,
                                              dev))
    return (y * constant(_rfft_coef, n, wd, dev)).to(x.dtype)


def real_ifft(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`real_fft` (orthonormal, so the adjoint)."""
    n, dev = y.shape[-1], y.device
    wd = work_dtype(y.dtype)
    spec = (torch.index_select(y.to(wd), -1,
                               constant(_irfft_index, n, torch.long, dev))
            * constant(_irfft_coef, n, wd, dev))
    spec = torch.view_as_complex(spec.reshape(*spec.shape[:-1], -1, 2))
    return torch.fft.irfft(spec, n=n, dim=-1).to(y.dtype)


# ---------------------------------------------------------------------------
# Fast Walsh-Hadamard (the ``hadamard`` family / Fastfood baseline).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _hadamard_matrix_np(n: int) -> np.ndarray:
    """Normalized Sylvester-Hadamard matrix ``H/sqrt(n)``."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"Hadamard needs a power-of-two size, got {n}")
    h = np.ones((1, 1))
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(n)


def hadamard_matrix(n: int, dtype=torch.float32,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Orthonormal Hadamard matrix; symmetric and involutive (cached)."""
    return constant(_hadamard_matrix_np, n, dtype, device)


def fwht(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis (N must be 2^k),
    in x's dtype."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT needs a power-of-two size, got {n}")
    lead = x.shape[:-1]
    h = 1
    y = x
    while h < n:
        y = y.reshape(*lead, n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    y = y.reshape(x.shape)
    if normalize:
        y = y / math.sqrt(n)
    return y


# ---------------------------------------------------------------------------
# Permutations ("adjacent SELLs are incoherent", paper section 6.2).
# ---------------------------------------------------------------------------

def make_riffle(n: int) -> np.ndarray:
    """Perfect-shuffle permutation [0, n/2, 1, n/2+1, ...] for size n."""
    half = (n + 1) // 2
    idx = np.empty((n,), dtype=np.int32)
    idx[0::2] = np.arange(half)
    idx[1::2] = np.arange(half, n)
    return idx


def invert_permutation(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p), dtype=p.dtype)
    return inv
