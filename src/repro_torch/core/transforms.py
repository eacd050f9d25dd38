"""Orthonormal transform matrices and permutations used by SELL layers.

Port of :mod:`repro.core.transforms` (explicit matrices only).  Each
matrix is built by the SAME float64 numpy code as the reference and then
rounded to the requested dtype, so the fp32 operands the kernels receive
match the reference bit for bit.  The fast O(N log N) ``dct``/``fwht``
transforms are not ported yet (see ROADMAP.md).

All matrices use the row-vector convention ``y = x @ C`` on the last
axis and satisfy ``C^-1 = C^T``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE

__all__ = [
    "dct_matrix",
    "idct_matrix",
    "real_fft_matrix",
    "real_ifft_matrix",
    "hadamard_matrix",
    "make_riffle",
    "invert_permutation",
]


def _to_torch(mat: np.ndarray, dtype, device) -> torch.Tensor:
    # float64 -> float32 rounds to nearest, exactly like jnp.asarray(...,
    # dtype=float32) in the reference
    return torch.from_numpy(np.ascontiguousarray(mat)).to(
        device=device, dtype=dtype)


@functools.lru_cache(maxsize=16)
def _dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix as float64 numpy (paper eq. 9)."""
    k = np.arange(n)[None, :]          # frequency index
    m = np.arange(n)[None, :].T        # sample index
    mat = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    mat *= np.sqrt(2.0 / n)
    mat[:, 0] *= 1.0 / np.sqrt(2.0)    # eps_0 = 1/sqrt(2)
    return mat  # (n_in, n_freq): y = x @ mat  is the DCT-II of x


def dct_matrix(n: int, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> torch.Tensor:
    """Orthonormal DCT-II matrix ``C`` with ``y = x @ C``; ``C^-1 = C.T``."""
    return _to_torch(_dct_matrix_np(n), dtype, device)


def idct_matrix(n: int, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> torch.Tensor:
    """Inverse (DCT-III) matrix, the transpose of :func:`dct_matrix`."""
    return _to_torch(_dct_matrix_np(n).T, dtype, device)


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


def real_fft_matrix(n: int, dtype=torch.float32,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Orthonormal real-DFT basis ``F`` with ``y = x @ F``."""
    return _to_torch(_real_fft_matrix_np(n), dtype, device)


def real_ifft_matrix(n: int, dtype=torch.float32,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    """Inverse of :func:`real_fft_matrix`, i.e. its transpose."""
    return _to_torch(_real_fft_matrix_np(n).T, dtype, device)


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
    """Orthonormal Hadamard matrix; symmetric and involutive."""
    return _to_torch(_hadamard_matrix_np(n), dtype, device)


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
