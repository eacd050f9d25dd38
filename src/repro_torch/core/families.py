"""Pluggable structured-transform families behind one registry.

Port of :mod:`repro.core.families`.  A :class:`TransformFamily` holds
what a structured linear layer needs about its transform ``C``: the
explicit orthonormal operand pair (the ``matmul`` method and the
kernels' operands), the fast O(N log N) ``apply``/``inverse`` (the
``fft`` method), whether the diagonals are complex, the between-layer
riffle, the identity+noise init recipe and the size rule.  The three
registered families (``acdc`` = DCT-II, ``circulant`` = real-DFT basis,
``hadamard`` = normalized Walsh-Hadamard) are all real and feed the same
kernels, which only need a real ``C`` with ``C^-1 = C^T``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import transforms

__all__ = [
    "TransformFamily",
    "register",
    "get_family",
    "available",
    "default_init_diagonals",
]


def default_init_diagonals(gen: torch.Generator, k: int, n: int,
                           mean: float, std: float, dtype=torch.float32,
                           device=DEFAULT_DEVICE
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper section 6.2 identity+noise: a, d ~ N(mean, std^2), stacked
    ``(k, n)``, drawn from ``gen`` (a, then d)."""
    a = mean + std * torch.randn((k, n), generator=gen, dtype=dtype,
                                 device=device)
    d = mean + std * torch.randn((k, n), generator=gen, dtype=dtype,
                                 device=device)
    return a, d


def _identity_size(n: int) -> int:
    return n


def _next_pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


@dataclasses.dataclass(frozen=True)
class TransformFamily:
    """Everything a structured linear layer needs about its transform."""

    name: str
    #: explicit orthonormal matrix C, row-vector convention y = x @ C
    matrix: Callable[..., torch.Tensor]
    #: C^-1 (= C^T for every registered family)
    inverse_matrix: Callable[..., torch.Tensor]
    #: fast O(N log N) y = x @ C along the last axis
    apply: Callable[[torch.Tensor], torch.Tensor]
    #: fast O(N log N) x = y @ C^-1 along the last axis
    inverse: Callable[[torch.Tensor], torch.Tensor]
    #: diagonal parameterization: False = real a/d (all registered
    #: families; the kernels require it)
    complex_diagonals: bool = False
    #: between-layer permutation policy (indices for size n)
    riffle: Callable[[int], np.ndarray] = transforms.make_riffle
    #: identity-init recipe -> (a, d), each (k, n)
    init_diagonals: Callable[..., Tuple[torch.Tensor, torch.Tensor]] = \
        default_init_diagonals
    #: rounds a requested size up to one the transform supports
    valid_size: Callable[[int], int] = _identity_size

    def matrices(self, n: int, dtype=torch.float32, device=DEFAULT_DEVICE
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``(C, C^-1)`` operand pair at size ``n``."""
        return (self.matrix(n, dtype, device),
                self.inverse_matrix(n, dtype, device))


_REGISTRY: Dict[str, TransformFamily] = {}


def register(family: TransformFamily) -> TransformFamily:
    """Add a family to the registry (last registration wins)."""
    _REGISTRY[family.name] = family
    return family


def get_family(name: str) -> TransformFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown transform family {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


ACDC = register(TransformFamily(
    name="acdc",
    matrix=transforms.dct_matrix,
    inverse_matrix=transforms.idct_matrix,
    apply=transforms.dct,
    inverse=transforms.idct,
))

CIRCULANT = register(TransformFamily(
    name="circulant",
    matrix=transforms.real_fft_matrix,
    inverse_matrix=transforms.real_ifft_matrix,
    apply=transforms.real_fft,
    inverse=transforms.real_ifft,
))

HADAMARD = register(TransformFamily(
    name="hadamard",
    matrix=transforms.hadamard_matrix,
    inverse_matrix=transforms.hadamard_matrix,  # involutive: H = H^-1
    apply=transforms.fwht,
    inverse=transforms.fwht,
    valid_size=_next_pow2,
))
