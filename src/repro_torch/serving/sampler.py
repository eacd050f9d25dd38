"""Token sampling: greedy, or temperature with top-k and top-p filtering
(port of :mod:`repro.serving.sampler`).

The filter math is the reference's (temperature first, then top-k, then
top-p, masked logits -1e30), and so is the draw: Gumbel-max, the argmax
of the filtered fp32 logits plus ``-log(-log(U))``, which is how
``jax.random.categorical`` draws.  A row of NaN or one holding ``+inf``
therefore gives an in-range id (the first NaN, else the first ``+inf``),
as the reference's does, instead of raising.  ``U`` comes from a
``torch.Generator``, so sampled tokens differ from the reference's
``jax.random`` draws (they agree as distributions); greedy is exact.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30  # large-but-finite: keeps all-masked rows NaN-free


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit (ties kept);
    ``k <= 0`` disables."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, _NEG_INF),
                       logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest probability-sorted prefix
    whose mass reaches ``p`` (the top token always stays);
    ``p <= 0`` or ``p >= 1`` disables."""
    if p <= 0.0 or p >= 1.0:
        return logits
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p          # mass strictly before this token
    thresh = torch.where(keep, sorted_desc,
                         torch.full_like(sorted_desc, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, _NEG_INF),
                       logits)


def sample(logits: torch.Tensor, method: str = "greedy",
           temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """int32 token ids from ``logits`` (..., V): ``greedy`` argmax, or
    ``temp`` — a Gumbel-max draw from ``generator`` (on the logits'
    device) over the temperature-scaled, top-k/top-p-filtered logits."""
    if method == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if method != "temp":
        raise ValueError(f"unknown sampler {method!r}")
    lf = logits.float() / max(temperature, 1e-6)
    lf = apply_top_k(lf, top_k)
    lf = apply_top_p(lf, top_p)
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(lf - torch.log(-torch.log(u)), dim=-1).to(
        torch.int32)
