"""Synthetic LM data: Zipf-distributed token streams with Markov
structure (port of :mod:`repro.data.pipeline`).

A batch is a pure function of ``(seed, step)``, so the iterator keeps no
state and a resumed run sees the same batches.  The distribution and the
labels are the reference's: Zipf-like ranks from an exponential transform
of a uniform draw, about half the tokens replaced by a fixed hash of the
previous token (:func:`markov_next`), labels the next token with -1 at
the end.  The draws come from a ``torch.Generator`` seeded from
``(seed, step)``, so the numbers differ from ``jax.random``'s.  The
reference's modality-frontend stub inputs and its per-host ``shard_at``
(no caller) are not ported; Qwen3 has no frontend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    zipf_a: float = 1.2
    markov_order: bool = True       # mix in next-token structure
    frontend: Optional[str] = None  # "vision" | "audio": not ported


def markov_next(prev: torch.Tensor, vocab: int) -> torch.Tensor:
    """The reference's deterministic next token, ``(t * 2654435761 +
    12345) mod 2^32 mod vocab`` (uint32 arithmetic), as int32."""
    h = (prev.long() * 2654435761 + 12345) & 0xFFFFFFFF
    return (h % vocab).to(torch.int32)


class SyntheticLM:
    """Stateless synthetic LM batches (CPU tensors, int32)."""

    def __init__(self, cfg: DataConfig):
        if cfg.frontend is not None:
            raise NotImplementedError(
                "modality frontend stub inputs are not ported yet "
                "(ROADMAP.md)")
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        gen = torch.Generator().manual_seed(
            (cfg.seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # Zipf-ish marginal via exponential transform of a uniform draw
        u = 1e-6 + (1.0 - 1e-6) * torch.rand((b, s), generator=gen)
        ranks = torch.floor(u ** (-1.0 / (cfg.zipf_a - 1.0)) - 1.0)
        tokens = torch.clamp(ranks, 0, v - 1).to(torch.int32)
        if cfg.markov_order:
            # about half the tokens a fixed function of the previous one
            coin = torch.rand((b, s - 1), generator=gen) < 0.5
            nxt = torch.where(coin, markov_next(tokens[:, :-1], v),
                              tokens[:, 1:])
            tokens = torch.cat([tokens[:, :1], nxt], dim=1)
        labels = torch.cat([tokens[:, 1:],
                            torch.full((b, 1), -1, dtype=torch.int32)], 1)
        return {"tokens": tokens, "labels": labels}
