"""Synthetic LM data: Zipf-distributed token streams with Markov
structure (port of :mod:`repro.data.pipeline`).

A batch is a pure function of ``(seed, step)``, so the iterator keeps no
state and a resumed run sees the same batches.  The distribution and the
labels are the reference's: Zipf-like ranks from an exponential transform
of a uniform draw, about half the tokens replaced by a fixed hash of the
previous token (:func:`markov_next`), labels the next token with -1 at
the end.  The draws come from a ``torch.Generator`` seeded from
``(seed, step)``, so the numbers differ from ``jax.random``'s.  A
config with a frontend gets the reference's stub inputs: standard normal
``frontend_embeds`` (B, P, d_model) fp32, and for ``vision`` labels -1
over the P-position patch prefix (no LM loss there).  ``shard_at`` gives
one data rank its rows of the global batch.
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
    frontend: Optional[str] = None  # "vision" | "audio" stub inputs
    n_frontend_tokens: int = 0
    d_model: int = 0                # frontend embedding width


def markov_next(prev: torch.Tensor, vocab: int) -> torch.Tensor:
    """The reference's deterministic next token, ``(t * 2654435761 +
    12345) mod 2^32 mod vocab`` (uint32 arithmetic), as int32."""
    h = (prev.long() * 2654435761 + 12345) & 0xFFFFFFFF
    return (h % vocab).to(torch.int32)


class SyntheticLM:
    """Stateless synthetic LM batches (CPU tensors, int32)."""

    def __init__(self, cfg: DataConfig):
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
        batch = {"tokens": tokens, "labels": labels}
        if cfg.frontend is not None and cfg.n_frontend_tokens > 0:
            p = cfg.n_frontend_tokens
            batch["frontend_embeds"] = torch.randn((b, p, cfg.d_model),
                                                   generator=gen)
            if cfg.frontend == "vision":
                # prefix positions carry image patches: no LM loss there
                labels[:, :p] = -1
        return batch

    def shard_at(self, step: int, shard: int, n_shards: int) -> dict:
        """Rows ``[shard * per, (shard + 1) * per)`` of ``batch_at(step)``,
        ``per = global_batch // n_shards``: one data rank's slice."""
        full = self.batch_at(step)  # cheap: synthetic; real data slices I/O
        per = self.cfg.global_batch // n_shards
        return {k: t[shard * per:(shard + 1) * per] for k, t in full.items()}


def make_batch_specs(cfg: DataConfig, model_d: int = 0) -> dict:
    """``{name: (shape, dtype)}`` of one global batch."""
    b, s = cfg.global_batch, cfg.seq_len
    spec = {"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}
    if cfg.frontend is not None and cfg.n_frontend_tokens > 0:
        spec["frontend_embeds"] = ((b, cfg.n_frontend_tokens,
                                    cfg.d_model or model_d), torch.float32)
    return spec
