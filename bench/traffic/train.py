"""The generator of training traffic (a mix whose ``kind`` is
``train``): ``n_batches`` distinct batches of ``rows`` x ``seq`` tokens,
made on the device from the seed, each a pure function of (seed, index).

Tokens follow the program's synthetic LM stream (copied here so that
the yardstick cannot move with the program): a Zipf-like marginal, the
exponential transform ``floor(u^(-1/(zipf_a - 1)) - 1)`` of a uniform
draw clipped to the vocabulary, and with probability ``markov`` a token
replaced by a fixed hash of the one before it.  Labels are the next
token, -1 at the end.  An encoder-decoder's rows each bring ``frames``
stub audio frames of standard normal fp32 embeddings.
"""

from __future__ import annotations

from typing import List

import torch

from bench.weights import leaf_seed


def markov_next(prev: torch.Tensor, vocab: int) -> torch.Tensor:
    h = (prev.long() * 2654435761 + 12345) & 0xFFFFFFFF
    return (h % vocab).to(torch.int32)


def batch(mix: dict, cfg: dict, seed: int, index: int, device) -> dict:
    """Batch ``index`` of run ``seed``."""
    b, s, v = mix["rows"], mix["seq"], cfg["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, f"train-batch:{index}"))
    u = 1e-6 + (1.0 - 1e-6) * torch.rand((b, s), generator=gen,
                                         device=device)
    ranks = torch.floor(u ** (-1.0 / (mix["zipf_a"] - 1.0)) - 1.0)
    tokens = torch.clamp(ranks, 0, v - 1).to(torch.int32)
    coin = torch.rand((b, s - 1), generator=gen, device=device) < mix["markov"]
    nxt = torch.where(coin, markov_next(tokens[:, :-1], v), tokens[:, 1:])
    tokens = torch.cat([tokens[:, :1], nxt], dim=1)
    labels = torch.cat([tokens[:, 1:], torch.full((b, 1), -1, dtype=torch.int32,
                                                  device=device)], dim=1)
    out = {"tokens": tokens, "labels": labels}
    if mix.get("frames"):
        out["frontend_embeds"] = torch.randn(
            (b, mix["frames"], cfg["d_model"]), generator=gen,
            dtype=torch.float32, device=device)
    return out


def batches(mix: dict, cfg: dict, seed: int, device) -> List[dict]:
    return [batch(mix, cfg, seed, i, device) for i in range(mix["n_batches"])]


def tokens_per_step(mix: dict) -> int:
    """Positions a step trains on: decoder tokens plus encoder frames."""
    return mix["rows"] * (mix["seq"] + mix.get("frames", 0))

