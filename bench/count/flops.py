"""Model FLOPs from a configuration's shapes alone, the numerator of
``mfu.*``.

Counted as the algorithm needs them, never as an implementation runs
them, so no implementation can read above 100 % of the peak:

* a dense matmul counts ``2 in out`` a row;
* attention counts ``4 ctx H Dh`` a query position, ``ctx`` the keys
  it sees (causal: its position + 1; the encoder's self-attention and
  cross-attention: every frame);
* an ACDC cascade of length N counts, a row and for each of its
  ``sell_k`` layers, its two transforms at ``2.5 N log2 N`` (a fast real
  transform, the paper's O(N log N)) and its two diagonals, N each; N is
  the operating size the rectangular cascade runs at (``n_op``);
* an MoE token counts its ``top_k`` experts and the shared expert, and
  the router;
* elementwise work (norms, activations, softmax, the loss) is not
  counted;
* a train step counts three forwards.

``cfg`` is a configuration file's ``model`` dict.
"""

from __future__ import annotations

import math

def uses_sell(cfg: dict, role: str) -> bool:
    return cfg["sell_kind"] != "dense" and any(
        role.startswith(t) for t in cfg["sell_targets"])


def n_op(n_in: int, n_out: int, lane: int = 128) -> int:
    """The operating size of a rectangular ACDC cascade: max(in, out)
    rounded up to a lane multiple of 128."""
    n = max(n_in, n_out)
    return -(-n // lane) * lane


def acdc_row(cfg: dict, n: int) -> float:
    """One row through an order-``sell_k`` cascade at size ``n``."""
    return cfg["sell_k"] * (2 * 2.5 * n * math.log2(n) + 2 * n)


def proj_row(cfg: dict, role: str, n_in: int, n_out: int) -> float:
    """One row through a projection ``n_in -> n_out``."""
    if uses_sell(cfg, role):
        if cfg["sell_kind"] != "acdc":
            raise ValueError(f"no count for sell_kind {cfg['sell_kind']!r}")
        return acdc_row(cfg, n_op(n_in, n_out))
    return 2.0 * n_in * n_out


def _dims(cfg: dict):
    dh = cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]
    return cfg["d_model"], dh, cfg["n_heads"] * dh, cfg["n_kv_heads"] * dh


def mlp_row(cfg: dict, d_ff: int) -> float:
    d = cfg["d_model"]
    return (2 * proj_row(cfg, "mlp_in", d, d_ff)
            + proj_row(cfg, "mlp_out", d_ff, d))


def ffn_row(cfg: dict) -> float:
    """A decoder layer's feed-forward half, one token."""
    d = cfg["d_model"]
    if not cfg["n_experts"]:
        return mlp_row(cfg, cfg["d_ff"])
    out = 2.0 * d * cfg["n_experts"] + cfg["top_k"] * mlp_row(cfg, cfg["d_ff"])
    if cfg["n_shared_experts"]:
        out += mlp_row(cfg, cfg["d_ff"] * cfg["n_shared_experts"])
    return out


def causal_ctx_sum(start: int, n: int) -> float:
    """Sum over positions ``start .. start + n - 1`` of the keys each
    sees causally (position + 1)."""
    return n * start + n * (n + 1) / 2.0


def decoder_forward(cfg: dict, rows: int, seq: int) -> float:
    """A decoder-only forward over ``rows`` prompts of ``seq`` tokens
    from position 0, logits at every position."""
    d, _, nq, nkv = _dims(cfg)
    tokens = rows * seq
    per_layer = (tokens * (2.0 * d * (nq + 2 * nkv)
                           + proj_row(cfg, "attn_out", nq, d)
                           + ffn_row(cfg))
                 + rows * 4.0 * nq * causal_ctx_sum(0, seq))
    return cfg["n_layers"] * per_layer + tokens * 2.0 * d * cfg["vocab_size"]


def encoder_forward(cfg: dict, rows: int, frames: int) -> float:
    """An encoder-decoder's encoder over ``rows`` x ``frames``."""
    d, _, nq, nkv = _dims(cfg)
    n_enc = cfg["n_encoder_layers"] or cfg["n_layers"]
    per_frame = (2.0 * d * (nq + 2 * nkv) + proj_row(cfg, "attn_out", nq, d)
                 + 4.0 * frames * nq + mlp_row(cfg, cfg["d_ff"]))
    return n_enc * rows * frames * per_frame


def cross_kv(cfg: dict, rows: int, frames: int) -> float:
    """Every decoder layer's cross K/V of ``rows`` x ``frames``."""
    d, _, _, nkv = _dims(cfg)
    return cfg["n_layers"] * rows * frames * 2.0 * d * 2 * nkv


def encdec_decoder_tokens(cfg: dict, tokens: int, ctx_sum: float,
                          frames: int) -> float:
    """The decoder (without the cross K/V) over ``tokens`` positions
    whose causal contexts sum to ``ctx_sum``, attending ``frames``
    frames, logits at each."""
    d, _, nq, nkv = _dims(cfg)
    per_token = (2.0 * d * (nq + 2 * nkv) + proj_row(cfg, "attn_out", nq, d)
                 + 2.0 * d * nq + proj_row(cfg, "attn_out", nq, d)
                 + 4.0 * frames * nq + mlp_row(cfg, cfg["d_ff"]))
    return (cfg["n_layers"] * (tokens * per_token + 4.0 * nq * ctx_sum)
            + tokens * 2.0 * d * cfg["vocab_size"])


def encdec_forward(cfg: dict, rows: int, seq: int, frames: int) -> float:
    return (encoder_forward(cfg, rows, frames) + cross_kv(cfg, rows, frames)
            + encdec_decoder_tokens(cfg, rows * seq,
                                    rows * causal_ctx_sum(0, seq), frames))


def train_step(cfg: dict, rows: int, seq: int, frames: int = 0) -> float:
    """FLOPs of one train step: three forwards."""
    if cfg["family"] == "encdec":
        fwd = encdec_forward(cfg, rows, seq, frames)
    elif cfg["family"] == "decoder":
        fwd = decoder_forward(cfg, rows, seq)
    else:
        raise ValueError(f"no count for family {cfg['family']!r}")
    return 3.0 * fwd
