"""Grouped-query attention with RoPE, qk-norm, sliding windows and KV
caches, and the encoder-decoder's cross-attention (port of
:mod:`repro.models.attention`).

Prefill runs flash-structured (online softmax over KV chunks) or plain
SDPA per ``cfg.attn_impl``.  Decode and the speculative verify are one
path: :func:`attention_verify` appends and scores T tokens (decode is
T = 1) against a dense ``(B, Smax, Hkv, Dh)`` cache slice, or — paged,
:func:`attention_verify_paged` — writes through the block table and
attends with the paged-attention kernel.  Caches are updated IN PLACE
(the reference returns new arrays; the port keeps one buffer and says so
in each function).  Windows are host ints per layer (0 = global).
:func:`attention` with ``kv`` is the cross-attention (no RoPE, full
visibility) that Seamless-M4T's encoder and decoder run.

Every dense write SETS its cache rows.  The reference's dense decode adds
into them (``cache_k + onehot * k``), which leaves a rejected draft's
stale K/V summed into the next decode once speculation is switched off;
the port does not copy that.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as paged_attn_mod
from repro_torch.models import linear
from repro_torch.models.common import (
    ModelConfig,
    apply_rope,
    causal_window_mask,
    init_rms_norm,
    rms_norm,
)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, device=DEFAULT_DEVICE,
                   cross: bool = False) -> dict:
    """Q/K/V/O projections (and the qk-norm scales).  ``cross`` (the
    encoder-decoder's cross-attention) changes no parameter: it is kept
    so the call reads as the reference's."""
    del cross
    dh = cfg.head_dim_
    d = cfg.d_model
    p = {
        "wq": linear.linear_init(gen, d, cfg.n_heads * dh, cfg, "attn_qkv",
                                 dtype, device),
        "wk": linear.linear_init(gen, d, cfg.n_kv_heads * dh, cfg,
                                 "attn_qkv", dtype, device),
        "wv": linear.linear_init(gen, d, cfg.n_kv_heads * dh, cfg,
                                 "attn_qkv", dtype, device),
        "wo": linear.linear_init(gen, cfg.n_heads * dh, d, cfg, "attn_out",
                                 dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(dh, dtype, device)
        p["k_norm"] = init_rms_norm(dh, dtype, device)
    return p


def _project_qkv(params: dict, xq: torch.Tensor, xkv: torch.Tensor,
                 cfg: ModelConfig, tp=None):
    """q (..., Hq, Dh), k / v (..., Hkv, Dh).  Under ``tp``
    (:class:`repro_torch.dist.sharding.TensorSplit`) with ``wq`` on its
    "model" block, q holds this rank's query heads, and k / v this
    rank's KV heads where ``wk`` / ``wv`` hold their block, else every
    KV head (:func:`_kv_for_queries` picks those the queries read)."""
    dh = cfg.head_dim_
    d = cfg.d_model
    nq, nkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    xq_in = xkv_in = None
    if tp is not None and linear.splits_out(params["wq"], nq):
        xq_in = tp.copy(xq)
        if linear.splits_out(params["wk"], nkv):
            xkv_in = xq_in if xkv is xq else tp.copy(xkv)
    q = linear.linear_apply(params["wq"], xq if xq_in is None else xq_in,
                            d, nq, cfg, "attn_qkv", tp)
    xk = xkv if xkv_in is None else xkv_in
    k = linear.linear_apply(params["wk"], xk, d, nkv, cfg, "attn_qkv", tp)
    v = linear.linear_apply(params["wv"], xk, d, nkv, cfg, "attn_qkv", tp)
    q = q.reshape(*xq.shape[:-1], q.shape[-1] // dh, dh)
    k = k.reshape(*xkv.shape[:-1], k.shape[-1] // dh, dh)
    v = v.reshape(*xkv.shape[:-1], v.shape[-1] // dh, dh)
    if cfg.qk_norm:
        # a scale shared by the heads: on a block of them, its gradient
        # is this rank's share and sums over "model"
        qs, ks = params["q_norm"]["scale"], params["k_norm"]["scale"]
        q = rms_norm(q, qs if xq_in is None else tp.copy(qs), cfg.norm_eps)
        k = rms_norm(k, ks if xkv_in is None else tp.copy(ks), cfg.norm_eps)
    return q, k, v


def _kv_for_queries(k: torch.Tensor, v: torch.Tensor, hq: int,
                    cfg: ModelConfig, tp=None):
    """The KV heads (..., S, Hkv', Dh) that ``hq`` query heads read: all
    of them, unless the queries are this rank's block of heads under
    ``tp`` and k / v every KV head (their ``wk`` / ``wv`` did not split
    with the heads): then the KV heads of those queries' groups, whose
    gradient sums over "model" (each rank's query heads read them)."""
    hkv = cfg.n_kv_heads
    if tp is None or hq == cfg.n_heads or k.shape[-2] < hkv:
        return k, v
    group = cfg.n_heads // hkv
    first = tp.index * hq
    if (hq % group if hq >= group else group % hq) or first % min(
            group, hq):
        raise ValueError(f"{hq} query heads a rank straddle the groups of "
                         f"{group} query heads a KV head")
    heads = slice(first // group, (first + hq - 1) // group + 1)
    return tp.copy(k)[..., heads, :], tp.copy(v)[..., heads, :]


def _scores(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """The fp32 scores (B, Hkv, group, Sq, Sk) of q (B, Sq, Hq, Dh)
    against k (B, Sk, Hkv, Dh): scaled, soft-capped, -1e30 where ``mask``
    (B, Sq, Sk) is false."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * (dh ** -0.5)
    if cfg.attn_logit_softcap > 0:
        cap = cfg.attn_logit_softcap
        scores = cap * torch.tanh(scores / cap)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, -1e30))
    return scores


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """q (B, Sq, Hq, Dh), k/v (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh)."""
    b, sq, hq, dh = q.shape
    probs = torch.softmax(_scores(q, k, mask, cfg), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, window: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Online softmax over KV chunks of ``cfg.attn_chunk`` keys (same
    math as :func:`_sdpa`, never the whole score matrix)."""
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    group = hq // hkv
    chunk = min(cfg.attn_chunk, sk)
    n_chunks = -(-sk // chunk)
    qg = q.reshape(b, sq, hkv, group, dh).float()
    scale = dh ** -0.5
    m = torch.full((b, hkv, group, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, dh), device=q.device)
    for idx in range(n_chunks):
        start = idx * chunk
        kc = k[:, start:start + chunk]
        vc = v[:, start:start + chunk]
        kp = torch.arange(start, start + kc.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) * scale
        if cfg.attn_logit_softcap > 0:
            cap = cfg.attn_logit_softcap
            s = cap * torch.tanh(s / cap)
        msk = causal_window_mask(positions, kp[None, :], window)
        s = torch.where(msk[:, None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vc.float())
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def _rank_heads(t: torch.Tensor, split, group: int = 1) -> torch.Tensor:
    """The heads of ``t`` (B, T, H, Dh) that go with this rank's block of
    a cache split over heads (``split.heads`` of its KV heads; ``group``
    query heads a KV head, contiguous, so a group stays on one rank)."""
    hs = split.heads
    return t if hs is None else t[:, :, hs.start * group:hs.stop * group]


def key_positions(split, n: int, device) -> torch.Tensor:
    """The global positions (n,) of the keys of a cache block of ``n``
    rows (``split.seq``; from 0 without a sequence split)."""
    keys = torch.arange(n, device=device)
    if split is None or split.seq is None:
        return keys
    return keys + split.seq.start


def _sdpa_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], cfg: ModelConfig,
                 gather) -> torch.Tensor:
    """:func:`_sdpa` over keys split in blocks across ranks: each rank
    scores its block of keys k/v (B, Sk, Hkv, Dh) (max ``m``, sum ``l``
    and the weighted values ``acc``), ``gather`` stacks every block's
    (the ranks' in sequence order) and they combine by the log-sum-exp
    rule under the global max, so a block whose keys are all masked adds
    nothing (and where every key is masked, as :func:`_sdpa`, the uniform
    average of all of them)."""
    b, sq, hq, dh = q.shape
    scores = _scores(q, k, mask, cfg)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    parts = gather(torch.cat([acc, m[..., None], p.sum(dim=-1)[..., None]],
                             dim=-1))
    acc, m, l = parts[..., :dh], parts[..., dh], parts[..., dh + 1]
    w = torch.exp(m - m.amax(dim=0))
    out = (acc * w[..., None]).sum(dim=0) / (l * w).sum(dim=0)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


def attend_split(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, mask: Optional[torch.Tensor],
                 cfg: ModelConfig, split) -> torch.Tensor:
    """Queries q (B, T, Hq, Dh) against this rank's block of a placed
    cache (B, Sk, Hkv_rank, Dh) (``split`` a
    :class:`repro_torch.dist.sharding.LeafSplit`; ``mask`` (B, T, Sk)
    over the block's keys, or None): the rank's query heads attend its
    KV heads, over its block of keys combined across the sequence blocks,
    and the heads' outputs are gathered over "model" -> (B, T, Hq, Dh)."""
    q = _rank_heads(q, split, q.shape[2] // cfg.n_kv_heads)
    return split.gather_heads(_attend_blocks(q, cache_k, cache_v, mask, cfg,
                                             split), 2)


def _attend_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], cfg: ModelConfig,
                   split=None) -> torch.Tensor:
    """:func:`_sdpa`, or over ``split.seq``'s blocks of keys combined
    across ranks (:func:`_sdpa_blocks`)."""
    if split is None or split.seq is None:
        return _sdpa(q, k, v, mask, cfg)
    return _sdpa_blocks(q, k, v, mask, cfg, split.gather_blocks)


def attend_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], cfg: ModelConfig, tp,
                 split=None) -> torch.Tensor:
    """This rank's query heads q (B, T, Hq / model, Dh) under ``tp`` (a
    :class:`repro_torch.dist.sharding.TensorSplit`) against k / v (B, Sk,
    Hkv', Dh): their KV heads (projected on the rank's block, or its
    block of a cache split over heads) or every KV head (those the
    queries read are picked: :func:`_kv_for_queries`); ``split``'s
    sequence blocks combined as in :func:`attend_split`.  The output
    stays on the rank's heads, for ``wo``'s rows."""
    k, v = _kv_for_queries(k, v, q.shape[-2], cfg, tp)
    return _attend_blocks(q, k, v, mask, cfg, split)


def attention_prefill(params: dict, x: torch.Tensor,
                      positions: torch.Tensor, window: int,
                      cfg: ModelConfig, tp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over a whole prompt, returning post-RoPE K/V
    for the cache: x (B, S, D) -> (out (B, S, D), k, v (B, S, Hkv, Dh)).
    Under ``tp`` each rank projects and attends its query heads (only
    their scores exist) and ``wo`` completes the output over "model";
    k / v are then this rank's KV heads where they split with the
    queries, else every KV head (:func:`_project_qkv`)."""
    q, k, v = _project_qkv(params, x, x, cfg, tp)
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    ka, va = _kv_for_queries(k, v, q.shape[-2], cfg, tp)
    if cfg.attn_impl == "chunked":
        out = _sdpa_chunked(q, ka, va, positions, window, cfg)
    else:
        mask = causal_window_mask(positions, positions, window)
        out = _sdpa(q, ka, va, mask, cfg)
    dh = cfg.head_dim_
    out = out.reshape(*x.shape[:-1], q.shape[-2] * dh)
    out = linear.linear_apply(params["wo"], out, cfg.n_heads * dh,
                              cfg.d_model, cfg, "attn_out", tp)
    return out, k, v


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              window: int, cfg: ModelConfig,
              kv: Optional[Tuple[torch.Tensor, ...]] = None,
              kv_positions: Optional[torch.Tensor] = None,
              tp=None) -> torch.Tensor:
    """Self-attention (``kv=None``: causal, as :func:`attention_prefill`)
    or cross-attention over ``kv[0]`` (B, Sk, D), the encoder states: no
    RoPE and no mask, every query sees every key (``kv_positions`` is
    unused, as in the reference).  x (B, S, D) -> (B, S, D).  Under
    ``tp`` each rank projects its query heads from ``x`` and their K/V
    from ``kv[0]`` (:func:`_project_qkv`: one ``copy`` where ``kv[0]`` is
    ``x``, the encoder's self-attention), and ``wo`` completes the output
    over "model"."""
    del kv_positions
    if kv is None:
        out, _, _ = attention_prefill(params, x, positions, window, cfg, tp)
        return out
    q, k, v = _project_qkv(params, x, kv[0], cfg, tp)
    k, v = _kv_for_queries(k, v, q.shape[-2], cfg, tp)
    out = _sdpa(q, k, v, None, cfg)
    dh = cfg.head_dim_
    out = out.reshape(*x.shape[:-1], q.shape[-2] * dh)
    return linear.linear_apply(params["wo"], out, cfg.n_heads * dh,
                               cfg.d_model, cfg, "attn_out", tp)


def scatter_prefill_kv(k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, max_len: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lay prompt K/V into a fresh (B, max_len, Hkv, Dh) slab, zero at
    and beyond each row's length."""
    b, s = k.shape[:2]
    valid = (torch.arange(max_len, device=k.device)[None, :]
             < lengths[:, None])[:, :, None, None]
    pad = (0, 0, 0, 0, 0, max_len - s)
    kz = torch.nn.functional.pad(k, pad)
    vz = torch.nn.functional.pad(v, pad)
    return (torch.where(valid, kz, torch.zeros_like(kz)),
            torch.where(valid, vz, torch.zeros_like(vz)))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int, dtype, device=DEFAULT_DEVICE) -> dict:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_kv_cache_paged(cfg: ModelConfig, n_blocks: int, block_size: int,
                        n_layers: int, dtype, device=DEFAULT_DEVICE) -> dict:
    """Global page pool; page ``n_blocks`` is the write sink (trash)."""
    shape = (n_layers, n_blocks + 1, block_size, cfg.n_kv_heads,
             cfg.head_dim_)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def scatter_prefill_pages(pages: torch.Tensor, slab: torch.Tensor,
                          phys_blocks: torch.Tensor) -> torch.Tensor:
    """Paged prefill scatter IN PLACE: lay a batch-1 dense slab
    (L, 1, S, ...) into the pool (L, NB+1, bs, ...) through
    ``phys_blocks`` (S // bs,), whose unmapped entries already point at
    the trash page.  Whole pages are overwritten."""
    n_layers, s = slab.shape[0], slab.shape[2]
    bs = pages.shape[2]
    vals = slab[:, 0].reshape(n_layers, s // bs, bs, *slab.shape[3:])
    pages[:, phys_blocks.long()] = vals.to(pages.dtype)
    return pages


def _set_rows(caches, pos: torch.Tensor, news) -> None:
    """Set ``cache[b, pos[b, t]] = new[b, t]`` IN PLACE, for each pair of
    ``caches`` (B, Smax, ...) and ``news`` (B, T, ...), at every
    ``pos < Smax``; positions at or beyond ``Smax`` write nothing (the
    reference's ``mode="drop"``).  Without a host sync: dropped entries
    are clamped to ``Smax - 1`` and write there the value that row's
    ``Smax - 1`` ends up with (its new value if a token lands there, else
    the old one), so the duplicate indices all carry one value.  At T = 1
    (decode) there are no duplicates, and none of that is launched."""
    smax = caches[0].shape[1]
    t = pos.shape[1]
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    idx = torch.clamp(pos.long(), max=smax - 1)                  # (B, T)
    live = (pos < smax)[:, :, None, None]
    src = None
    if t > 1:
        src = torch.clamp(smax - 1 - pos[:, :1].long(), 0, t - 1)  # (B, 1)
        src = torch.minimum(torch.arange(t, device=pos.device)[None, :],
                            src)[:, :, None, None]
    for cache, new in zip(caches, news):
        vals = torch.where(live, new.to(cache.dtype), cache[rows, idx])
        if src is not None:
            vals = torch.gather(vals, 1, src.expand_as(vals))
        cache[rows, idx] = vals


def _check_kv_block(split, tp, n_local: int, cfg: ModelConfig) -> None:
    """Raise unless the ``n_local`` KV heads projected on this rank's
    "model" block under ``tp`` are the heads ``split`` (its block of a
    placed cache) holds: the two splits must be one block."""
    mine = tp.block(cfg.n_kv_heads, n_local)
    if mine != split.heads:
        raise ValueError(f"this rank projects KV heads {mine} and its "
                         f"cache block holds {split.heads}: the two must "
                         f"be one block")


def attention_verify(params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, position: torch.Tensor,
                     window: int, cfg: ModelConfig, split=None, tp=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append-and-score T tokens against the dense cache in one pass (the
    speculative verify; decode is T = 1).

    Row ``b``'s tokens x (B, T, D) occupy positions ``position[b] ..
    position[b] + T - 1``, whose K/V are SET IN PLACE into the cache slice
    (B, Smax, Hkv, Dh), so a rollback is a position rewind (stale rows
    beyond the frontier sit past the causal mask until the next write
    replaces them).  Positions at or beyond ``Smax`` write nothing, so
    parked rows leave the cache alone.  Returns (out (B, T, D), cache_k,
    cache_v).

    A placed decode (T = 1) passes ``split`` (a
    :class:`repro_torch.dist.sharding.LeafSplit`: which block of the
    cache this rank holds, or None for every head and position) and
    ``tp`` (its :class:`repro_torch.dist.sharding.TensorSplit`).  With
    ``wq`` on its "model" block the rank projects its query heads and
    their KV heads (``wk`` / ``wv`` on their block: the block the cache
    holds), or every KV head where they do not split with the queries
    (then the cache holds every head, each model rank writes them all
    and its queries read their groups'), attends them
    (:func:`attend_local`), and ``wo``'s rows complete the output over
    "model" (a SELL ``wo`` gathers the heads first).  Where the queries
    are whole (heads that do not divide "model", SELL ``wq``) the rank
    writes and attends the KV heads of its cache block and the query
    heads of their groups, and the heads' outputs are gathered before
    ``wo`` (:func:`attend_split`).  The position's K/V is written by the
    rank whose sequence block holds it."""
    b, t, _ = x.shape
    smax = cache_k.shape[1]
    q, k, v = _project_qkv(params, x, x, cfg, tp)
    pos = position[:, None]                                 # (B, T)
    if t > 1:
        pos = pos + torch.arange(t, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_fraction, cfg.rope_theta)
    k_pos = key_positions(split, smax, x.device)
    local = pos
    if split is not None:
        if t != 1:
            raise ValueError("a placed cache is written one token a step")
        local = pos - k_pos[0]          # outside the block: dropped
        local = torch.where(local >= 0, local, torch.full_like(local, smax))
        if k.shape[-2] < cfg.n_kv_heads:
            _check_kv_block(split, tp, k.shape[-2], cfg)
        else:
            k, v = _rank_heads(k, split), _rank_heads(v, split)
    _set_rows((cache_k, cache_v), local, (k, v))
    mask = causal_window_mask(pos, k_pos[None, :], window)  # (B, T, Smax)
    if split is not None and q.shape[-2] == cfg.n_heads:
        out = attend_split(q, cache_k, cache_v, mask, cfg, split)
    else:
        out = attend_local(q, cache_k, cache_v, mask, cfg, tp, split)
    dh = cfg.head_dim_
    out = out.reshape(b, t, out.shape[-2] * dh)
    out = linear.linear_apply(params["wo"], out, cfg.n_heads * dh,
                              cfg.d_model, cfg, "attn_out", tp)
    return out, cache_k, cache_v


def attention_verify_paged(params: dict, x: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           position: torch.Tensor, window: int,
                           cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Paged twin of :func:`attention_verify` (decode is T=1, verify
    T=k+1): the T new tokens' K/V go into their tail pages IN PLACE (the
    trash page when unmapped or parked: the engine maps the whole write
    window or parks the row) and the paged-attention kernel attends over
    the mapped prefix plus the new tokens; a rollback is a position rewind
    plus returning over-mapped tail pages.  On CPU tensors the kernel's
    plain version runs."""
    b, t, _ = x.shape
    dh = cfg.head_dim_
    q, k, v = _project_qkv(params, x, x, cfg)
    pos = position[:, None] + torch.arange(t, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_fraction, cfg.rope_theta)
    ops.paged_attn_route(cfg.n_kv_heads, dh, cfg.n_heads // cfg.n_kv_heads,
                         t, q.device)
    out = paged_attn_mod.paged_attention(
        q, k, v, k_pages, v_pages, block_tables, position, window,
        softcap=cfg.attn_logit_softcap)
    out = out.reshape(b, t, cfg.n_heads * dh)
    out = linear.linear_apply(params["wo"], out, cfg.n_heads * dh,
                              cfg.d_model, cfg, "attn_out")
    return out, k_pages, v_pages
