"""Mamba2 (state-space duality / SSD) blocks (port of
:mod:`repro.models.mamba2`; arXiv:2405.21060).

Training runs the chunked SSD: a quadratic "attention" inside each chunk
plus a linear recurrence over the chunk summaries, all in fp32 (the state
recurrence is numerically delicate; the reference upcasts too), the
recurrence a plain loop over chunks.  Decode is the O(1)-a-token
recurrent update against SSM and conv state caches.

The block's in/out projections go through the SELL factory (roles
``ssm_in``, ``ssm_out``), so the paper's layer carries the projections;
the SSD scan, the depthwise conv and the state update are plain PyTorch,
as the reference's are ``jnp`` outside any kernel.

Layer parameters are stacked with a leading L axis, keyed like the
reference pytree (``layers/mixer/in_proj/sell/a`` is ``(L, K, N)``).
``decode_step`` updates the cache in place; ``verify_step`` returns new
state tensors and per-position snapshots (the recurrence cannot rewind,
so a rollback re-selects the state at the accepted length).

Under tensor parallelism (``tp``, a placed train, prefill or decode
step's :class:`repro_torch.dist.sharding.TensorSplit`) a mamba layer
computes this rank's block of SSM heads, as the reference's jit computes
them on ``param_specs``' blocks: its heads' ``z``, ``x`` and ``dt``
columns of ``in_proj`` and ``B``, ``C`` whole (ngroups = 1: every head
reads them), the conv on those channels, the SSD on those heads (heads
are independent given ``B`` and ``C``), the gated norm's mean completed
over "model" and ``out_proj``'s rows of those heads reduced over
"model".  Every leaf it reads in part (the gathered ``in_proj``, the
conv, ``dt_bias``, ``a_log``, ``d_skip``, the norm's scale) goes through
``tp.copy`` whole before its slice, so its gradient is summed over
"model" and every rank holds the whole one.  A SELL ``in_proj`` runs
whole and its output goes through ``tp.copy``; before a SELL
``out_proj`` the heads' outputs are gathered over "model" and normed
whole.  A decode step keeps the whole conv window on every model rank: it
projects every channel of the window's input, the heads' ``z`` and
``dt`` only (:func:`_decode_proj`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DEFAULT_DEVICE
from repro_torch.models import linear
from repro_torch.models.common import (
    ModelConfig,
    cross_entropy,
    embed_init,
    embed_lookup,
    init_rms_norm,
    leaf_split,
    rms_norm,
    stack_init,
    unembed,
)
from repro_torch.models.transformer import keep, layer_params, run_layer


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner_
    n_heads = d_in // cfg.ssm_head_dim
    n_state = cfg.ssm_state
    conv_dim = d_in + 2 * n_state  # x + B + C share the conv (ngroups=1)
    return d_in, n_heads, n_state, conv_dim


def _proj_out(cfg: ModelConfig) -> int:
    d_in, n_heads, n_state, _ = _dims(cfg)
    return 2 * d_in + 2 * n_state + n_heads  # z, xBC, dt


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo, hi, dtype, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype,
                                       device=device)


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    """One block's parameters: the reference's shapes and distributions
    (dt initialised log-uniform in [1e-3, 1e-1] through the softplus
    inverse, A log-uniform in [1, 16], D = 1), drawn from ``gen``."""
    d = cfg.d_model
    d_in, n_heads, _, conv_dim = _dims(cfg)
    in_proj = linear.linear_init(gen, d, _proj_out(cfg), cfg, "ssm_in",
                                 dtype, device)
    conv_w = 0.1 * torch.randn((cfg.conv_width, conv_dim), generator=gen,
                               dtype=dtype, device=device)
    dt = torch.exp(_uniform(gen, (n_heads,), math.log(1e-3),
                            math.log(1e-1), dtype, device))
    a = _uniform(gen, (n_heads,), 1.0, 16.0, dtype, device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "a_log": torch.log(a),
        "d_skip": torch.ones((n_heads,), dtype=dtype, device=device),
        "norm": init_rms_norm(d_in, dtype, device),
        "out_proj": linear.linear_init(gen, d_in, d, cfg, "ssm_out", dtype,
                                       device),
    }


# ---------------------------------------------------------------------------
# Chunked SSD (training and prefill).
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) with out[i, j] = sum_{k=j+1..i} x[k] and
    -inf above the diagonal (``exp`` of it is 0, never ``0 * inf``)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(x: torch.Tensor, a_log: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int) -> torch.Tensor:
    """Minimal chunked SSD (the Mamba2 paper's listing, ngroups=1), fp32
    throughout, the output in ``x``'s dtype.

    x (B, S, H, P) already multiplied by dt; a_log (B, S, H) = dt * A
    (negative); bmat, cmat (B, S, N).  ``S`` must be a multiple of
    ``chunk``."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    assert s % chunk == 0, (s, chunk)
    c = s // chunk
    out_dtype = x.dtype
    xc = x.float().reshape(b, c, chunk, h, p)
    ac = a_log.float().reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # BHCL
    bc = bmat.float().reshape(b, c, chunk, n)
    cc = cmat.float().reshape(b, c, chunk, n)

    a_cum = torch.cumsum(ac, dim=-1)                               # (B,H,C,L)

    # 1. intra-chunk (diagonal blocks): "attention" with a decay kernel
    l_mat = torch.exp(_segsum(ac))                                 # BHCLS
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)[:, None] * l_mat
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xc)

    # 2. chunk summary states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)              # (B,H,C,L)
    states = torch.einsum(
        "bcln,bclhp->bchpn", bc,
        xc * decay_states.permute(0, 2, 3, 1)[..., None])

    # 3. inter-chunk recurrence: the state carried into each chunk
    chunk_decay = torch.exp(a_cum[..., -1])                        # (B,H,C)
    prev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    carried = []
    for i in range(c):
        carried.append(prev)
        prev = prev * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(carried, dim=1)                      # BCHPN

    # 4. off-diagonal contribution of the carried state
    state_decay = torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]  # BCLH1
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, prev_states) * state_decay

    return (y_diag + y_off).reshape(b, s, h, p).to(out_dtype)


def _proj_cols(t: torch.Tensor, cfg: ModelConfig, hs: slice):
    """(z, xBC, dt) of ``t`` (..., 2 d_inner + 2 N + H): in_proj's output
    or its weight's columns, on the SSM heads ``hs``: z and x of those
    heads, B and C whole, dt of those heads."""
    d_in, _, n_state, _ = _dims(cfg)
    p, bc = cfg.ssm_head_dim, 2 * d_in
    a, b = hs.start * p, hs.stop * p
    dt0 = bc + 2 * n_state
    return (t[..., a:b],
            torch.cat([t[..., d_in + a:d_in + b],
                       t[..., bc:bc + 2 * n_state]], dim=-1),
            t[..., dt0 + hs.start:dt0 + hs.stop])


def _conv_cols(t: torch.Tensor, cfg: ModelConfig, hs: slice
               ) -> torch.Tensor:
    """The conv channels (..., x | B | C) of the SSM heads ``hs``: their
    x, then B and C."""
    d_in, p = _dims(cfg)[0], cfg.ssm_head_dim
    return torch.cat([t[..., hs.start * p:hs.stop * p], t[..., d_in:]],
                     dim=-1)


def heads_of(tp) -> Optional[slice]:
    """The SSM heads a mamba layer computes under ``tp``: this rank's
    block, or None for every head."""
    return None if tp is None else tp.ssm_block()


def _mine(params: dict, cfg: ModelConfig, hs: Optional[slice], tp
          ) -> dict:
    """The block's leaves as heads ``hs`` read them: the conv on their
    channels, ``dt_bias`` / ``a_log`` / ``d_skip`` on the heads, each cut
    from ``tp.copy`` of the whole leaf (its gradient summed over
    "model"); ``params`` itself for every head."""
    if hs is None:
        return params
    out = dict(params)
    for k in ("conv_w", "conv_b"):
        out[k] = _conv_cols(tp.copy(params[k]), cfg, hs)
    for k in ("dt_bias", "a_log", "d_skip"):
        out[k] = tp.copy(params[k])[hs]
    return out


def _conv_full(xbc: torch.Tensor, params: dict, cfg: ModelConfig
               ) -> torch.Tensor:
    """Causal depthwise conv over (x, B, C) of a whole sequence, summed
    tap by tap as the reference sums it (pre-SiLU)."""
    s = xbc.shape[1]
    w = params["conv_w"].to(xbc.dtype)                             # (W, C)
    xbc_pad = F.pad(xbc, (0, 0, cfg.conv_width - 1, 0))
    conv = 0
    for i in range(cfg.conv_width):
        conv = conv + xbc_pad[:, i:i + s, :] * w[i]
    return conv + params["conv_b"].to(xbc.dtype)


def _split_proj(params: dict, x: torch.Tensor, cfg: ModelConfig,
                hs: Optional[slice] = None, tp=None):
    """in_proj -> (z, xBC (pre-conv), dt), each (B, S, ...); on the SSM
    heads ``hs`` under ``tp`` (:func:`_proj_cols`): a dense ``in_proj``
    projects those columns only, from ``tp.copy`` of its whole weight
    and of ``x``; a SELL one runs whole and its output goes through
    ``tp.copy``.  The gradients of ``x`` and of the weight are then each
    rank's share (its heads' columns, its part of B's and C's), summed
    over "model"."""
    d_in, _, _, conv_dim = _dims(cfg)
    proj = params["in_proj"]
    if hs is not None and "w" in proj:
        cols = _proj_cols(tp.copy(proj["w"]), cfg, hs)
        out = torch.matmul(tp.copy(x), torch.cat(cols, dim=-1).to(x.dtype))
        return torch.split(out, [c.shape[-1] for c in cols], dim=-1)
    zxbcdt = linear.linear_apply(proj, x, cfg.d_model, _proj_out(cfg), cfg,
                                 "ssm_in")
    if hs is not None:
        return _proj_cols(tp.copy(zxbcdt), cfg, hs)
    return torch.split(zxbcdt, [d_in, conv_dim, zxbcdt.shape[-1] - d_in
                                - conv_dim], dim=-1)


def _norm_split(y: torch.Tensor, scale: torch.Tensor, d: int, eps: float,
                tp) -> torch.Tensor:
    """:func:`rms_norm` over ``d`` channels of which ``y`` holds this
    rank's block (``scale`` its block): the sum of squares reduced over
    "model" and its gradient summed back (``tp.copy`` of ``tp.reduce``):
    every rank's channels read the mean."""
    dt = y.dtype
    yf = y.float()
    ss = tp.copy(tp.reduce(torch.sum(yf * yf, dim=-1, keepdim=True)))
    out = yf * torch.rsqrt(ss / d + eps)
    return (out * (1.0 + scale.float())).to(dt)


def _gate_out(params: dict, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig, tp=None) -> torch.Tensor:
    """y * silu(z), the inner norm and out_proj.  Under ``tp`` with ``y``
    and ``z`` on this rank's heads: a dense ``out_proj`` on those heads'
    rows takes the norm of :func:`_norm_split` and reduces its partial
    sums over "model"; otherwise (SELL) the gated heads are gathered over
    "model" and normed and projected whole."""
    d_in = _dims(cfg)[0]
    y = y * F.silu(z)
    scale = params["norm"]["scale"]
    if y.shape[-1] < d_in and linear.splits_in(params["out_proj"], d_in):
        mine = tp.copy(scale)[tp.block(d_in, y.shape[-1])]
        y = _norm_split(y, mine, d_in, cfg.norm_eps, tp)
    else:
        if y.shape[-1] < d_in:
            y = tp.gather(y, -1)
        y = rms_norm(y, scale, cfg.norm_eps)
    return linear.linear_apply(params["out_proj"], y, d_in, cfg.d_model,
                               cfg, "ssm_out", tp)


def _dt_a(params: dict, dt: torch.Tensor):
    """softplus(dt + dt_bias) and A = -exp(a_log), fp32."""
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return dt, -torch.exp(params["a_log"].float())


def _conv_split(params: dict, xbc: torch.Tensor, cfg: ModelConfig):
    """The conv and SiLU over the raw (x, B, C) channels -> (xs (B, S,
    H', P) on the heads x holds, B, C)."""
    b, s, _ = xbc.shape
    n_state = cfg.ssm_state
    xbc = F.silu(_conv_full(xbc, params, cfg))
    xs, bmat, cmat = torch.split(
        xbc, [xbc.shape[-1] - 2 * n_state, n_state, n_state], dim=-1)
    return xs.reshape(b, s, -1, cfg.ssm_head_dim), bmat, cmat


def mamba_block(params: dict, x: torch.Tensor, cfg: ModelConfig, tp=None
                ) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D); ``S`` a multiple of ``cfg.ssm_chunk``;
    ``tp`` computes this rank's SSM heads (see the module's
    docstring)."""
    b, s, _ = x.shape
    hs = heads_of(tp)
    mine = _mine(params, cfg, hs, tp)
    z, xbc, dt = _split_proj(params, x, cfg, hs, tp)
    xs, bmat, cmat = _conv_split(mine, xbc, cfg)
    dt, a = _dt_a(mine, dt)                                        # (B,S,H)
    y = ssd_chunked((xs.float() * dt[..., None]).to(x.dtype), dt * a,
                    bmat, cmat, cfg.ssm_chunk)
    y = y + xs * mine["d_skip"].to(x.dtype)[None, None, :, None]
    return _gate_out(params, y.reshape(b, s, -1), z, cfg, tp)


# ---------------------------------------------------------------------------
# Prefill: one batched pass over the prompt, recovering the decode caches.
# ---------------------------------------------------------------------------

def mamba_block_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        mask: torch.Tensor, lengths: torch.Tensor, tp=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`mamba_block` over right-padded prompts that also returns
    the decode-ready caches ``(y (B,S,D), ssm_state (B,H,P,N) fp32,
    conv_state (B,W-1,C))``: what ``mamba_block_decode`` holds after the
    row's ``length`` tokens one at a time.  Under ``tp`` the SSM state
    holds this rank's heads and the conv window every channel (its heads'
    x gathered over "model" in head order, B and C as computed).

    * pad positions get dt = 0 (decay 1, no input), so the recurrence is
      frozen past each row's length;
    * the final state is the closed form of the unrolled recurrence,
      ``h_L = sum_t exp(sum_{s>t} dta_s) dx_t B_t^T``;
    * the conv window is the last W-1 raw (pre-SiLU) conv inputs before
      the row's length.
    """
    b, s, _ = x.shape
    hs = heads_of(tp)
    mine = _mine(params, cfg, hs, tp)
    z, xbc_raw, dt = _split_proj(params, x, cfg, hs, tp)
    xs, bmat, cmat = _conv_split(mine, xbc_raw, cfg)
    dt, a = _dt_a(mine, dt)                                        # (B,S,H)
    maskf = mask.float()[..., None]                                # (B,S,1)
    dta = (dt * a) * maskf
    dx = (xs.float() * dt[..., None]) * maskf[..., None]

    # outputs by the chunked SSD over S padded to a chunk multiple with
    # frozen steps (dta = 0: decay 1; dx = 0: no contribution)
    chunk = min(cfg.ssm_chunk, max(s, 1))
    extra = -(-s // chunk) * chunk - s

    def tpad(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, extra))

    y = ssd_chunked(tpad(dx).to(x.dtype), tpad(dta), tpad(bmat),
                    tpad(cmat), chunk)[:, :s]
    y = y + xs * mine["d_skip"].to(x.dtype)[None, None, :, None]
    y = _gate_out(params, y.reshape(b, s, -1), z, cfg, tp)

    # final SSM state: the decay-weighted sum of every (masked) input
    a_cum = torch.cumsum(dta, dim=1)                               # (B,S,H)
    weight = torch.exp(a_cum[:, -1:, :] - a_cum) * maskf
    ssm_state = torch.einsum("bshp,bsn->bhpn", dx * weight[..., None],
                             bmat.float() * maskf)

    # conv window: raw inputs at positions [len - W + 1, len)
    idx = lengths.long()[:, None] + torch.arange(
        -(cfg.conv_width - 1), 0, device=x.device)[None, :]        # (B,W-1)
    valid = (idx >= 0)[..., None]
    idx = torch.clamp(idx, 0, s - 1)
    taken = torch.gather(xbc_raw, 1, idx[..., None].expand(
        -1, -1, xbc_raw.shape[-1]))
    conv_state = torch.where(valid, taken, torch.zeros_like(taken))
    if hs is not None:
        n2 = 2 * cfg.ssm_state
        conv_state = torch.cat([tp.gather(conv_state[..., :-n2], -1),
                                conv_state[..., -n2:]], dim=-1)
    return y, ssm_state, conv_state


def lengths_mask(tokens: torch.Tensor, lengths: Optional[torch.Tensor]):
    """(lengths, (B, S) mask of the real positions) of right-padded
    ``tokens``; ``lengths`` None means every row is full."""
    b, s = tokens.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)
    mask = (torch.arange(s, device=tokens.device)[None, :]
            < lengths.long()[:, None])
    return lengths, mask


def prefill(params: dict, cache: dict, tokens: torch.Tensor,
            cfg: ModelConfig, lengths: Optional[torch.Tensor] = None,
            frontend_embeds=None, cut=keep, split=None, tp=None
            ) -> Tuple[torch.Tensor, dict]:
    """Batched prompt pass -> (logits (B, S, V), a NEW ``{"ssm",
    "conv"}`` cache shaped like ``cache``).  ``frontend_embeds`` is
    accepted and unused, as in the reference; ``cut`` as in
    :func:`repro_torch.models.transformer.prefill`; ``split`` is
    accepted and unused (nothing here reads a placed cache's values or
    mixes the batch's rows).  ``tp`` (the model-local view's
    :class:`repro_torch.dist.sharding.TensorSplit`): each layer computes
    this rank's SSM heads, whose states are cut as this rank's block, and
    the logits are this rank's block of the vocabulary where it
    splits."""
    del frontend_embeds, split
    lengths, mask = lengths_mask(tokens, lengths)
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    local = heads_of(tp) is not None
    ssms, convs = [], []
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm"]["scale"], cfg.norm_eps)
        y, ssm, conv = mamba_block_prefill(layer["mixer"], h, cfg, mask,
                                           lengths, tp)
        x = x + y
        ssms.append(cut("ssm", ssm, local))
        convs.append(cut("conv", conv))
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp), {
        "ssm": torch.stack(ssms).to(cache["ssm"].dtype),
        "conv": torch.stack(convs).to(cache["conv"].dtype)}


# ---------------------------------------------------------------------------
# Decode and verify: the recurrent state update, O(1) a token.
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype,
                   device=DEFAULT_DEVICE) -> dict:
    """``ssm`` (L, B, H, P, N) fp32 and ``conv`` (L, B, W-1, C) in
    ``dtype``, zero."""
    _, n_heads, n_state, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, n_heads, cfg.ssm_head_dim,
                            n_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def _recur(params: dict, xbc: torch.Tensor, dt: torch.Tensor,
           ssm: torch.Tensor, conv: torch.Tensor, cfg: ModelConfig,
           ssm_steps: Optional[torch.Tensor] = None,
           conv_steps: Optional[torch.Tensor] = None,
           heads: Optional[slice] = None):
    """Consume T positions one at a time: the conv window and the SSM
    state, as T single-token decode steps.  xbc (B, T, C) raw conv input
    (every channel) and dt (B, T, H) raw in_proj output, of every head or
    of ``heads``; ``ssm_steps``/``conv_steps`` (B, T+1, ...), when given,
    receive the state after each position.  Returns (y (B, T, H' * P) in
    xbc's dtype, ssm, conv).

    ``heads`` (a slice of the SSM heads; a placed decode's) are the heads
    ``ssm`` holds: the conv runs whole (every model rank updates the same
    window), the state update and ``y`` on those heads."""
    b, t, _ = xbc.shape
    d_in, n_heads, n_state, _ = _dims(cfg)
    w = params["conv_w"].to(xbc.dtype)                             # (W, C)
    conv_b = params["conv_b"].to(xbc.dtype)
    mine = params
    if heads is not None:
        mine = {k: params[k][heads] for k in ("dt_bias", "a_log", "d_skip")}
        if dt.shape[-1] == n_heads:
            dt = dt[..., heads]
    dt, a = _dt_a(mine, dt)                                        # (B,T,H)
    decay = torch.exp(dt * a)
    d_skip = mine["d_skip"].float()[None, :, None]
    ys = []
    for i in range(t):
        window = torch.cat([conv.to(xbc.dtype), xbc[:, i:i + 1]], dim=1)
        cv = torch.einsum("bwc,wc->bc", window, w) + conv_b
        conv = window[:, 1:]
        xs, bmat, cmat = torch.split(F.silu(cv), [d_in, n_state, n_state],
                                     dim=-1)
        xs = xs.reshape(b, n_heads, cfg.ssm_head_dim)
        if heads is not None:
            xs = xs[:, heads]
        xs = xs.float()
        # h <- decay * h + dt * x B^T ; y = h C
        dx = xs * dt[:, i, :, None]                                # (B,H,P)
        ssm = (ssm * decay[:, i, :, None, None]
               + dx[..., None] * bmat.float()[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", ssm, cmat.float()) + xs * d_skip
        ys.append(y.reshape(b, -1).to(xbc.dtype))
        if ssm_steps is not None:
            ssm_steps[:, i + 1] = ssm
            conv_steps[:, i + 1] = conv
    return torch.stack(ys, dim=1), ssm, conv


def _decode_proj(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 hs: Optional[slice]):
    """A placed decode's in_proj -> (z, xBC, dt): ``z`` and ``dt`` of the
    SSM heads ``hs`` and the raw conv input ``xBC`` of every channel, so
    every model rank keeps the same whole conv window (``cache_specs``
    splits ``conv`` by rows only).  A dense ``in_proj`` (gathered whole)
    projects the window's channels in a product of their own, the same
    on every model rank, and the heads' ``z`` / ``dt`` in another; a
    SELL one runs whole.  No gradient: decode only."""
    if hs is None:
        return _split_proj(params, x, cfg)
    proj = params["in_proj"]
    if "w" not in proj:
        z, xbc, dt = _split_proj(params, x, cfg)
        p = cfg.ssm_head_dim
        return z[..., hs.start * p:hs.stop * p], xbc, dt[..., hs]
    d_in, _, _, conv_dim = _dims(cfg)
    w = proj["w"].to(x.dtype)
    xbc = torch.matmul(x, w[..., d_in:d_in + conv_dim])
    z, _, dt = _proj_cols(w, cfg, hs)
    zdt = torch.matmul(x, torch.cat([z, dt], dim=-1))
    return zdt[..., :z.shape[-1]], xbc, zdt[..., z.shape[-1]:]


def mamba_block_decode(params: dict, x: torch.Tensor, ssm_state: torch.Tensor,
                       conv_state: torch.Tensor, cfg: ModelConfig,
                       split=None, tp=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, 1, D) against (ssm (B,H,P,N) fp32, conv (B,W-1,C)) ->
    (out (B, 1, D), new ssm, new conv).  A placed decode passes ``split``
    (a :class:`repro_torch.dist.sharding.LeafSplit` of the SSM state, or
    None where it holds every head) and ``tp`` (its
    :class:`repro_torch.dist.sharding.TensorSplit`): the layer computes
    this rank's SSM heads (:func:`heads_of`), the block ``ssm`` holds,
    with the whole conv window (:func:`_decode_proj`), and ``out_proj``'s
    rows complete the output over "model" (:func:`_gate_out`)."""
    hs = heads_of(tp)
    held = None if split is None else split.heads
    if hs != held:
        raise ValueError(f"this rank computes SSM heads {hs} and its "
                         f"cache block holds {held}: the two must be one "
                         f"block")
    z, xbc, dt = _decode_proj(params, x, cfg, hs)
    y, ssm, conv = _recur(params, xbc, dt, ssm_state, conv_state, cfg,
                          heads=hs)
    return _gate_out(params, y, z, cfg, tp), ssm, conv


def mamba_block_verify(params: dict, x: torch.Tensor, ssm_state: torch.Tensor,
                       conv_state: torch.Tensor, cfg: ModelConfig,
                       ssm_steps: Optional[torch.Tensor] = None,
                       conv_steps: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Consume T tokens in order for speculative verification, keeping
    every intermediate state: ``(y (B,T,D), ssm_steps (B,T+1,H,P,N),
    conv_steps (B,T+1,W-1,C))``, step ``j`` the state after ``j`` tokens
    (index 0 the incoming state, so a zero-advance row commits cleanly);
    the step tensors are written into ``ssm_steps``/``conv_steps`` when
    given.  The state update is T decode steps; the projections take all
    T rows in one call each (each row's arithmetic is the decode step's).
    """
    b, t, _ = x.shape
    if ssm_steps is None:
        ssm_steps = ssm_state.new_empty((b, t + 1)
                                        + tuple(ssm_state.shape[1:]))
        conv_steps = conv_state.new_empty((b, t + 1)
                                          + tuple(conv_state.shape[1:]))
    ssm_steps[:, 0] = ssm_state
    conv_steps[:, 0] = conv_state
    z, xbc, dt = _split_proj(params, x, cfg)
    y, _, _ = _recur(params, xbc, dt, ssm_state, conv_state, cfg,
                     ssm_steps, conv_steps)
    return _gate_out(params, y, z, cfg), ssm_steps, conv_steps


# ---------------------------------------------------------------------------
# Full model: a decoder of stacked mamba blocks.
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> dict:
    return {"norm": init_rms_norm(cfg.d_model, dtype, device),
            "mixer": init_mamba_block(gen, cfg, dtype, device)}


def init(gen: torch.Generator, cfg: ModelConfig,
         device=DEFAULT_DEVICE) -> dict:
    """Random parameters (the reference's shapes and distributions, other
    numbers: the draws come from ``gen``), the layers made one at a time
    into their stack (peak memory: the weights plus one layer)."""
    dtype = cfg.param_dtype
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    layers = stack_init(cfg.n_layers,
                        lambda _: init_layer(gen, cfg, dtype, device))
    return {"embed": embed, "layers": layers,
            "final_norm": init_rms_norm(cfg.d_model, dtype, device)}


def _layer_fn(layer: dict, x: torch.Tensor, cfg: ModelConfig, tp=None
              ) -> torch.Tensor:
    h = rms_norm(x, layer["norm"]["scale"], cfg.norm_eps)
    return x + mamba_block(layer["mixer"], h, cfg, tp)


def run_layers(layers: dict, x: torch.Tensor, cfg: ModelConfig,
               start: int = 0, stop: Optional[int] = None,
               tp=None) -> torch.Tensor:
    """Layers ``start .. stop - 1`` of the full-sequence forward; under
    ``cfg.remat`` with grad enabled each is recomputed whole in the
    backward (the reference's ``nothing_saveable`` policy), a placed
    layer's gather and collectives inside; ``tp`` computes each layer's
    SSM heads on this rank's block."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(start, cfg.n_layers if stop is None else stop):
        x = run_layer(_layer_fn, layers, i, x, cfg, tp, remat=remat)
    return x


def apply(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
          frontend_embeds=None, tp=None) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits (B, S, V); ``S`` a multiple
    of ``cfg.ssm_chunk``.  ``frontend_embeds`` is unused.  Under ``tp``
    (the model-local view's
    :class:`repro_torch.dist.sharding.TensorSplit`) this rank's block of
    the vocabulary (B, S, V / model) where it splits."""
    del frontend_embeds
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype, tp)
    x = run_layers(params["layers"], x, cfg, tp=tp)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            rows=None, tp=None) -> torch.Tensor:
    """Next-token cross-entropy; ``rows`` and ``tp`` as in
    :func:`repro_torch.models.transformer.loss_fn`."""
    logits = apply(params, batch["tokens"], cfg, tp=tp)
    return cross_entropy(logits, batch["labels"], cfg, rows, tp)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=DEFAULT_DEVICE) -> dict:
    del max_len  # the state is O(1) in sequence length
    return init_ssm_cache(cfg, batch, cfg.n_layers, cfg.compute_dtype,
                          device)


#: cache leaves that are truly recurrent (cannot rewind): a speculative
#: rollback re-commits them at the accepted length from the snapshots
RECURRENT_CACHE_KEYS = ("ssm", "conv")


def new_states(cfg: ModelConfig, cache: dict, t: int) -> dict:
    """Empty ``(L, B, T+1, ...)`` snapshot tensors of the recurrent leaves
    of ``cache`` (layer axis first, the time axis after the batch)."""
    return {key: cache[key].new_empty(
        cache[key].shape[:2] + (t + 1,) + tuple(cache[key].shape[2:]))
        for key in RECURRENT_CACHE_KEYS}


def verify_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, dict, dict]:
    """Speculative append-and-score: tokens (B, T) -> (logits (B, T, V),
    the cache after all T tokens, states).  ``states[key]`` is
    ``cache[key]`` with a T+1 time axis after the batch axis (index j =
    the state after j tokens); ``cache`` itself is not written (the
    returned leaves are views of the last snapshot).  ``position`` is
    unused: the state carries time."""
    del position
    t = tokens.shape[1]
    states = new_states(cfg, cache, t)
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm"]["scale"], cfg.norm_eps)
        out, _, _ = mamba_block_verify(
            layer["mixer"], h, cache["ssm"][i], cache["conv"][i], cfg,
            states["ssm"][i], states["conv"][i])
        x = x + out
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x), {
        key: states[key][:, :, -1] for key in RECURRENT_CACHE_KEYS}, states


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig, split=None,
                tp=None) -> Tuple[torch.Tensor, dict]:
    """One decode step -> (logits (B, V), cache updated in place);
    ``split`` (a :class:`repro_torch.dist.sharding.DecodeSplit`) and
    ``tp`` (the model-local view's
    :class:`repro_torch.dist.sharding.TensorSplit`) are a placed
    decode's: each layer computes this rank's SSM heads, the block its
    SSM state holds (:func:`mamba_block_decode`), and the logits are this
    rank's block of the vocabulary where it splits."""
    del position  # the state carries time
    ssm_split = leaf_split(split, "ssm")
    x = embed_lookup(params["embed"], tokens[:, None], cfg.compute_dtype,
                     tp)
    for i in range(cfg.n_layers):
        layer = layer_params(params["layers"], i)
        h = rms_norm(x, layer["norm"]["scale"], cfg.norm_eps)
        out, ssm, conv = mamba_block_decode(
            layer["mixer"], h, cache["ssm"][i], cache["conv"][i], cfg,
            ssm_split, tp)
        cache["ssm"][i] = ssm
        cache["conv"][i] = conv
        x = x + out
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["embed"], x, tp)[:, 0], cache
