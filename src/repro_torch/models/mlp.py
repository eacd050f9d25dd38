"""Gated MLP (SwiGLU/GeGLU) and Mixture-of-Experts feed-forward layers
(port of :mod:`repro.models.mlp`).

The MoE layer is the reference's fine-grained experts with shared
experts (DeepSeekMoE / Moonlight: e.g. 64 routed top-6 + 2 shared) and
capacity-based dispatch:

    router probs -> top-k -> position-in-expert -> dispatch to (E, C, D)
    -> expert FFNs -> combine

Expert weights carry a leading E axis.  The experts run GROUPED, as the
reference's ``jax.vmap`` over E runs them: one call of each projection
over the ``(E, C, D)`` dispatch buffer with the stacked weights (a batched
matmul for dense experts; for SELL experts, whose default targets
``mlp_in``/``mlp_out`` match the experts' roles, one grouped cascade with
per-expert diagonals: :mod:`repro_torch.kernels.ops`), never a loop of E
calls.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.models import linear
from repro_torch.models.common import ModelConfig, stack_init


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> dict:
    d_ff = d_ff or cfg.d_ff
    return {
        "wg": linear.linear_init(gen, cfg.d_model, d_ff, cfg, "mlp_in",
                                 dtype, device),
        "wu": linear.linear_init(gen, cfg.d_model, d_ff, cfg, "mlp_in",
                                 dtype, device),
        "wd": linear.linear_init(gen, d_ff, cfg.d_model, cfg, "mlp_out",
                                 dtype, device),
    }


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
        d_ff: Optional[int] = None, tp=None) -> torch.Tensor:
    """The gated MLP.  Under ``tp`` (a
    :class:`repro_torch.dist.sharding.TensorSplit`) with dense ``wg`` /
    ``wu`` on their block of ffn columns, this rank computes those
    columns and its partial sum of ``wd``, summed over "model"."""
    y, partial = _mlp_part(params, x, cfg, d_ff, tp)
    return tp.reduce(y) if partial else y


def _mlp_part(params: dict, x: torch.Tensor, cfg: ModelConfig,
              d_ff: Optional[int] = None, tp=None, x_in=None):
    """(y, partial): :func:`mlp`'s output, or with the ffn split this
    rank's partial sum of it (``partial`` True) for the caller to reduce.
    ``x_in`` is ``tp.copy(x)`` when the caller made it already."""
    d_ff = d_ff or cfg.d_ff
    split = tp is not None and linear.splits_out(params["wg"], d_ff)
    if split:
        x = tp.copy(x) if x_in is None else x_in
    g = linear.linear_apply(params["wg"], x, cfg.d_model, d_ff, cfg,
                            "mlp_in", tp)
    u = linear.linear_apply(params["wu"], x, cfg.d_model, d_ff, cfg,
                            "mlp_in", tp)
    h = _act(cfg.mlp_act, g) * u
    return linear.linear_apply(params["wd"], h, d_ff, cfg.d_model, cfg,
                               "mlp_out", tp, partial=True), split


# ---------------------------------------------------------------------------
# Mixture of Experts.
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> dict:
    """Router ``w`` (D, E), the routed experts' MLPs stacked with a leading
    E axis, and the shared expert (``d_ff * n_shared_experts`` wide)."""
    e = cfg.n_experts
    p = {
        "router": {"w": (cfg.d_model ** -0.5) * torch.randn(
            (cfg.d_model, e), generator=gen, dtype=dtype, device=device)},
        "experts": stack_init(e, lambda _: init_mlp(gen, cfg, cfg.d_ff,
                                                    dtype, device)),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = init_mlp(gen, cfg, cfg.d_ff * cfg.n_shared_experts,
                               dtype, device)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows each expert takes for ``tokens`` routed tokens."""
    return max(int(cfg.capacity_factor * tokens * cfg.top_k
                   / cfg.n_experts), 1)


def _expert_ffn(wp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h (E, C, D) through the E experts' stacked MLPs, grouped."""
    return mlp(wp, h, cfg, cfg.d_ff)


def _router_probs(xt: torch.Tensor, params: dict) -> torch.Tensor:
    logits = torch.matmul(xt.float(), params["router"]["w"].float())
    return torch.softmax(logits, dim=-1)                            # (T, E)


def _route(xt: torch.Tensor, params: dict, cfg: ModelConfig, rows=None):
    """The router -> (gate_vals, gate_idx, pos, keep, cap, onehot): the
    renormalised top-k gates (zero where dropped), each (token, slot)'s
    expert and position in its queue (token-major, slot-minor), whether it
    is kept under the capacity ``cap``, and the (T, k, E) one-hot.

    ``rows`` (a :class:`repro_torch.dist.sharding.Blocks`: a placed
    step's batch split over ranks, ``xt`` this rank's block of the
    tokens) makes the queues the whole batch's: the capacity of all the
    blocks' tokens, and each expert's queue entered after the earlier
    blocks' tokens, as one call over the whole batch enters it."""
    return _routing(xt, params, cfg, rows)[:6]


def _routing(xt: torch.Tensor, params: dict, cfg: ModelConfig, rows=None):
    """:func:`_route`'s six, then ``first`` (E,): where this block's
    tokens enter each expert's queue (zero without ``rows``)."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t if rows is None else t * rows.n)
    probs = _router_probs(xt, params)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)              # (T, k)
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True)
                             + 1e-9)
    onehot = torch.nn.functional.one_hot(gate_idx, e).float()      # (T,k,E)
    flat = onehot.reshape(t * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
    first = torch.zeros((e,), device=xt.device)
    if rows is not None:    # the earlier blocks' tokens queue first
        counts = rows.gather(flat.sum(dim=0))                       # (n, E)
        first = counts[:rows.index].sum(dim=0)
        pos_in_expert = pos_in_expert + first
    pos = torch.sum(pos_in_expert * onehot, dim=-1)                 # (T, k)
    keep = pos < cap                                 # the capacity drop
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return (gate_vals, gate_idx, pos.to(torch.int32), keep, cap, onehot,
            first)


class _Buffer(NamedTuple):
    """Which dispatch buffer rows this rank fills: experts ``e0 .. e0 +
    n - 1`` (its "model" block of them), ``size`` rows each, a (token,
    slot) at row ``slot`` of its expert's (its queue position less where
    this block of the batch entered the queue: the rows are independent,
    so a block of a placed batch fills only the rows its own tokens
    take)."""
    e0: int
    n: int
    slot: torch.Tensor
    size: int


def _moe_einsum(params, xt, cfg, gate_vals, gate_idx, pos, keep, cap,
                onehot, buf: Optional[_Buffer] = None):
    """The one-hot (GShard/Switch) dispatch and combine: O(T E C D)."""
    if buf is None:
        buf = _Buffer(0, cfg.n_experts, pos, cap)
    # a dropped slot's position is past the queue: its row is all zero,
    # as jax.nn.one_hot gives for an index out of range
    pos_oh = (buf.slot[..., None] == torch.arange(
        buf.size, device=pos.device)).float()                      # (T,k,C)
    onehot = onehot[..., buf.e0:buf.e0 + buf.n]
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep[..., None],
                            pos_oh)
    combine = torch.einsum("tke,tkc->tec", onehot * gate_vals[..., None],
                           pos_oh)
    h = torch.einsum("td,tec->ecd", xt.float(), dispatch).to(xt.dtype)
    y_exp = _expert_ffn(params["experts"], h, cfg)                 # (E, C, D)
    y = torch.einsum("ecd,tec->td", y_exp.float(), combine)
    return y.to(xt.dtype)


def _moe_scatter(params, xt, cfg, gate_vals, gate_idx, pos, keep, cap,
                 buf: Optional[_Buffer] = None):
    """Scatter/gather dispatch: O(T k D) data movement.  Every kept
    (token, slot) owns a distinct row of the ``(E cap + 1, D)`` buffer, so
    the ``index_add_`` adds each into zeros once (deterministic on the
    card too); the dropped ones all go to the last row, which is never
    read.  ``buf``: this rank's rows of it (:class:`_Buffer`); a slot of
    another rank's expert goes to the last row too."""
    t, d = xt.shape
    k = cfg.top_k
    if buf is None:
        buf = _Buffer(0, cfg.n_experts, pos, cap)
    e, size = buf.n, buf.size
    local = gate_idx - buf.e0
    dest = local * size + buf.slot                                  # (T, k)
    mine = keep & (local >= 0) & (local < e)
    dest = torch.where(mine, dest, torch.full_like(dest, e * size))
    rows = torch.zeros((e * size + 1, d), dtype=torch.float32,
                       device=xt.device)
    src = xt.float()[:, None, :].expand(t, k, d).reshape(-1, d)
    rows.index_add_(0, dest.reshape(-1).long(), src)
    h = rows[: e * size].reshape(e, size, d).to(xt.dtype)
    y_exp = _expert_ffn(params["experts"], h, cfg)                 # (E, C, D)
    flat = torch.cat([y_exp.reshape(e * size, d).float(),
                      torch.zeros((1, d), dtype=torch.float32,
                                  device=xt.device)], dim=0)
    gathered = flat[dest.long()]                                   # (T, k, D)
    y = torch.sum(gathered * gate_vals[..., None], dim=1)
    return y.to(xt.dtype)


def _n_experts_here(experts: dict) -> int:
    """The experts an expert stack holds (its leading dim)."""
    leaf = experts
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def moe(params: dict, x: torch.Tensor, cfg: ModelConfig,
        rows=None, tp=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): capacity-based top-k dispatch over the
    B*S tokens (``cfg.moe_impl`` "scatter" or the one-hot einsums), then
    the shared expert added.  With ``rows`` (a placed step's batch split
    over ranks, :func:`_route`) ``x`` is this rank's rows, the capacity
    queues are the whole batch's, and the dispatch buffer holds the rows
    this block's tokens take (at most ``min(cap, B*S)`` an expert).

    Under ``tp`` (a :class:`repro_torch.dist.sharding.TensorSplit`) with
    the experts on their "model" block, every model rank routes the same
    tokens whole (the router is gathered whole: its softmax is over all
    experts), dispatches only to its ``E / model`` experts and the
    outputs are summed over "model", with the shared expert's partial
    sums where its ffn splits too."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gate_vals, gate_idx, pos, keep, cap, onehot, first = _routing(
        xt, params, cfg, rows)
    n_here = _n_experts_here(params["experts"])
    split = tp is not None and n_here < cfg.n_experts
    buf = None
    if rows is not None or split:
        slot = pos - first[gate_idx.long()].to(pos.dtype)
        size = cap if rows is None else min(cap, b * s)
        e0 = tp.block(cfg.n_experts, n_here).start if split else 0
        buf = _Buffer(e0, n_here, slot, size)
    x_in = None
    if split:   # the experts' share of the gradients sums over "model"
        x_in = tp.copy(x)
        xt, gate_vals = x_in.reshape(b * s, d), tp.copy(gate_vals)
    if cfg.moe_impl == "scatter":
        y = _moe_scatter(params, xt, cfg, gate_vals, gate_idx, pos, keep,
                         cap, buf)
    else:
        y = _moe_einsum(params, xt, cfg, gate_vals, gate_idx, pos, keep,
                        cap, onehot, buf)
    y = y.reshape(b, s, d)
    partials, fulls = ([y], []) if split else ([], [y])
    if "shared" in params:
        ys, partial = _mlp_part(params["shared"], x, cfg,
                                cfg.d_ff * cfg.n_shared_experts, tp, x_in)
        (partials if partial else fulls).append(ys)
    terms = fulls
    if partials:
        terms = [tp.reduce(sum(partials[1:], partials[0]))] + fulls
    return sum(terms[1:], terms[0])


def moe_aux_loss(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 rows=None) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style f * P).  With ``rows``
    (a placed train step's :class:`repro_torch.dist.sharding.Rows`) ``x``
    is this rank's rows and both fractions are the whole batch's: the
    top-1 counts and the probabilities summed over the rows, the latter
    differentiably (each rank's gradient is its own rows' share)."""
    probs = _router_probs(x.reshape(-1, x.shape[-1]), params)
    top1 = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(top1, cfg.n_experts).float()
    if rows is None:
        frac_tokens = onehot.mean(dim=0)
        frac_probs = torch.mean(probs, dim=0)
    else:
        t = probs.shape[0] * rows.n
        frac_tokens = rows.sum(onehot.sum(dim=0)).detach() / t
        frac_probs = rows.sum(torch.sum(probs, dim=0)) / t
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
