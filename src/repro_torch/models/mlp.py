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

from typing import Optional

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
        d_ff: Optional[int] = None) -> torch.Tensor:
    d_ff = d_ff or cfg.d_ff
    g = linear.linear_apply(params["wg"], x, cfg.d_model, d_ff, cfg,
                            "mlp_in")
    u = linear.linear_apply(params["wu"], x, cfg.d_model, d_ff, cfg,
                            "mlp_in")
    h = _act(cfg.mlp_act, g) * u
    return linear.linear_apply(params["wd"], h, d_ff, cfg.d_model, cfg,
                               "mlp_out")


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
    if rows is not None:    # the earlier blocks' tokens queue first
        counts = rows.gather(flat.sum(dim=0))                       # (n, E)
        pos_in_expert = pos_in_expert + counts[:rows.index].sum(dim=0)
    pos = torch.sum(pos_in_expert * onehot, dim=-1)                 # (T, k)
    keep = pos < cap                                 # the capacity drop
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return gate_vals, gate_idx, pos.to(torch.int32), keep, cap, onehot


def _moe_einsum(params, xt, cfg, gate_vals, gate_idx, pos, keep, cap,
                onehot):
    """The one-hot (GShard/Switch) dispatch and combine: O(T E C D)."""
    # a dropped slot's position is past the queue: its row is all zero,
    # as jax.nn.one_hot gives for an index out of range
    pos_oh = (pos[..., None] == torch.arange(
        cap, device=pos.device)).float()                           # (T,k,C)
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep[..., None],
                            pos_oh)
    combine = torch.einsum("tke,tkc->tec", onehot * gate_vals[..., None],
                           pos_oh)
    h = torch.einsum("td,tec->ecd", xt.float(), dispatch).to(xt.dtype)
    y_exp = _expert_ffn(params["experts"], h, cfg)                 # (E, C, D)
    y = torch.einsum("ecd,tec->td", y_exp.float(), combine)
    return y.to(xt.dtype)


def _moe_scatter(params, xt, cfg, gate_vals, gate_idx, pos, keep, cap):
    """Scatter/gather dispatch: O(T k D) data movement.  Every kept
    (token, slot) owns a distinct row of the ``(E cap + 1, D)`` buffer, so
    the ``index_add_`` adds each into zeros once (deterministic on the
    card too); the dropped ones all go to the last row, which is never
    read."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dest = gate_idx * cap + pos                                     # (T, k)
    dest = torch.where(keep, dest, torch.full_like(dest, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=torch.float32,
                      device=xt.device)
    src = xt.float()[:, None, :].expand(t, k, d).reshape(-1, d)
    buf.index_add_(0, dest.reshape(-1).long(), src)
    h = buf[: e * cap].reshape(e, cap, d).to(xt.dtype)
    y_exp = _expert_ffn(params["experts"], h, cfg)                 # (E, C, D)
    flat = torch.cat([y_exp.reshape(e * cap, d).float(),
                      torch.zeros((1, d), dtype=torch.float32,
                                  device=xt.device)], dim=0)
    gathered = flat[dest.long()]                                   # (T, k, D)
    y = torch.sum(gathered * gate_vals[..., None], dim=1)
    return y.to(xt.dtype)


def moe(params: dict, x: torch.Tensor, cfg: ModelConfig,
        rows=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): capacity-based top-k dispatch over the
    B*S tokens (``cfg.moe_impl`` "scatter" or the one-hot einsums), then
    the shared expert added.  With ``rows`` (a placed serving step's
    batch split over ranks, :func:`_route`) ``x`` is this rank's rows and
    the capacity queues are the whole batch's."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gate_vals, gate_idx, pos, keep, cap, onehot = _route(xt, params, cfg,
                                                         rows)
    if cfg.moe_impl == "scatter":
        y = _moe_scatter(params, xt, cfg, gate_vals, gate_idx, pos, keep,
                         cap)
    else:
        y = _moe_einsum(params, xt, cfg, gate_vals, gate_idx, pos, keep,
                        cap, onehot)
    y = y.reshape(b, s, d)
    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg,
                    cfg.d_ff * cfg.n_shared_experts)
    return y


def moe_aux_loss(params: dict, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style f * P)."""
    probs = _router_probs(x.reshape(-1, x.shape[-1]), params)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = torch.nn.functional.one_hot(
        top1, cfg.n_experts).float().mean(dim=0)
    frac_probs = torch.mean(probs, dim=0)
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
