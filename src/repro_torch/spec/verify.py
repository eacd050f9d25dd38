"""Acceptance math for speculative decoding (port of
:mod:`repro.spec.verify`).

Notation: a slot's verify batch feeds ``T = k + 1`` tokens
``[t_0, d_1 .. d_k]`` (the pending token plus k drafts) and gets back
target logits ``L_0 .. L_k`` where ``L_i`` scores the token FOLLOWING
position ``i``, which is what ``decode_step`` would emit feeding the same
tokens one at a time.  Acceptance finds the longest prefix of drafts the
target agrees with (``n``), and the slot always advances by ``n + 1``
tokens: the accepted drafts ``d_1 .. d_n`` plus one token drawn from
``L_n`` (the greedy correction or rejection resample when ``n < k``, the
bonus token when ``n == k``).

Random draws come from an explicit ``torch.Generator`` on the logits'
device, so sampled acceptance agrees with the reference's ``jax.random``
draws as a distribution only; greedy acceptance is exact.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.serving import sampler as sampler_mod


def greedy_accept(logits: torch.Tensor, drafts: torch.Tensor):
    """Exact-match acceptance: ``(n_accepted (B,), next_token (B,))``.

    ``logits`` (B, k+1, V), ``drafts`` (B, k).  A draft is accepted iff it
    equals the target argmax at its position, so the committed stream is
    the non-speculative greedy stream whatever the draft proposes.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)       # (B, k+1)
    match = (greedy[:, :-1] == drafts).to(torch.int32)           # (B, k)
    n = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)   # (B,)
    nxt = torch.gather(greedy, 1, n.long()[:, None])[:, 0]
    return n, nxt


def _gumbel_argmax(logp: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1).to(
        torch.int32)


def rejection_accept(generator: Optional[torch.Generator],
                     logits: torch.Tensor, draft_logits: torch.Tensor,
                     drafts: torch.Tensor, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 0.0):
    """Speculative rejection sampling (Leviathan et al. 2023).

    ``logits`` (B, k+1, V) target scores, ``draft_logits`` (B, k, V) the
    draft's scores before filtering, ``drafts`` (B, k) tokens SAMPLED from
    the draft distribution.  Both distributions go through the sampler's
    temperature / top-k / top-p pipeline, so the committed stream is
    distributed as non-speculative sampling from the target.  Accept
    ``d_i`` while ``u_i q(d_i) < p(d_i)``; the first rejection resamples
    from ``norm(max(p - q, 0))``; full acceptance draws the bonus token
    from ``p`` (``q`` padded with zeros at position k).  The resample is a
    Gumbel-max draw, as the sampler's.
    """
    def dist(lg):
        lf = lg.float() / max(temperature, 1e-6)
        lf = sampler_mod.apply_top_k(lf, top_k)
        lf = sampler_mod.apply_top_p(lf, top_p)
        return torch.softmax(lf, dim=-1)

    b, k = drafts.shape
    p = dist(logits)                                             # (B,k+1,V)
    q = dist(draft_logits)                                       # (B,k,V)
    idx = drafts.long()[..., None]
    p_tok = torch.gather(p[:, :k], 2, idx)[..., 0]
    q_tok = torch.gather(q, 2, idx)[..., 0]
    u = torch.rand((b, k), generator=generator, device=p.device)
    accept = (u * q_tok < p_tok).to(torch.int32)                 # (B,k)
    n = torch.cumprod(accept, dim=1).sum(dim=1).to(torch.int32)  # (B,)

    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    sel = n.long()[:, None, None].expand(b, 1, p.shape[-1])
    p_n = torch.gather(p, 1, sel)[:, 0]
    q_n = torch.gather(q_pad, 1, sel)[:, 0]
    res = torch.clamp_min(p_n - q_n, 0.0)
    mass = res.sum(dim=-1, keepdim=True)
    # p == q exactly leaves no residual mass: fall back to p itself
    res = torch.where(mass > 0, res / torch.clamp_min(mass, 1e-30), p_n)
    nxt = _gumbel_argmax(torch.log(torch.clamp_min(res, 1e-30)), generator)
    return n, nxt


def committed_tokens(drafts: torch.Tensor, n: torch.Tensor,
                     nxt: torch.Tensor) -> torch.Tensor:
    """The committed stream ``(B, k+1)``: accepted drafts ``d_1 .. d_n``
    then the correction or bonus token at index ``n`` (entries beyond
    index ``n`` are junk the host never reads)."""
    k = drafts.shape[1]
    padded = torch.cat([drafts, drafts[:, -1:]], dim=1)          # (B, k+1)
    sel = (torch.arange(k + 1, device=drafts.device)[None, :]
           == n.long()[:, None])
    return torch.where(sel, nxt.to(padded.dtype)[:, None],
                       padded).to(torch.int32)


def commit_states(cache: dict, states: dict, n_adv: torch.Tensor) -> dict:
    """Re-commit recurrent cache leaves at each row's accepted length.

    ``states[key]`` is ``cache[key]`` with a time axis inserted after the
    batch axis, ``(L, B, T+1, ...)`` (index j = the state after j consumed
    tokens), and ``n_adv (B,)`` is each row's consumed count (0 for parked
    or stalled rows, which keep their incoming state).  The ssm and
    hybrid families' verify steps pass their SSM/conv snapshots here; the
    decoder has no recurrent leaves and passes none.
    """
    new = dict(cache)
    for key, s in states.items():
        idx = n_adv.long().reshape((1, -1, 1) + (1,) * (s.ndim - 3))
        idx = idx.expand(s.shape[:2] + (1,) + s.shape[3:])
        new[key] = torch.gather(s, 2, idx)[:, :, 0].to(cache[key].dtype)
    return new
