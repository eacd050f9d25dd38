"""The plain reference: the benchmark's configurations written out in
plain PyTorch, fp32, with no kernel, no cache and no batching of
requests.  It imports nothing of the program.

Parameters are a flat dict ``{path: tensor}`` keyed as the benchmark
hands them to both sides (``layers/attn/wq/w`` with a leading layer
axis; an expert stack with a leading expert axis after it).  Everything
the program derives from them is worked out here again: the DCT-II
matrices (paper eq. 9, in float64 and rounded once), the riffle, the
RoPE angles, the MoE capacities and queues.

The family equations:

* decoder (DeepSeekMoE): pre-norm layers ``x += attn(rms(x))``, ``x +=
  ffn(rms(x))``; causal attention with RoPE on q and k; an MoE ffn:
  softmax router, top-k gates renormalised, each (token, slot) queued
  token-major into its expert and dropped past ``int(capacity_factor T
  k / E)``, plus the shared expert; the loss adds 0.01 times the layers'
  mean load-balance term ``E sum(f_top1 P)``;
* encdec (Seamless-M4T): a bidirectional encoder over the frames (no
  RoPE, no mask), then decoder layers of causal self-attention with
  RoPE, cross-attention over the encoder states (no RoPE, no mask) and
  the GeGLU MLP (tanh GELU);
* a SELL projection ``n_in -> n_out`` is an order-``sell_k`` ACDC
  cascade at ``N = n_op``: input zero-padded to N, each layer ``h <-
  ((h a_i) C d_i) C^T``, the riffle between layers, output truncated;
* the logits are the final norm's output against the embedding table
  (the program ties them); the loss is the masked mean cross-entropy.

``Arith`` is where the arithmetic's precision lives: ``fp32`` (TF32
off) for the reference, ``fp8`` for the control, which rounds both
operands of every product to float8 e4m3 (per-tensor scale) and, in the
backward, the incoming gradient to e5m2.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def _quant(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to ``top``, returned in fp32."""
    t = t.float()
    amax = t.abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (t * scale).to(dtype).float() / scale


def q_e4m3(t):
    return _quant(t, torch.float8_e4m3fn, 448.0)


def q_e5m2(t):
    return _quant(t, torch.float8_e5m2, 57344.0)


def q_bf16(t):
    return t.float().to(torch.bfloat16).float()


#: each arithmetic's rounding of a product's operands and of its gradient
ROUNDING = {"fp8": (q_e4m3, q_e5m2), "bf16": (q_bf16, q_bf16)}


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        q = ROUNDING[mode][0]
        qa, qb = q(a), q(b)
        ctx.save_for_backward(qa, qb)
        ctx.mode = mode
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        gq = ROUNDING[ctx.mode][1](g)
        ga = torch.matmul(gq, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), gq)
        # broadcast operands take the sum over their broadcast axes
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        for i, (n, m) in enumerate(zip(qa.shape, ga.shape)):
            if n == 1 and m != 1:
                ga = ga.sum(i, keepdim=True)
        for i, (n, m) in enumerate(zip(qb.shape, gb.shape)):
            if n == 1 and m != 1:
                gb = gb.sum(i, keepdim=True)
        return ga, gb, None


class _RoundedByConstant(torch.autograd.Function):
    """``a @ qb`` for a constant ``qb`` already rounded (a transform
    matrix): kept once, not copied into every product's saved
    tensors."""

    @staticmethod
    def forward(ctx, a, qb, mode):
        qa = ROUNDING[mode][0](a)
        ctx.save_for_backward(qb)
        ctx.mode = mode
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        (qb,) = ctx.saved_tensors
        return (torch.matmul(ROUNDING[ctx.mode][1](g), qb.transpose(-1, -2)),
                None, None)


class Arith:
    """The precision of every product: ``"fp32"``, or its operands and
    gradients rounded to ``"fp8"`` (e4m3 and e5m2 under per-tensor
    scales: the control) or ``"bf16"`` (a witness of what bf16 alone
    does)."""

    def __init__(self, mode: str = "fp32"):
        if mode != "fp32" and mode not in ROUNDING:
            raise ValueError(f"unknown arithmetic {mode!r}")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return torch.matmul(a, b)
        return _RoundedMatmul.apply(a, b, self.mode)

    def constant(self, b: torch.Tensor) -> torch.Tensor:
        """A constant operand as :meth:`by_constant` takes it."""
        return b if self.mode == "fp32" else ROUNDING[self.mode][0](b)

    def by_constant(self, a: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
        """``a @ b`` for ``qb = constant(b)``."""
        if self.mode == "fp32":
            return torch.matmul(a, qb)
        return _RoundedByConstant.apply(a, qb, self.mode)


FP32 = Arith("fp32")


def dct_matrix(n: int, device) -> torch.Tensor:
    """Orthonormal DCT-II ``C`` (``y = x C``), float64 then fp32."""
    k = np.arange(n)[None, :]
    m = np.arange(n)[:, None]
    mat = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n)) * np.sqrt(2.0 / n)
    mat[:, 0] /= np.sqrt(2.0)
    return torch.from_numpy(mat).to(device=device, dtype=torch.float32)


def riffle(n: int) -> np.ndarray:
    """The perfect shuffle ``[0, n/2, 1, n/2 + 1, ...]``."""
    half = (n + 1) // 2
    idx = np.empty((n,), dtype=np.int64)
    idx[0::2] = np.arange(half)
    idx[1::2] = np.arange(half, n)
    return idx


def n_op(n_in: int, n_out: int, lane: int = 128) -> int:
    n = max(n_in, n_out)
    return -(-n // lane) * lane


class Model:
    """One configuration (a configuration file's ``model`` dict) and the
    transform constants it needs on ``device``."""

    def __init__(self, cfg: dict, device, arith: Arith = FP32):
        self.cfg = cfg
        self.device = torch.device(device)
        self.arith = arith
        self.dh = cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]
        self._mats = {}

    # -- SELL --------------------------------------------------------------

    def uses_sell(self, role: str) -> bool:
        cfg = self.cfg
        return cfg["sell_kind"] != "dense" and any(
            role.startswith(t) for t in cfg["sell_targets"])

    def _mat(self, n: int):
        if n not in self._mats:
            c = dct_matrix(n, self.device)
            perm = torch.from_numpy(riffle(n)).to(self.device)
            self._mats[n] = (self.arith.constant(c),
                             self.arith.constant(c.t().contiguous()), perm)
        return self._mats[n]

    def acdc(self, p: Params, pre: str, x: torch.Tensor, n_in: int,
             n_out: int) -> torch.Tensor:
        """The cascade at ``pre + "sell/{a,d}"`` (``(..., K, N)``; a
        leading expert axis applies expert ``e``'s diagonals to ``x[e]``)."""
        cfg = self.cfg
        if cfg["sell_kind"] != "acdc" or cfg["sell_transform"] != "acdc":
            raise ValueError("the reference has the DCT ACDC cascade only")
        n = n_op(n_in, n_out)
        c, ct, perm = self._mat(n)
        a, d = p[pre + "sell/a"], p[pre + "sell/d"]
        h = torch.nn.functional.pad(x, (0, n - n_in))
        k = a.shape[-2]

        def diag(v):   # (N,) or a grouped (G, N) against h (G, ..., N)
            if v.dim() == 1:
                return v
            return v.reshape(v.shape[0], *([1] * (h.dim() - 2)), n)

        for i in range(k):
            h = self.arith.by_constant(h * diag(a[..., i, :]), c)
            h = self.arith.by_constant(h * diag(d[..., i, :]), ct)
            if i < k - 1:
                if cfg["sell_relu"]:
                    h = torch.relu(h)
                if cfg["sell_permute"]:
                    h = h[..., perm]
        return h[..., :n_out]

    def proj(self, p: Params, pre: str, x: torch.Tensor, n_in: int,
             n_out: int, role: str) -> torch.Tensor:
        if self.uses_sell(role):
            return self.acdc(p, pre, x, n_in, n_out)
        return self.arith.mm(x, p[pre + "w"])

    # -- blocks ------------------------------------------------------------

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.cfg["norm_eps"]) * (1.0 + scale)

    def rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """x (B, S, H, Dh), positions (B, S): pairs (2i, 2i + 1) rotated."""
        cfg, dh = self.cfg, x.shape[-1]
        rot = int(dh * cfg["rope_fraction"]) // 2 * 2
        if rot == 0:
            return x
        inv = 1.0 / (cfg["rope_theta"] ** (
            torch.arange(0, rot, 2, dtype=torch.float32,
                         device=x.device) / rot))
        ang = positions[..., None].float() * inv
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return torch.cat([out.reshape(*x1.shape[:-1], rot), x[..., rot:]],
                         dim=-1)

    def attn(self, p: Params, pre: str, xq: torch.Tensor,
             xkv: Optional[torch.Tensor], positions: Optional[torch.Tensor],
             causal: bool) -> torch.Tensor:
        """Attention of xq (B, Sq, D) over xkv (B, Sk, D) (``xkv`` None:
        self-attention with RoPE at ``positions``)."""
        cfg, dh = self.cfg, self.dh
        d, hq, hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
        src = xq if xkv is None else xkv
        b, sq, _ = xq.shape
        sk = src.shape[1]
        q = self.proj(p, pre + "wq/", xq, d, hq * dh, "attn_qkv")
        k = self.proj(p, pre + "wk/", src, d, hkv * dh, "attn_qkv")
        v = self.proj(p, pre + "wv/", src, d, hkv * dh, "attn_qkv")
        q = q.reshape(b, sq, hq, dh)
        k = k.reshape(b, sk, hkv, dh)
        v = v.reshape(b, sk, hkv, dh)
        if cfg["qk_norm"]:
            q = self.rms(q, p[pre + "q_norm/scale"])
            k = self.rms(k, p[pre + "k_norm/scale"])
        if xkv is None:
            q, k = self.rope(q, positions), self.rope(k, positions)
        g = hq // hkv
        qh = q.permute(0, 2, 1, 3)                          # (B, Hq, Sq, Dh)
        kh = k.permute(0, 2, 3, 1).repeat_interleave(g, dim=1)
        vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        s = self.arith.mm(qh, kh) * (dh ** -0.5)            # (B, Hq, Sq, Sk)
        if cfg["attn_logit_softcap"] > 0:
            cap = cfg["attn_logit_softcap"]
            s = cap * torch.tanh(s / cap)
        if causal:
            mask = positions[:, None, :, None] >= positions[:, None, None, :]
            if cfg["sliding_window"]:
                raise ValueError("the reference has no sliding window")
            s = torch.where(mask, s, torch.full_like(s, -1e30))
        o = self.arith.mm(torch.softmax(s, dim=-1), vh)     # (B, Hq, Sq, Dh)
        o = o.permute(0, 2, 1, 3).reshape(b, sq, hq * dh)
        return self.proj(p, pre + "wo/", o, hq * dh, d, "attn_out")

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg["mlp_act"] == "silu":
            return torch.nn.functional.silu(x)
        if self.cfg["mlp_act"] == "gelu":
            return torch.nn.functional.gelu(x, approximate="tanh")
        raise ValueError(self.cfg["mlp_act"])

    def mlp(self, p: Params, pre: str, x: torch.Tensor,
            d_ff: int) -> torch.Tensor:
        d = self.cfg["d_model"]
        g = self.proj(p, pre + "wg/", x, d, d_ff, "mlp_in")
        u = self.proj(p, pre + "wu/", x, d, d_ff, "mlp_in")
        return self.proj(p, pre + "wd/", self.act(g) * u, d_ff, d, "mlp_out")

    def moe(self, p: Params, pre: str, x: torch.Tensor):
        """x (B, S, D) -> (out, load-balance term) over the B S tokens."""
        cfg = self.cfg
        b, s, d = x.shape
        t, e, k = b * s, cfg["n_experts"], cfg["top_k"]
        xt = x.reshape(t, d)
        probs = torch.softmax(self.arith.mm(xt, p[pre + "router/w"]), -1)
        gates, idx = torch.topk(probs, k, dim=-1)               # (T, k)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        cap = max(int(cfg["capacity_factor"] * t * k / e), 1)
        # queue position of each (token, slot), token-major, slot-minor
        flat = idx.reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, e)
        pos = (torch.cumsum(onehot, 0) - onehot).gather(
            1, flat[:, None])[:, 0].reshape(t, k)
        keep = pos < cap
        gates = gates * keep
        buf = torch.zeros((e * cap, d), device=x.device)
        dest = torch.where(keep, idx * cap + pos, torch.zeros_like(pos))
        sel = keep.reshape(-1)
        src = xt[:, None, :].expand(t, k, d).reshape(-1, d)
        buf = buf.index_put((dest.reshape(-1)[sel],), src[sel])
        y_exp = self.mlp(p, pre + "experts/", buf.reshape(e, cap, d),
                         cfg["d_ff"]).reshape(e * cap, d)
        y = (y_exp[dest.reshape(-1)].reshape(t, k, d)
             * gates[..., None]).sum(1)
        out = y.reshape(b, s, d)
        if cfg["n_shared_experts"]:
            out = out + self.mlp(p, pre + "shared/", x,
                                 cfg["d_ff"] * cfg["n_shared_experts"])
        top1 = torch.nn.functional.one_hot(probs.argmax(-1), e).float()
        aux = e * torch.sum(top1.mean(0) * probs.mean(0))
        return out, aux

    # -- families ----------------------------------------------------------

    def _layer(self, p: Params, stack: str, i: int) -> Params:
        """Layer ``i`` of the stacked leaves under ``stack``."""
        n = len(stack)
        return {key[n:]: v[i] for key, v in p.items()
                if key.startswith(stack)}

    def decoder_hidden(self, p: Params, tokens: torch.Tensor):
        cfg = self.cfg
        b, s = tokens.shape
        x = p["embed/table"][tokens.long()]
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        auxes = []
        for i in range(cfg["n_layers"]):
            lp = self._layer(p, "layers/", i)
            x = x + self.attn(lp, "attn/", self.rms(x, lp["norm1/scale"]),
                              None, pos, True)
            h = self.rms(x, lp["norm2/scale"])
            if cfg["n_experts"]:
                y, aux = self.moe(lp, "moe/", h)
                auxes.append(aux)
            else:
                y = self.mlp(lp, "mlp/", h, cfg["d_ff"])
            x = x + y
        aux = torch.stack(auxes).mean() if auxes else None
        return self.rms(x, p["final_norm/scale"]), aux

    def encode(self, p: Params, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = frames.float()
        for i in range(cfg["n_encoder_layers"] or cfg["n_layers"]):
            lp = self._layer(p, "encoder/", i)
            h = self.rms(x, lp["norm1/scale"])
            x = x + self.attn(lp, "attn/", h, h, None, False)
            x = x + self.mlp(lp, "mlp/", self.rms(x, lp["norm2/scale"]),
                             cfg["d_ff"])
        return self.rms(x, p["enc_norm/scale"])

    def encdec_hidden(self, p: Params, tokens: torch.Tensor,
                      frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        enc = self.encode(p, frames)
        b, s = tokens.shape
        x = p["embed/table"][tokens.long()]
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        for i in range(cfg["n_layers"]):
            lp = self._layer(p, "decoder/", i)
            x = x + self.attn(lp, "attn/", self.rms(x, lp["norm1/scale"]),
                              None, pos, True)
            x = x + self.attn(lp, "cross/", self.rms(x, lp["norm_x/scale"]),
                              enc, None, False)
            x = x + self.mlp(lp, "mlp/", self.rms(x, lp["norm2/scale"]),
                             cfg["d_ff"])
        return self.rms(x, p["final_norm/scale"])

    def logits(self, p: Params, hidden: torch.Tensor) -> torch.Tensor:
        return self.arith.mm(hidden, p["embed/table"].t())

    def loss(self, p: Params, batch: dict) -> torch.Tensor:
        """The masked mean next-token cross-entropy of ``batch``
        (``tokens``, ``labels``, ``frontend_embeds`` for encdec), plus
        the MoE term."""
        cfg = self.cfg
        aux = None
        if cfg["family"] == "encdec":
            h = self.encdec_hidden(p, batch["tokens"],
                                   batch["frontend_embeds"])
        elif cfg["family"] == "decoder":
            h, aux = self.decoder_hidden(p, batch["tokens"])
        else:
            raise ValueError(f"no reference for family {cfg['family']!r}")
        logits = self.logits(p, h)
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        nll = (torch.logsumexp(logits, -1)
               - logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0])
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        if aux is not None:
            loss = loss + 0.01 * aux
        return loss


def no_tf32() -> None:
    """fp32 products in fp32: TF32 off on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if hasattr(torch, "set_float32_matmul_precision"):
        torch.set_float32_matmul_precision("highest")

