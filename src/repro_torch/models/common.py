"""Model configuration and primitive layers (port of
:mod:`repro.models.common`).

``ModelConfig`` has the reference's fields and defaults, so a config
built here describes the same model.  The primitives are plain functions
on tensors; parameters are dicts of tensors keyed like the reference
pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder"          # decoder | encdec | ssm | hybrid
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1000
    head_dim: Optional[int] = None   # default d_model // n_heads
    max_seq_len: int = 8192

    # --- attention flavour ---
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    qk_norm: bool = False
    sliding_window: int = 0
    global_every: int = 0
    attn_logit_softcap: float = 0.0

    # --- mlp flavour ---
    mlp_act: str = "silu"

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    d_inner: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (zamba2) ---
    attn_every: int = 0

    # --- enc-dec (seamless) ---
    n_encoder_layers: int = 0

    # --- modality frontends ---
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0

    # --- SELL integration (the paper's technique) ---
    sell_kind: str = "dense"
    sell_k: int = 2
    sell_targets: Tuple[str, ...] = ("attn_out", "mlp", "ssm", "shared_in")
    sell_relu: bool = False
    sell_permute: bool = True
    sell_init_std: float = 0.061
    sell_rank: int = 64
    sell_method: str = "auto"
    sell_transform: str = "acdc"
    sell_local_features: bool = True
    sell_batch_axes: Tuple[str, ...] = ()

    # --- performance knobs ---
    attn_impl: str = "chunked"
    attn_chunk: int = 1024
    ce_impl: str = "onehot"
    moe_impl: str = "scatter"

    # --- numerics / misc ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    remat: bool = True
    scan_unroll: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.float32  # master weights; compute casts to self.dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def layer_windows(self) -> np.ndarray:
        """Per-layer attention window (0 = global)."""
        w = np.full((self.n_layers,), self.sliding_window, dtype=np.int32)
        if self.global_every > 0:
            w[self.global_every - 1:: self.global_every] = 0
        return w


def stack_init(n: int, make) -> dict:
    """The ``n`` same-shaped parameter trees ``make(0) .. make(n - 1)``
    stacked leaf by leaf along a new leading axis (layers, experts).  They
    are made one at a time, in order, and copied into place, so the peak
    memory is the result plus one tree (a full-width DeepSeek-67B's 35 GB
    of fp32 layers would otherwise be held twice)."""
    def alloc(tree):
        if isinstance(tree, dict):
            return {k: alloc(v) for k, v in tree.items()}
        return tree.new_empty((n, *tree.shape))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    first = make(0)
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(i), i)
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=DEFAULT_DEVICE) -> dict:
    return {"table": torch.randn((vocab, d), generator=gen, dtype=dtype,
                                 device=device) * (d ** -0.5)}


def embed_lookup(params: dict, tokens: torch.Tensor,
                 dtype: torch.dtype, tp=None) -> torch.Tensor:
    """The tokens' rows of the table, in ``dtype``.  Under ``tp`` (a
    :class:`repro_torch.dist.sharding.TensorSplit`) with the table on its
    "model" block of the vocabulary, each rank looks up the tokens in its
    block, zero for the others, and the blocks' rows are summed over
    "model"."""
    table = params["table"]
    vocab = tp.vocab if tp is not None else table.shape[0]
    if table.shape[0] == vocab:
        # gather then cast == the reference's cast then gather, elementwise
        return table[tokens.long()].to(dtype)
    block = tp.block(vocab, table.shape[0])
    idx = tokens.long() - block.start
    here = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.where(here, idx, torch.zeros_like(idx))].to(dtype)
    return tp.reduce(rows * here[..., None].to(dtype))


def unembed(params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """fp32 logits (..., V); under ``tp`` with the table on its block of
    the vocabulary, this rank's block of them (..., V / model)."""
    x = x.float()
    if tp is not None and params["table"].shape[0] < tp.vocab:
        x = tp.copy(x)
    return torch.matmul(x, params["table"].float().T)


def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    rot_dim = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions broadcastable to (..., S)."""
    dh = x.shape[-1]
    rot_dim = int(dh * fraction) // 2 * 2
    if rot_dim == 0:
        return x
    inv = rope_frequencies(dh, fraction, theta, x.device)
    ang = positions[..., None].float() * inv          # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rotated = torch.stack([out1, out2], dim=-1).reshape(
        *x1.shape[:-1], rot_dim)
    return torch.cat([rotated.to(x.dtype), x[..., rot_dim:]], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  cfg: ModelConfig, rows=None, tp=None) -> torch.Tensor:
    """Masked next-token cross-entropy (positions with label < 0 carry no
    loss), mean over the unmasked positions.  ``cfg.ce_impl``:

    * ``"onehot"`` (the default) — ``lse(logits) - sum(logits * onehot)``
      in fp32 with the max shift held constant, as the reference writes it;
    * ``"gather"`` — ``-log_softmax(logits)`` at the label.

    ``rows`` (a placed train step's
    :class:`repro_torch.dist.sharding.Rows`): ``logits`` are this rank's
    rows, and the loss is the whole batch's masked mean, the numerators
    summed over the rows over ``rows.count``.  ``tp`` (a
    :class:`repro_torch.dist.sharding.TensorSplit`) with ``logits`` this
    rank's block of the vocabulary (``"onehot"`` only): the max is taken
    over "model" and held constant, the sum of exponentials and the true
    logit are summed over "model", the reference's reductions over its
    split vocabulary axis.
    """
    mask = (labels >= 0).float()
    labels = torch.clamp_min(labels.long(), 0)
    if tp is not None and logits.shape[-1] < tp.vocab:
        if cfg.ce_impl != "onehot":
            raise ValueError("ce_impl='gather' needs the whole vocabulary; "
                             "under a vocabulary split over \"model\" use "
                             "'onehot'")
        lf = logits.float()
        block = tp.block(tp.vocab, lf.shape[-1])
        m = tp.max(torch.amax(lf, dim=-1, keepdim=True))
        lse = torch.log(tp.reduce(torch.sum(torch.exp(lf - m), dim=-1))) \
            + m[..., 0]
        idx = labels - block.start
        here = (idx >= 0) & (idx < lf.shape[-1])
        idx = torch.where(here, idx, torch.zeros_like(idx))
        # lf at the label, 0 off this block: sum(lf * onehot) exactly
        true = torch.gather(lf, -1, idx[..., None])[..., 0] * here.float()
        nll = lse - tp.reduce(true)
    elif cfg.ce_impl == "onehot":
        lf = logits.float()
        m = torch.amax(lf, dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
        onehot = torch.zeros_like(lf).scatter_(-1, labels[..., None], 1.0)
        nll = lse - torch.sum(lf * onehot, dim=-1)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    if rows is not None:
        return rows.sum(torch.sum(nll * mask)) / rows.count
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int) -> torch.Tensor:
    """Boolean mask (..., Sq, Sk): causal AND within the sliding window
    (``window`` a host int, 0 = global)."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    mask = dk <= dq
    if window > 0:
        mask = mask & (dq - dk < window)
    return mask


def leaf_split(split, name: str):
    """The block of cache leaf ``name`` that a placed decode reads (a
    :class:`repro_torch.dist.sharding.LeafSplit`), or None for the whole
    leaf: no ``split`` (a ``DecodeSplit``), or a leaf split over its rows
    only."""
    return None if split is None else split.leaf(name)
