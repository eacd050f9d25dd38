"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its CUDA kernel computes, in the
same precision (every operand upcast to fp32, fp32 accumulation, one
rounding to the output dtype at the end), so that:

* the kernel wrappers take them for CPU tensors (the CPU tests run them
  against the JAX Pallas kernels in interpret mode);
* ``chip_smoke.py`` holds each kernel against them on the card.

They are not a yardstick of speed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def scaled_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      pre: Optional[torch.Tensor] = None,
                      post: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``((x * pre) @ w) * post + bias`` for 2-D x (M, K), w (K, N);
    output in x's dtype."""
    h = x.float()
    if pre is not None:
        h = h * pre.float()
    y = h @ w.float()
    if post is not None:
        y = y * post.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def acdc_cascade_ref(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                     bias: Optional[torch.Tensor], c: torch.Tensor,
                     ct: torch.Tensor, ct_mid: Optional[torch.Tensor],
                     relu: bool = False) -> torch.Tensor:
    """Order-K cascade over 2-D x (M, N), activation fp32 throughout::

        h <- ((h * a_i) @ C * d_i + bias_i) @ (ct_mid or ct for the last)

    with ReLU between layers (not after the last).  ``ct_mid`` is the
    column-permuted inverse transform (the riffle folded in); ``None``
    means no permutation.  ``acdc_fused`` is the K=1 case.
    """
    k = a.shape[0]
    h = x.float()
    c = c.float()
    ct_last = ct.float()
    mid = ct_mid.float() if ct_mid is not None else ct_last
    for i in range(k):
        h2 = (h * a[i].float()) @ c
        h3 = h2 * d[i].float()
        if bias is not None:
            h3 = h3 + bias[i].float()
        last = i == k - 1
        h = h3 @ (ct_last if last else mid)
        if relu and not last:
            h = torch.clamp_min(h, 0.0)
    return h.to(x.dtype)


def paged_write_targets(tables: torch.Tensor, position: torch.Tensor,
                        t: int, bs: int, n_pages: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(phys, off)`` (B, T) for the T new tokens of each row: the page
    holding ``position + i`` and the offset in it, with unmapped pages and
    positions at/beyond the virtual row routed to the trash page
    ``n_pages - 1``."""
    mb = tables.shape[1]
    virtual = mb * bs
    qpos = position.long()[:, None] + torch.arange(
        t, device=position.device)[None, :]
    blk = torch.clamp(qpos // bs, max=mb - 1)
    phys = torch.gather(tables.long(), 1, blk)
    writable = (phys >= 0) & (qpos < virtual)
    phys = torch.where(writable, phys, torch.full_like(phys, n_pages - 1))
    return phys, qpos % bs


def paged_attention_ref(q: torch.Tensor, knew: torch.Tensor,
                        vnew: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, tables: torch.Tensor,
                        position: torch.Tensor, window: int,
                        softcap: float) -> torch.Tensor:
    """Paged decode/verify attention; updates the pools IN PLACE.

    q (B, T, Hq, Dh); knew/vnew (B, T, Hkv, Dh) in the pool dtype; pools
    (NB+1, bs, Hkv, Dh) with page NB the trash page; tables (B, MB)
    int32 with -1 = unmapped; position (B,) the first write index.

    1. The T new tokens' K/V are written to their tail pages (trash when
       unmapped or at/beyond the virtual row ``MB * bs``).
    2. Each row attends to the streamed prefix ``kpos < pos`` (nothing
       when ``pos >= virtual``; read through the table, unmapped entries
       read page 0)
       plus the new tokens themselves (``kpos <= qpos``, ``kpos <
       virtual``), causal and within ``window`` (0 = global), with logit
       soft-capping.  Masked scores are -1e30, as in the reference: a row
       whose every key is masked (a parked row, ``pos >= virtual``)
       averages the new tokens' values uniformly.

    Returns out (B, T, Hq, Dh) in q's dtype.
    """
    b, t, hq, dh = q.shape
    hkv = knew.shape[2]
    group = hq // hkv
    n_pages, bs = k_pages.shape[0], k_pages.shape[1]
    mb = tables.shape[1]
    virtual = mb * bs
    scale = dh ** -0.5
    phys, off = paged_write_targets(tables, position, t, bs, n_pages)
    k_pages[phys, off] = knew.to(k_pages.dtype)
    v_pages[phys, off] = vnew.to(v_pages.dtype)
    routed = torch.clamp_min(tables.long(), 0)
    out = torch.empty_like(q)
    for i in range(b):
        pos = int(position[i])
        # parked rows (pos >= virtual) stream nothing
        frontier = pos if pos < virtual else 0
        kpos_s = torch.arange(frontier, device=q.device)
        ks = k_pages[routed[i, kpos_s // bs], kpos_s % bs]   # (S, Hkv, Dh)
        vs = v_pages[routed[i, kpos_s // bs], kpos_s % bs]
        keys = torch.cat([ks, knew[i].to(k_pages.dtype)]).float()
        vals = torch.cat([vs, vnew[i].to(v_pages.dtype)]).float()
        qpos = pos + torch.arange(t, device=q.device)[:, None]    # (T, 1)
        kp_new = pos + torch.arange(t, device=q.device)[None, :]  # (1, T)
        m_stream = torch.ones((t, frontier), dtype=torch.bool,
                              device=q.device)   # kpos < pos <= qpos
        m_new = (kp_new <= qpos) & (kp_new < virtual)
        kpos = torch.cat([kpos_s[None, :].expand(t, -1),
                          kp_new.expand(t, -1)], dim=1)
        msk = torch.cat([m_stream, m_new], dim=1)
        if window > 0:
            msk = msk & (qpos - kpos < window)
        qg = q[i].float().reshape(t, hkv, group, dh)
        s = torch.einsum("thgd,khd->hgtk", qg, keys) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(msk[None, None], s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("hgtk,khd->thgd", p, vals)
        out[i] = o.reshape(t, hq, dh).to(q.dtype)
    return out
