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


def per_row(v: torch.Tensor, rows: int) -> torch.Tensor:
    """A scaled_matmul vector as it scales ``rows`` rows: ``(N,)`` as it
    is; grouped ``(G, N)`` repeated over each group's ``rows / G``
    consecutive rows, ``(rows, N)``."""
    if v.dim() == 1:
        return v
    g, n = v.shape
    return v[:, None, :].expand(g, rows // g, n).reshape(rows, n)


def scaled_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      pre: Optional[torch.Tensor] = None,
                      post: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``((x * pre) @ w) * post + bias`` for 2-D x (M, K), w (K, N);
    output in x's dtype.  Grouped vectors (pre (G, K), post and bias
    (G, N)) scale each of the G groups of M / G consecutive rows by its
    own row."""
    m = x.shape[0]
    h = x.float()
    if pre is not None:
        h = h * per_row(pre.float(), m)
    y = h @ w.float()
    if post is not None:
        y = y * per_row(post.float(), m)
    if bias is not None:
        y = y + per_row(bias.float(), m)
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


def acdc_bwd_ref(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                 d: torch.Tensor, c: torch.Tensor, ct: torch.Tensor,
                 with_bias: bool = True):
    """One layer's backward (the paper's eqs. 10-14) over 2-D x, g (M, N)
    in fp32: returns ``(dx, da, dd, db)`` with dx in x's dtype, the
    diagonal grads (N,) fp32 and ``db`` None without bias::

        gc = g C,  h2 = (x a) C,  dd = sum h2 gc,  db = sum gc,
        dh1 = (gc d) C^T,  da = sum x dh1,  dx = a dh1
    """
    xf, gf = x.float(), g.float()
    a, d = a.float(), d.float()
    gc = gf @ c.float()
    h2 = (xf * a) @ c.float()
    dd = torch.sum(h2 * gc, dim=0)
    db = torch.sum(gc, dim=0) if with_bias else None
    dh1 = (gc * d) @ ct.float()
    da = torch.sum(xf * dh1, dim=0)
    return (a * dh1).to(x.dtype), da, dd, db


def acdc_cascade_bwd_ref(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                         d: torch.Tensor, bias: Optional[torch.Tensor],
                         c: torch.Tensor, ct: torch.Tensor,
                         ct_mid: Optional[torch.Tensor], relu: bool = False):
    """Reverse-sweep backward of an order-K cascade (K >= 2) over 2-D x, g
    (M, N), all in fp32, as the kernel computes it:

    1. re-walk layers 0 .. K-2 and stash their outputs h_1 .. h_{K-1} (the
       next layers' inputs, ReLU applied, riffle folded into ``ct_mid``);
    2. sweep layers K-1 .. 0 with eqs. 10-14; between layers the ReLU mask
       is taken in h-space against the stashed next input and the
       un-permute is a contraction against ``ct_mid``'s second axis
       (``w @ ct_mid^T == w[:, p^-1] @ C``).

    Returns ``(dx, da, dd, db)``: dx in x's dtype, (K, N) fp32 grads,
    ``db`` None without bias.
    """
    k, n = a.shape
    c, ct = c.float(), ct.float()
    mid = ct_mid.float() if ct_mid is not None else ct
    a, d = a.float(), d.float()
    xf = x.float()
    stash = []
    h = xf
    for i in range(k - 1):
        h3 = ((h * a[i]) @ c) * d[i]
        if bias is not None:
            h3 = h3 + bias[i].float()
        h = h3 @ mid
        if relu:
            h = torch.clamp_min(h, 0.0)
        stash.append(h)
    da = torch.zeros((k, n), dtype=torch.float32, device=x.device)
    dd = torch.zeros_like(da)
    db = torch.zeros_like(da) if bias is not None else None
    gcur = g.float()
    for i in range(k - 1, -1, -1):
        h_i = stash[i - 1] if i > 0 else xf
        if i == k - 1:
            gc = gcur @ c
        else:
            if relu:
                gcur = torch.where(stash[i] > 0, gcur,
                                   torch.zeros_like(gcur))
            gc = gcur @ mid.T if ct_mid is not None else gcur @ c
        if db is not None:
            db[i] = torch.sum(gc, dim=0)
        h2 = (h_i * a[i]) @ c
        dd[i] = torch.sum(h2 * gc, dim=0)
        dh1 = (gc * d[i]) @ ct
        da[i] = torch.sum(h_i * dh1, dim=0)
        gcur = a[i] * dh1
    return gcur.to(x.dtype), da, dd, db


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
