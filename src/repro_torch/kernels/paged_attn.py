"""Paged-attention decode/verify — wrapper of ``csrc/paged_attn.cu``.

Port of :mod:`repro.kernels.paged_attn` (``paged_attention``).  One call
writes the T new tokens' K/V into their tail pages (the trash page when
unmapped or at/beyond the virtual row) and attends over each slot's
mapped prefix plus the new tokens, following the reference's mask
contract (see ``ref.paged_attention_ref``).

The pools are updated IN PLACE (the reference aliases them through
``input_output_aliases``); only the attention output is returned.

For CUDA tensors :func:`paged_attention` launches the kernel (or raises);
for CPU tensors it takes :func:`repro_torch.kernels.ref.paged_attention_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: the kernel's per-block limits (see the source)
MAX_HEAD_DIM = 128
MAX_ROWS = 16          # (n_heads / n_kv_heads) * T
MAX_T = 32

#: kernel launches since the last reset (plain int; chip_smoke resets it)
launches = 0

_ARGS = ([build.VP] * 8 + [build.I32] * 9 + [build.F32, build.F32,
                                             build.I32, build.VP])
_DTYPES = (torch.float32, torch.bfloat16)


def fits(hkv: int, dh: int, group: int, t: int) -> bool:
    """Whether the kernel takes this head layout and query count."""
    return dh <= MAX_HEAD_DIM and t <= MAX_T and group * t <= MAX_ROWS


def paged_attention(q: torch.Tensor, knew: torch.Tensor, vnew: torch.Tensor,
                    k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, position: torch.Tensor,
                    window: int, *, softcap: float) -> torch.Tensor:
    """q (B, T, Hq, Dh), knew/vnew (B, T, Hkv, Dh), pools (NB+1, bs, Hkv,
    Dh), block_tables (B, MB) int32 (-1 unmapped), position (B,) int32,
    window a host int (0 = global).  Returns out (B, T, Hq, Dh)."""
    global launches
    b, t, hq, dh = q.shape
    hkv = knew.shape[2]
    if hq % hkv or knew.shape != (b, t, hkv, dh) or vnew.shape != knew.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"knew={tuple(knew.shape)} vnew={tuple(vnew.shape)}")
    knew = knew.to(k_pages.dtype)
    vnew = vnew.to(v_pages.dtype)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, knew, vnew, k_pages, v_pages,
                                       block_tables, position, int(window),
                                       float(softcap))
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    for name, tns in (("knew", knew), ("vnew", vnew), ("k_pages", k_pages),
                      ("v_pages", v_pages), ("block_tables", block_tables),
                      ("position", position)):
        if tns.device != q.device:
            raise ValueError(f"paged_attention: {name} on {tns.device}, "
                             f"q on {q.device}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: q {q.dtype} and pools "
                        f"{k_pages.dtype}/{v_pages.dtype} must share one "
                        f"dtype of {_DTYPES}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention: pools must be contiguous (they "
                         "are written in place)")
    if not fits(hkv, dh, hq // hkv, t):
        raise ValueError(
            f"paged_attention kernel needs Dh <= {MAX_HEAD_DIM}, T <= "
            f"{MAX_T} and group*T <= {MAX_ROWS}; got Dh={dh} T={t} "
            f"group={hq // hkv}")
    n_pages, bs = k_pages.shape[0], k_pages.shape[1]
    mb = block_tables.shape[1]
    q = q.contiguous()
    knew, vnew = knew.contiguous(), vnew.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    pos = position.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = build.bind("paged_attn", "paged_attn_launch", _ARGS)
    err = fn(q.data_ptr(), knew.data_ptr(), vnew.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
             pos.data_ptr(), out.data_ptr(), b, t, hq, hkv, dh, n_pages, bs,
             mb, int(window), float(softcap), float(dh ** -0.5),
             int(q.dtype == torch.bfloat16), build.stream_of(q.device))
    build.check(err, "paged_attn")
    launches += 1
    return out
