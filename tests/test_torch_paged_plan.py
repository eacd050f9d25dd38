"""The split-KV plan of the paged-attention kernel, on the CPU.

``kernels/paged_attn.plan`` decides everything about a launch of
``csrc/paged_attn.cu`` that is not in the kernel: how many CTAs split each
(slot, KV head)'s keys, the pages each takes, the keys a tile, how the
splits are combined (one split, a thread block cluster, or a workspace
and a second kernel) and the shared memory.  Held here:

* over B, MB, bs and group * T: every page of the table belongs to
  exactly one split and none is empty of pages, the routes and the
  workspace shape follow the split count, the shared memory is what the
  source's layout takes and fits a CTA, and the plan is a function of
  host integers only (no tensor, so no read of ``position``);
* the kernel's dataflow, emulated in PyTorch (each split's key range in
  tiles, the key groups' interleaved keys folded a few at a time with
  masked scores at -1e30, the butterfly over a warp's key groups, the
  warps merged in order, then the splits by their largest max and
  weighted sums in split order, empty ones skipped, the new tokens folded
  last), against the JAX Pallas kernel in interpret mode on
  numpy-seeded inputs, fp32 atol 2e-4, rtol 1e-3: parked rows, unmapped
  tails, window > 0 with wholly skipped splits and splits that saw only
  masked keys, softcap, T = 5, splits with no keys.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attn as jpaged
from repro_torch.kernels import paged_attn as tpaged

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("group,t", [(1, 1), (2, 1), (1, 5), (2, 5),
                                     (16, 1), (8, 1), (8, 5), (8, 8),
                                     (16, 5), (16, 8)])
@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("mb", [1, 6, 65, 257, 1025])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_plans(b, mb, bs, group, t):
    rows = group * t
    # the CTAs of a (slot, head) row block are laid out for rb rows
    rb = tpaged.block_rows(rows)
    assert rb == min(rows, 16)
    assert tpaged.row_blocks(rows) * 16 >= rows > (
        tpaged.row_blocks(rows) - 1) * 16
    for dh, item in ((16, 4), (64, 2), (128, 2), (128, 4)):
        p = tpaged.plan(b, 8, mb, bs, group, t, dh, item)
        # every page in exactly one split, every split holding a page
        owner = np.zeros(mb, np.int64)
        for s in range(p.splits):
            lo = s * p.pages_per_split
            hi = min(mb, lo + p.pages_per_split)
            assert lo < hi
            owner[lo:hi] += 1
        assert (owner == 1).all()
        one_group = rows <= tpaged.rows_max(rb)
        assert p.route == ("single" if p.splits == 1 else "cluster"
                           if p.splits <= tpaged.CLUSTER_MAX and one_group
                           else "two_pass")
        assert p.workspace == ((b, 8, p.splits, rows, dh + 2)
                               if p.route == "two_pass" else None)
        assert p.kt % 16 == 0 and 16 <= p.kt <= 128
        assert p.smem_bytes == tpaged.smem_bytes(rb, t, dh, item, p.kt,
                                                 p.pages_per_split)
        assert p.smem_bytes <= tpaged.SMEM_LIMIT
        assert p.threads == 128 * -(-rb // tpaged.rows_max(rb))
        # no split of fewer than MIN_SPLIT_KEYS keys unless it is the only
        if p.splits > 1:
            assert p.pages_per_split * bs >= tpaged.MIN_SPLIT_KEYS
        # the row blocks count towards the CTAs the splits aim at
        ctas = b * 8 * tpaged.row_blocks(rows)
        assert p.splits == 1 or ctas * (p.splits - 1) < tpaged.TARGET_CTAS


def test_plan_takes_host_integers_only():
    # nothing the plan reads can be a device tensor: no sync a tick
    params = inspect.signature(tpaged.plan.__wrapped__).parameters
    assert all(p.annotation in (int, "int") for p in params.values())


def test_plans_of_the_timed_rows():
    # the main path's decode and verify rows (6-page tables) take one
    # split; the long rows spread over the card
    assert tpaged.plan(4, 8, 6, 16, 2, 1, 128, 2).route == "single"
    assert tpaged.plan(4, 8, 6, 16, 2, 5, 128, 2).route == "single"
    for b, length in ((4, 4096), (16, 1024), (1, 16384)):
        mb = -(-(length + 1) // 16)
        p = tpaged.plan(b, 8, mb, 16, 2, 1, 128, 2)
        assert b * 8 * p.splits >= tpaged.TARGET_CTAS, p


def test_plans_refuse_what_the_kernel_does_not_take():
    # T past 32, Dh outside 16 - 128 or not a multiple of 16, empty shapes
    # (any group * T is taken: its rows are cut into row blocks)
    for bad in ((0, 8, 6, 16, 2, 1, 128, 2), (4, 8, 0, 16, 2, 1, 128, 2),
                (4, 8, 6, 16, 17, 33, 128, 2), (4, 8, 6, 16, 2, 33, 128, 2),
                (4, 8, 6, 16, 2, 1, 136, 2), (4, 8, 6, 16, 2, 1, 8, 2),
                (4, 8, 6, 16, 2, 1, 100, 2), (4, 8, 6, 16, 2, 0, 128, 2)):
        with pytest.raises(ValueError):
            tpaged.plan(*bad)
    for group, t in ((17, 1), (2, 9), (16, 32)):
        assert tpaged.plan(4, 8, 6, 16, group, t, 128, 2).splits >= 1


def test_forced_plans_cover_the_table():
    for splits in (1, 2, 3, 5, 8, 9, 64):
        p = tpaged.make_plan(2, 4, 10, 4, 2, 1, 16, 4, splits, 16)
        assert (p.splits - 1) * p.pages_per_split < 10
        assert p.splits * p.pages_per_split >= 10
        assert p.splits <= min(splits, 10)
    assert tpaged.make_plan(2, 4, 10, 4, 2, 1, 16, 4, 5, 16,
                            cluster=False).route == "two_pass"


# ---------------------------------------------------------------------------
# the kernel's dataflow against the JAX kernel
# ---------------------------------------------------------------------------

NEG = -1e30


def _merge(a, b):
    """The source's merge1/merge8 over rows: (m, l, acc) of two sides;
    a side with m = -inf changes nothing."""
    ma, la, aa = a
    mb, lb, ab = b
    mx = torch.maximum(ma, mb)
    ea, eb = ma == -math.inf, mb == -math.inf
    safe = torch.where(ea & eb, torch.zeros_like(mx), mx)
    ca = torch.where(ea, torch.zeros_like(ma), torch.exp(ma - safe))
    cb = torch.where(eb, torch.zeros_like(mb), torch.exp(mb - safe))
    m = torch.where(ea, mb, torch.where(eb, ma, mx))
    lm = torch.where(ea, lb, torch.where(eb, la, la * ca + lb * cb))
    am = torch.where(ea[:, None], ab, torch.where(
        eb[:, None], aa, aa * ca[:, None] + ab * cb[:, None]))
    return m, lm, am


def _merge_splits(states, rows, dh):
    """The source's merge_splits: the largest m of the splits that
    streamed keys, then their l and acc weighted by exp(m_s - M), summed
    in split order."""
    if not states:
        return _empty(rows, dh)
    m = torch.stack([st[0] for st in states]).max(0).values
    live = m > -math.inf
    safe = torch.where(live, m, torch.zeros_like(m))
    l, acc = torch.zeros(rows), torch.zeros(rows, dh)
    for sm, sl, sa in states:
        w = torch.where(live, torch.exp(sm - safe), torch.zeros_like(sm))
        l = l + w * sl
        acc = acc + w[:, None] * sa
    return m, l, acc


def _empty(rows, dh):
    return (torch.full((rows,), -math.inf), torch.zeros(rows),
            torch.zeros(rows, dh))


def _emulate(q, kn, vn, kp, vp, tables, pos, window, softcap, p):
    """The kernel's arithmetic for plan ``p`` in fp32 (pools updated in
    place as the combining CTA writes them)."""
    b, t, hq, dh = q.shape
    hkv = kn.shape[2]
    group = hq // hkv
    rows = group * t
    n_pages, bs = kp.shape[0], kp.shape[1]
    mb = tables.shape[1]
    virt = mb * bs
    scale = dh ** -0.5
    # every row block's CTAs are laid out for block_rows(rows) rows; a
    # row's arithmetic does not depend on the block it falls in
    lpk = tpaged.lanes_per_key(
        dh, tpaged.dims_per_lane(tpaged.block_rows(rows)))
    nkg = 4 * (32 // lpk)
    ksub = 2
    out = torch.empty_like(q)

    def score(dot, qpos, kpos):
        s = dot * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        if window > 0:
            s = torch.where(qpos - kpos < window, s, torch.full_like(s, NEG))
        return s

    for i in range(b):
        pi = int(pos[i])
        frontier = pi if pi < virt else 0
        kstart = max(pi - window + 1, 0) if window > 0 else 0
        qpos = pi + torch.arange(rows) % t
        for h in range(hkv):
            qr = torch.stack([q[i, r % t, h * group + r // t].float()
                              for r in range(rows)])            # (R, Dh)
            states = []
            for s in range(p.splits):
                k0 = max(s * p.pages_per_split * bs, kstart)
                k1 = min((s + 1) * p.pages_per_split * bs, frontier)
                if k0 >= k1:
                    states.append(None)
                    continue
                groups = [_empty(rows, dh) for _ in range(nkg)]
                for t0 in range(k0, k1, p.kt):
                    nk = min(p.kt, k1 - t0)
                    for kg in range(nkg):
                        idx = list(range(kg, nk, nkg))
                        for c in range(0, len(idx), ksub):
                            chunk = idx[c:c + ksub]
                            kpos = torch.tensor([t0 + j for j in chunk])
                            pages = tables[i, kpos // bs].clamp(min=0)
                            keys = kp[pages, kpos % bs, h].float()
                            vals = vp[pages, kpos % bs, h].float()
                            sc = score(qr @ keys.T, qpos[:, None],
                                       kpos[None, :])           # (R, n)
                            m, l, acc = groups[kg]
                            mx = torch.maximum(m, sc.max(1).values)
                            corr = torch.exp(m - mx)
                            pr = torch.exp(sc - mx[:, None])
                            groups[kg] = (mx, l * corr + pr.sum(1),
                                          acc * corr[:, None] + pr @ vals)
                # the butterfly over a warp's key groups, then the warps
                kpw = 32 // lpk
                warps = []
                for w in range(4):
                    lanes = groups[w * kpw:(w + 1) * kpw]
                    step = 1
                    while step < kpw:        # xor offsets, low bit first
                        lanes = [_merge(lanes[j], lanes[j ^ step])
                                 for j in range(kpw)]
                        step *= 2
                    warps.append(lanes[0])
                st = _empty(rows, dh)
                for w in warps:
                    st = _merge(st, w)
                states.append(st)
            fin = _merge_splits([st for st in states if st is not None],
                                rows, dh)
            # the new tokens, folded last
            knp = pi + torch.arange(t)
            sc = score(qr @ kn[i, :, h].float().T, qpos[:, None],
                       knp[None, :])
            ok = (knp[None, :] <= qpos[:, None]) & (knp[None, :] < virt)
            sc = torch.where(ok, sc, torch.full_like(sc, NEG))
            m, l, acc = fin
            mx = torch.maximum(m, sc.max(1).values)
            corr = torch.exp(m - mx)
            pr = torch.exp(sc - mx[:, None])
            l = l * corr + pr.sum(1)
            acc = acc * corr[:, None] + pr @ vn[i, :, h].float()
            o = acc / l.clamp(min=1e-30)[:, None]
            for r in range(rows):
                out[i, r % t, h * group + r // t] = o[r].to(q.dtype)
    phys, off = _write_targets(tables, pos, t, bs, n_pages)
    kp[phys, off] = kn.to(kp.dtype)
    vp[phys, off] = vn.to(vp.dtype)
    return out


def _write_targets(tables, pos, t, bs, n_pages):
    from repro_torch.kernels import ref
    return ref.paged_write_targets(tables, pos, t, bs, n_pages)


def _tables(b, mb, unmapped_from=None):
    t = np.arange(b * mb, dtype=np.int32).reshape(b, mb)
    t = t[:, ::-1].copy()                  # pages not in position order
    if unmapped_from is not None:
        t[0, unmapped_from:] = -1
    return t


# name: (b, t, hkv, group, dh, bs, mb, window, softcap, positions, splits,
#        unmapped tail of slot 0 from this page)
CASES = {
    # 4 splits in a cluster: a short slot leaves splits with no keys, a
    # parked slot streams nothing
    "decode-split-empty-parked": (3, 1, 2, 2, 16, 4, 8, 0, 0.0,
                                  [3, 29, 32], 4, None),
    # more splits than a cluster: the workspace route; unmapped tail
    "decode-two-pass-unmapped": (2, 1, 2, 2, 16, 4, 10, 0, 0.0,
                                 [9, 37], 10, 3),
    # window: the splits before its start are skipped whole; T = 3 rows
    # past the window see only masked keys in the split holding its start
    "verify-window-masked-splits": (2, 3, 2, 2, 16, 4, 8, 2, 0.0,
                                    [13, 26], 8, None),
    # softcap, T = 5 (10 rows: two row groups), one split
    "verify-softcap-t5": (2, 5, 2, 2, 32, 4, 8, 0, 30.0, [6, 21], 1, None),
    # T = 5 across splits with a window, Dh 64
    "verify-t5-window-split": (2, 5, 1, 2, 64, 4, 8, 7, 0.0,
                               [17, 30], 3, None),
    # row blocks (16 query rows each): group 8 and 16 at T = 1, 5, 8, in
    # one split, in a cluster and through the workspace, window and
    # softcap on some
    "rows-g8-t1-cluster": (2, 1, 1, 8, 16, 4, 8, 0, 0.0, [13, 30], 4,
                           None),
    "rows-g8-t5-two-pass": (2, 5, 1, 8, 16, 4, 8, 0, 0.0, [17, 26], 3,
                            None),
    "rows-g8-t8-window": (1, 8, 1, 8, 32, 4, 8, 6, 0.0, [19], 2, None),
    "rows-g16-t1-single": (2, 1, 1, 16, 16, 4, 6, 0, 30.0, [9, 24], 1,
                           3),
    "rows-g16-t5-two-pass-parked": (2, 5, 1, 16, 16, 4, 6, 0, 0.0,
                                    [11, 24], 3, None),
    "rows-g16-t8-window-softcap": (1, 8, 2, 16, 16, 4, 8, 5, 20.0, [21],
                                   2, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataflow_matches_pallas(case):
    (b, t, hkv, group, dh, bs, mb, window, softcap, positions, splits,
     unmapped) = CASES[case]
    rs = np.random.RandomState(len(case) + b * t)
    nb = b * mb

    def arr(*shape):
        return rs.randn(*shape).astype(np.float32)

    q, kn, vn = arr(b, t, hkv * group, dh), arr(b, t, hkv, dh), \
        arr(b, t, hkv, dh)
    kp, vp = arr(nb + 1, bs, hkv, dh), arr(nb + 1, bs, hkv, dh)
    tbl = _tables(b, mb, unmapped)
    pos = np.asarray(positions, np.int32)
    jo, jk, jv = jpaged.paged_attention(
        *(jnp.asarray(v) for v in (q, kn, vn, kp, vp)), jnp.asarray(tbl),
        jnp.asarray(pos), jnp.int32(window), softcap=softcap, page_chunk=2,
        head_block=1, interpret=True)
    p = tpaged.make_plan(b, hkv, mb, bs, group, t, dh, 4, splits, 16)
    assert p.splits == splits
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to = _emulate(torch.from_numpy(q), torch.from_numpy(kn),
                  torch.from_numpy(vn), tk, tv, torch.from_numpy(tbl),
                  torch.from_numpy(pos), window, softcap, p)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    assert np.array_equal(tk.numpy()[:-1], np.asarray(jk)[:-1])
    assert np.array_equal(tv.numpy()[:-1], np.asarray(jv)[:-1])


def test_merge_handles_empty_and_masked_sides():
    # an empty side (m = -inf, l = 0) never gives NaN; a side that saw
    # only masked keys (m = -1e30) is wiped by one that saw a real key and
    # kept as the single pass keeps it where none did
    empty = _empty(1, 2)
    masked = (torch.tensor([NEG]), torch.tensor([3.0]),
              torch.tensor([[3.0, 6.0]]))
    real = (torch.tensor([0.5]), torch.tensor([1.0]),
            torch.tensor([[1.0, 2.0]]))
    for x in (_merge(empty, empty), _merge(empty, masked),
              _merge(masked, real), _merge(real, masked)):
        assert not any(torch.isnan(v).any() for v in x)
    assert torch.equal(_merge(masked, real)[2], real[2])
    assert torch.equal(_merge(empty, masked)[1], masked[1])
    m, l, acc = _merge(masked, masked)
    assert float(m) == float(torch.tensor(NEG)) and float(l) == 6.0
