"""The FLOP and byte counts against hand counts at two sizes."""

import math

import pytest

from bench.count import flops, kernels, peaks

TINY = {"family": "decoder", "n_layers": 2, "d_model": 256, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 64, "d_ff": 512, "vocab_size": 1000,
        "n_experts": 0, "n_shared_experts": 0, "top_k": 0,
        "capacity_factor": 1.25, "n_encoder_layers": 0, "sell_kind": "acdc",
        "sell_k": 2, "sell_targets": ["attn_out", "mlp"],
        "sell_permute": True, "sell_method": "pallas", "dtype": "bfloat16",
        "remat": True}


def test_acdc_row_is_two_fast_transforms_and_two_diagonals():
    # N = 1024: 2 x 2.5 x 1024 x 10 + 2 x 1024 a layer, 2 layers
    assert flops.acdc_row(TINY, 1024) == 2 * (51200 + 2048)
    assert flops.n_op(1024, 8192) == 8192 and flops.n_op(2048, 1408) == 2048
    assert flops.n_op(2816, 2048) == 2816 and flops.n_op(100, 3) == 128


@pytest.mark.parametrize("rows,seq", [(1, 4), (2, 8)])
def test_decoder_forward_by_hand(rows, seq):
    d, nq, nkv, v = 256, 256, 128, 1000
    t = rows * seq
    ctx = rows * seq * (seq + 1) / 2       # causal keys, every position
    acdc256 = 2 * (2 * 2.5 * 256 * 8 + 2 * 256)
    acdc512 = 2 * (2 * 2.5 * 512 * 9 + 2 * 512)
    layer = t * (2 * d * (nq + 2 * nkv) + acdc256 + 3 * acdc512) \
        + 4 * nq * ctx
    want = 2 * layer + t * 2 * d * v
    assert flops.decoder_forward(TINY, rows, seq) == pytest.approx(want)
    assert flops.train_step(TINY, rows, seq) == pytest.approx(3 * want)


def test_moe_token_counts_top_k_experts_and_the_shared_one():
    moe = dict(TINY, n_experts=8, top_k=2, n_shared_experts=1,
               sell_kind="dense")
    d, ff = 256, 512
    want = 2 * d * 8 + 2 * (3 * 2 * d * ff) + 3 * 2 * d * ff
    assert flops.ffn_row(moe) == want


@pytest.mark.parametrize("m", [16, 512])
def test_scaled_matmul_bound_by_hand(m):
    n = 8192
    one = kernels._smm(m, n, 2, 1, False, 1)
    assert one.bytes == 2 * m * n * 2 + 4 * n * n + 4 * n
    assert one.ops == 2 * m * n * n
    assert one.bound_s() == max(one.bytes / 3.35e12, one.ops / 495e12)


def test_seamless_train_inventory_matches_the_program_routing():
    from bench.harness import ROOT, load_json
    import os

    cfg = load_json(os.path.join(ROOT, "bench/configs/"
                                 "seamless_m4t_large_v2.json"))["model"]
    tot = kernels.totals(kernels.train_step(cfg, 4, 128, 128))
    # 48 MLPs x 3 projections x (8 forward with remat + 6 backward)
    assert tot["scaled_matmul"]["launches"] == 2016
    # 72 attn_out cascades, forward twice (remat), one reverse sweep
    assert tot["acdc_cascade"]["launches"] == 144
    assert tot["acdc_cascade_bwd"]["launches"] == 72
    m, n = 512, 1024
    casc = [x for x in kernels.train_step(cfg, 4, 128, 128)
            if x.kernel == "acdc_cascade"][0]
    assert casc.bytes == 2 * m * n * 2 + 2 * 4 * 2 * n + 3 * 4 * n * n
    assert casc.ops == m * 2 * (2 * 2.5 * n * math.log2(n) + 2 * n)


def test_dsmoe_train_inventory():
    from bench.harness import ROOT, load_json
    import os

    cfg = load_json(os.path.join(ROOT, "bench/configs/"
                                 "deepseek_moe_16b-stage7.json"))["model"]
    assert kernels.capacity(cfg, 2048) == 240
    tot = kernels.totals(kernels.train_step(cfg, 2, 1024))
    # 7 layers x 7 SELL projections x 14 launches
    assert tot["scaled_matmul"]["launches"] == 686
    assert set(tot) == {"scaled_matmul"}


def test_peaks_are_the_data_sheet():
    assert (peaks.BF16_FLOPS, peaks.TF32_FLOPS, peaks.HBM_BYTES_S) == (
        989e12, 495e12, 3.35e12)
