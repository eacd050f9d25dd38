"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

38 mamba layers, d_model 2048, ssm_state 64; shared attention block
(32 heads, d_ff 8192) applied every 6 layers; vocab 32000.
(Port of :mod:`repro.configs.zamba2_1_2b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    d_inner=4096,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    attn_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=8, n_kv_heads=8, head_dim=16,
    d_ff=256, d_inner=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
    attn_every=2, vocab_size=512, dtype="float32",
)
