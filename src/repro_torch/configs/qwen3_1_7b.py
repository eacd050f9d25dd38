"""Qwen3-1.7B — dense decoder with qk-norm, GQA [hf:Qwen/Qwen3-*; hf].

28L, d_model 2048, 16 heads (GQA kv=8), d_ff 6144, vocab 151936.
(Port of :mod:`repro.configs.qwen3_1_7b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="decoder",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_act="silu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=512, dtype="float32",
)
