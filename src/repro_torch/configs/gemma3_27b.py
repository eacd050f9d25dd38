"""Gemma3-27B — dense decoder, 5:1 local:global attention, 128k context
[hf:google/gemma-3-*; unverified tier].

62L, d_model 5376, 32 heads (GQA kv=16), d_ff 21504, vocab 262144.
Sliding window 1024 on local layers; every 6th layer global; qk-norm.
(Port of :mod:`repro.configs.gemma3_27b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="decoder",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    global_every=6,        # 5 local : 1 global
    qk_norm=True,
    mlp_act="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
    d_ff=384, vocab_size=512, sliding_window=8, dtype="float32",
)
