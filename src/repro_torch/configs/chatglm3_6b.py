"""ChatGLM3-6B — dense decoder with 2d (half-dim) RoPE, GQA kv=2
[arXiv:2406.12793; hf].

28L, d_model 4096, 32 heads (GQA kv=2), d_ff 13696, vocab 65024.
(Port of :mod:`repro.configs.chatglm3_6b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="decoder",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_theta=10000.0,
    rope_fraction=0.5,     # "RoPE 2d": rotary applied to half the head dims
    mlp_act="silu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=224, vocab_size=512, dtype="float32",
)
