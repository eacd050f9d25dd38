"""DeepSeek-67B — dense llama-arch decoder [arXiv:2401.02954; hf].

95L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 102400.
(Port of :mod:`repro.configs.deepseek_67b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="decoder",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
    mlp_act="silu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=128, n_heads=8, n_kv_heads=1, head_dim=16,
    d_ff=352, vocab_size=512, dtype="float32",
)
