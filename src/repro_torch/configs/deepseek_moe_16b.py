"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

28L, d_model 2048, 16 heads (GQA kv=16), expert d_ff 1408, vocab 102400.
(Port of :mod:`repro.configs.deepseek_moe_16b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="decoder",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    mlp_act="silu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=8, head_dim=16,
    d_ff=64, vocab_size=512, n_experts=8, n_shared_experts=1, top_k=2,
    dtype="float32",
)
