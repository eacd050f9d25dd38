"""Moonshot-v1-16B-A3B (Moonlight) — fine-grained MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L, d_model 2048, 16 heads (GQA kv=16), expert d_ff 1408, vocab 163840,
64 routed experts top-6 + 2 shared experts.
(Port of :mod:`repro.configs.moonshot_v1_16b_a3b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="decoder",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
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
