"""LLaVA-NeXT-34B — VLM; transformer BACKBONE only (anyres vision tower is
a STUB providing patch embeddings) [hf:llava-hf/*; unverified tier].

60L, d_model 7168, 56 heads (GQA kv=8), d_ff 20480, vocab 64000;
576 patch-embedding prefix tokens from the stub frontend.
(Port of :mod:`repro.configs.llava_next_34b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="decoder",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    frontend="vision",
    n_frontend_tokens=576,
    mlp_act="silu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, n_frontend_tokens=8, dtype="float32",
)
