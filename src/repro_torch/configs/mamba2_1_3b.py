"""Mamba2-1.3B — attention-free SSD state-space model [arXiv:2405.21060].

48L, d_model 2048, d_inner 4096, ssm_state 128, head_dim 64, vocab 50280.
(Port of :mod:`repro.configs.mamba2_1_3b`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    d_inner=4096,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=128, d_inner=256, ssm_state=16,
    ssm_head_dim=32, ssm_chunk=8, vocab_size=512, dtype="float32",
)
