"""SeamlessM4T-large-v2 — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf].  Audio frontend is a STUB: precomputed frame
embeddings feed the encoder.

24L encoder + 24L decoder, d_model 1024, 16 heads, d_ff 8192, vocab 256206.
(Port of :mod:`repro.configs.seamless_m4t_large_v2`: the same values.)
"""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
    mlp_act="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_encoder_layers=2, d_model=128, n_heads=8,
    n_kv_heads=8, head_dim=16, d_ff=256, vocab_size=512,
    n_frontend_tokens=16, dtype="float32",
)
