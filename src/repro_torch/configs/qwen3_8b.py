"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    mlp_type="swiglu",
    qk_norm=True,
    rope_theta=1e6,
).validate()

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=192, vocab_size=256, dtype="float32",
).validate()
