"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].  Window 4096 (mistral-style SWA) -> sub-quadratic
serving, so this arch runs the long_500k shape."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    mlp_type="swiglu",
    window=4096,
    rope_theta=1e4,
).validate()

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=192, vocab_size=256, window=32, dtype="float32",
).validate()
