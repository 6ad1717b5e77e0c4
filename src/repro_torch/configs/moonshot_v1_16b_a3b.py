"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (MHA kv=16) expert
d_ff=1408 vocab=163840, MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].  Moonlight's shared expert is folded
into the 64-expert pool (noted in DESIGN.md §5)."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    mlp_type="swiglu",
    num_experts=64,
    moe_top_k=6,
    capacity_factor=1.25,
    rope_theta=5e4,
).validate()

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=64, vocab_size=256, num_experts=8, moe_top_k=2,
    dtype="float32",
).validate()
