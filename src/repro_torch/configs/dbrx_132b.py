"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) expert d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    mlp_type="swiglu",
    num_experts=16,
    moe_top_k=4,
    capacity_factor=1.25,
    rope_theta=5e5,
).validate()

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=96, vocab_size=256, num_experts=4, moe_top_k=2,
    dtype="float32",
).validate()
