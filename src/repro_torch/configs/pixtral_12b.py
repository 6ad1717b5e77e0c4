"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo [hf:mistralai/Pixtral-12B-2409].

Backbone only per the assignment: the Pixtral ViT frontend is a stub —
``input_specs()`` supplies 256 precomputed patch embeddings per sample,
prepended to the text tokens (total sequence = shape.seq_len)."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    mlp_type="swiglu",
    num_prefix_embeds=256,
    rope_theta=1e9,
).validate()

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=192, vocab_size=256, num_prefix_embeds=8,
    dtype="float32",
).validate()
