"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only per the assignment: the EnCodec frontend is a stub — the
token stream *is* the EnCodec codebook stream (single-stream
simplification of the 4-codebook interleave; DESIGN.md §5).  MusicGen's
original sinusoidal positions are replaced by the framework-standard RoPE
(positional-encoding swap noted in DESIGN.md; no effect on shapes/flops).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    rope_theta=1e4,
).validate()

SMOKE = dataclasses.replace(
    CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
).validate()
