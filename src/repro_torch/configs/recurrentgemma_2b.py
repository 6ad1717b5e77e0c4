"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (R, R, A)
[arXiv:2402.19427; hf].  26 layers = 8 x (rglru, rglru, attn) + (rglru,
rglru) remainder.  Local attention window 2048 + O(1) RG-LRU state ->
runs the long_500k shape."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_type="swiglu",
    block_pattern=("rglru", "rglru", "attn"),
    rnn_width=2560,
    window=2048,
    rope_theta=1e4,
    logits_softcap=30.0,
).validate()

SMOKE = dataclasses.replace(
    CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=1,
    head_dim=16, d_ff=192, vocab_size=256, rnn_width=64, window=32,
    dtype="float32",
).validate()
