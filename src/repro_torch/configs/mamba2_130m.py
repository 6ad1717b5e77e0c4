"""mamba2-130m [ssm]: 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060].

vocab 50280 is padded to 50432 (multiple of 256) for the 16-wide model
axis; tied embeddings as in the released checkpoints.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    vocab_size=50280,
    d_ff=0,
    mlp_type="none",
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
).validate()

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=32, vocab_size=256, dtype="float32",
).validate()
