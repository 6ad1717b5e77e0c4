"""LM model stack of the port: every registered architecture.

Port of ``repro.models``: configs, layers, blocked attention with its
ring-buffer decode, the MoE, SSD and RG-LRU blocks, stacked stages, the
full forward, and the serving half (caches, prefill, decode).
"""

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.model import (
    caches_axes,
    decode_step,
    forward,
    hidden_states,
    init_caches,
    init_params,
    param_count,
    params_axes,
    prefill,
)
