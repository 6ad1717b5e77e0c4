"""LM model stack of the port: attention-only dense architectures.

Port of ``repro.models`` (the training half): configs, layers, blocked
attention, stacked stages and the full forward.  Decode and the MoE, SSD
and RG-LRU families are not ported yet.
"""

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.model import (
    forward,
    hidden_states,
    init_params,
    param_count,
)
