"""Optimizers of the port: ZoloMuon (the paper's PD inside the train
step) + AdamW, the LR schedule, and the gradient-compression helpers.

Port of ``repro.optim``: :func:`lowrank_truncate` (the one-shot rank-k
truncation through the partial-spectrum planner), the PowerSGD helpers
and :func:`compressed_psum` (the all-reduce of rank-k gradient factors),
:class:`ZoloMuon` and :func:`warmup_cosine`.
"""

from repro_torch.optim.compression import (
    compress_decompress,
    compressed_psum,
    init_compression_state,
    lowrank_factor,
    lowrank_truncate,
)
from repro_torch.optim.muon import (
    MuonConfig,
    ZoloMuon,
    muon_labels,
    orthogonalize,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["MuonConfig", "ZoloMuon", "compress_decompress",
           "compressed_psum", "init_compression_state", "lowrank_factor",
           "lowrank_truncate", "muon_labels", "orthogonalize",
           "warmup_cosine"]
