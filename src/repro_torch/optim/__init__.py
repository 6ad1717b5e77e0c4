"""Optimizers of the port: ZoloMuon (the paper's PD inside the train
step) + AdamW, the LR schedule, and the gradient-compression helpers.

Port of ``repro.optim``: :func:`lowrank_truncate` (the one-shot rank-k
truncation through the partial-spectrum planner),
:func:`compressed_psum` (the all-reduce of rank-k gradient factors),
:class:`ZoloMuon` and :func:`warmup_cosine`.  The PowerSGD helpers are
not yet ported.
"""

from repro_torch.optim.compression import compressed_psum, lowrank_truncate
from repro_torch.optim.muon import (
    MuonConfig,
    ZoloMuon,
    muon_labels,
    orthogonalize,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["MuonConfig", "ZoloMuon", "compressed_psum", "lowrank_truncate",
           "muon_labels", "orthogonalize", "warmup_cosine"]
