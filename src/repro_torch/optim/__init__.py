"""Optimizer-side helpers of the port.

Port of ``repro.optim``, so far :func:`lowrank_truncate` (the one-shot
rank-k truncation through the partial-spectrum planner) and
:func:`compressed_psum` (the all-reduce of rank-k gradient factors).  The
PowerSGD helpers and ZoloMuon are not yet ported.
"""

from repro_torch.optim.compression import compressed_psum, lowrank_truncate

__all__ = ["compressed_psum", "lowrank_truncate"]
