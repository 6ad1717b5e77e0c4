"""Optimizer-side helpers of the port.

Port of ``repro.optim``, so far :func:`lowrank_truncate` (the one-shot
rank-k truncation through the partial-spectrum planner).  The PowerSGD
helpers, ``compressed_psum`` and ZoloMuon are not yet ported.
"""

from repro_torch.optim.compression import lowrank_truncate

__all__ = ["lowrank_truncate"]
