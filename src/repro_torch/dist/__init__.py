"""Distribution layer of the port: grouped (Algorithm 3) Zolo-PD.

Port of the grouped half of ``repro.dist``: the paper's r process groups
on a grid of ``torch.distributed`` ranks (:mod:`repro_torch.dist.grouped`)
and the collective ops bundles the engine runs on there
(:mod:`repro_torch.dist.grouped_ops`).  The logical-axis sharding layer
(``repro.dist.sharding``) belongs to the LM stack and is not ported.
"""

from repro_torch.dist.grouped import (
    DEFAULT_COMM_FLOPS_PER_WORD,
    ZoloGroupMesh,
    grouped_iteration_flops,
    grouped_zolo_pd_dynamic,
    grouped_zolo_pd_static,
    zolo_group_mesh,
)
from repro_torch.dist.grouped_ops import sep_reduce_ops, zolo_term_group_ops

__all__ = [
    "DEFAULT_COMM_FLOPS_PER_WORD",
    "ZoloGroupMesh",
    "grouped_iteration_flops",
    "grouped_zolo_pd_dynamic",
    "grouped_zolo_pd_static",
    "sep_reduce_ops",
    "zolo_group_mesh",
    "zolo_term_group_ops",
]
