"""Distribution layer of the port.

Port of ``repro.dist``: the paper's r process groups of grouped
(Algorithm 3) Zolo-PD on a grid of ``torch.distributed`` ranks
(:mod:`repro_torch.dist.grouped`), the collective ops bundles the engine
runs on there (:mod:`repro_torch.dist.grouped_ops`), and the LM stack's
logical-axis sharding on ``DeviceMesh`` / DTensor placements
(:mod:`repro_torch.dist.sharding`).
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
from repro_torch.dist.sharding import (
    REPLICATED,
    LogicalRules,
    MeshSharding,
    activation_hints,
    arch_rules,
    current_rules,
    distribute_tree,
    hint,
    hint_tree,
    logical_sharding,
    tree_shardings,
)

__all__ = [
    "DEFAULT_COMM_FLOPS_PER_WORD",
    "REPLICATED",
    "LogicalRules",
    "MeshSharding",
    "ZoloGroupMesh",
    "activation_hints",
    "arch_rules",
    "current_rules",
    "distribute_tree",
    "hint",
    "hint_tree",
    "logical_sharding",
    "tree_shardings",
    "grouped_iteration_flops",
    "grouped_zolo_pd_dynamic",
    "grouped_zolo_pd_static",
    "sep_reduce_ops",
    "zolo_group_mesh",
    "zolo_term_group_ops",
]
