"""Configurations of the port: the paper's matrices (``svd_paper``) and
the LM architectures (one module per arch, copied from the reference as
data) with their registry."""

from repro_torch.configs.registry import (
    ARCHS,
    cell_supported,
    get_config,
    get_smoke_config,
    input_specs,
    list_archs,
)
