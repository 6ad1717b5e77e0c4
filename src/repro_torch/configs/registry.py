"""--arch registry: config lookup + per-(arch x shape) input specs.

Port of ``repro/configs/registry.py``: the same table of arch modules
(copied beside this file as data), and :func:`input_specs` drawing the
reference's numbers from numpy with the reference's seed, as torch
tensors.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

ARCHS = {
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "yi-34b": "repro_torch.configs.yi_34b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}


def list_archs():
    return sorted(ARCHS)


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if (arch x shape) is runnable, else the skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "SKIP(full-attn): long_500k needs sub-quadratic attention"
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig, abstract: bool = True,
                seed: int = 0, device=None) -> Dict[str, object]:
    """Model data inputs for one cell: ``(shape, dtype)`` pairs
    (``abstract``) or concrete deterministic tensors on ``device`` (the
    CPU when None), the reference's numbers.

    train/prefill:  tokens (B, S - P) int32 [+ embeds (B, P, d)]
    decode:         tokens (B, 1) int32
    """
    b = shape.global_batch
    p = cfg.num_prefix_embeds
    dt = getattr(torch, cfg.dtype)
    if shape.kind == "decode":
        specs = {"tokens": ((b, 1), torch.int32)}
    else:
        specs = {"tokens": ((b, shape.seq_len - p), torch.int32)}
        if p:
            specs["embeds"] = ((b, p, cfg.d_model), dt)
    if abstract:
        return specs
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, d) in specs.items():
        if d == torch.int32:
            arr = rng.integers(0, cfg.vocab_size, size=s)
        else:
            arr = rng.standard_normal(s)
        out[k] = torch.from_numpy(arr).to(device=device, dtype=d)
    return out
