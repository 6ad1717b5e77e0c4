"""Deterministic synthetic LM data pipeline.

Port of ``repro/data/pipeline.py``: ``batch_at(step)`` is a pure function
of (seed, step), drawn with numpy from ``SeedSequence([seed, step])``
exactly as the reference draws it, so the tokens are bit-identical; the
batch is placed on ``device``.  The mesh placement of the reference waits
for the port's sharding module.

The token stream is a Zipf-ish categorical (a squared uniform), so
losses behave qualitatively like text.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_prefix_embeds: int = 0
    d_model: int = 0
    dtype: str = "bfloat16"
    device: str = "cuda"

    def _tokens_np(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # Zipf-ish: square a uniform to skew mass toward small ids
        u = rng.random((self.global_batch, self.seq_len))
        return (u * u * (self.vocab_size - 1)).astype(np.int32)

    def batch_at(self, step: int):
        toks = self._tokens_np(step)
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.num_prefix_embeds:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed + 1, step]))
            emb = rng.standard_normal(
                (self.global_batch, self.num_prefix_embeds, self.d_model))
            batch["embeds"] = torch.from_numpy(emb).to(
                device=self.device, dtype=getattr(torch, self.dtype))
        return batch
