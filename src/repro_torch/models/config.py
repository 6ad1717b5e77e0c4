"""Model configuration shared by all assigned architectures.

A copy of ``repro/models/config.py`` (pure data, no JAX): the port keeps
its own so that it imports nothing of the reference package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_vocab(v: int, mult: int = 256) -> int:
    return v + ((-v) % mult)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int

    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None  # sliding-window size; None = full attn

    # mlp
    d_ff: int = 0
    mlp_type: str = "swiglu"  # swiglu | gelu | none
    norm_type: str = "rmsnorm"  # rmsnorm | nonparam_ln

    # layer schedule: one entry per layer within a repeating stage,
    # e.g. ("attn",) for pure transformers, ("rglru", "rglru", "attn")
    # for recurrentgemma, ("ssd",) for mamba2.
    block_pattern: Tuple[str, ...] = ("attn",)

    # MoE
    num_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (griffin)
    rnn_width: int = 0

    # modality stubs ([vlm]: precomputed patch embeds prepended)
    num_prefix_embeds: int = 0

    # numerics / compilation
    dtype: str = "bfloat16"
    remat: bool = True
    scan_stages: bool = True
    logits_softcap: float = 0.0
    tie_embeddings: bool = False

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # ssd
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def stage_pattern(self) -> Tuple[str, ...]:
        return self.block_pattern

    @property
    def num_stages(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def remainder_blocks(self) -> Tuple[str, ...]:
        rem = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    @property
    def sub_quadratic(self) -> bool:
        """True if serving memory/compute does not grow with context
        (SSM / RG-LRU state or bounded attention window)."""
        return all(b != "attn" for b in self.block_pattern) or \
            (self.window is not None)

    def validate(self) -> "ModelConfig":
        def need(ok: bool, what: str):
            if not ok:
                raise ValueError(f"ModelConfig {self.name!r}: {what}")

        if "attn" in self.block_pattern:
            need(self.num_heads * self.head_dim > 0,
                 f"attn blocks need num_heads ({self.num_heads}) and "
                 f"head_dim ({self.head_dim}) > 0")
            need(self.num_heads % max(self.num_kv_heads, 1) == 0,
                 f"num_heads ({self.num_heads}) must divide evenly by "
                 f"num_kv_heads ({self.num_kv_heads})")
        if "ssd" in self.block_pattern:
            need(self.d_inner % self.ssm_head_dim == 0,
                 f"d_inner ({self.d_inner}) must be a multiple of "
                 f"ssm_head_dim ({self.ssm_head_dim})")
        if "rglru" in self.block_pattern:
            need(self.rnn_width > 0,
                 f"rglru blocks need rnn_width > 0 (got {self.rnn_width})")
        if self.num_experts:
            need(self.moe_top_k > 0,
                 f"MoE needs moe_top_k > 0 (got {self.moe_top_k})")
        need(self.num_layers >= len(self.block_pattern),
             f"num_layers ({self.num_layers}) shorter than the block "
             f"pattern ({len(self.block_pattern)})")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (arch x shape) cell: what to lower and at what size."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
