"""Model configuration: the port's own copy of the reference ``ModelConfig``.

The fields and their defaults are those of ``repro/models/config.py``, so a
configuration file reads the same in both packages and tests can compare
them field by field.  The port runs every configuration the reference
does: every block kind, MoE, encoder-decoder and the vision prefix.
``ShapeConfig`` and ``SHAPES`` are the reference's four assigned input
shapes, which the dry-run (``launch/dryrun.py``) counts every
architecture at.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

BLOCK_KINDS = ("attn", "local_attn", "ffn", "rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity -----------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm | audio
    source: str = ""

    # -- trunk dimensions ---------------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 512

    # -- layer stack --------------------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)

    # -- attention ----------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0
    logit_softcap: float = 0.0

    # -- MLP / MoE ----------------------------------------------------------
    mlp_act: str = "silu"        # silu (SwiGLU) | gelu (GeGLU) | relu2 (Nemotron)
    mlp_gated: bool = True
    parallel_block: bool = False  # Cohere/GPT-J style: x + attn(h) + mlp(h)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    num_shared_experts: int = 0

    # -- recurrent (rglru / xlstm) -----------------------------------------
    rec_heads: int = 0
    rglru_conv_width: int = 4
    lru_width: int = 0
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    recurrent_chunk: int = 256

    # -- encoder-decoder ----------------------------------------------------
    num_encoder_layers: int = 0
    encoder_d_ff: int = 0

    # -- multimodal stubs ---------------------------------------------------
    num_vision_tokens: int = 0
    audio_frontend: bool = False

    # -- embedding / misc ---------------------------------------------------
    tie_embeddings: bool = True
    emb_scale: bool = False      # multiply embeddings by sqrt(d_model)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def resolved_rec_heads(self) -> int:
        return self.rec_heads or self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def blocks(self) -> Tuple[str, ...]:
        """The concrete per-layer block kinds, pattern tiled to num_layers."""
        pat = self.block_pattern
        reps = math.ceil(self.num_layers / len(pat))
        return tuple((pat * reps)[: self.num_layers])

    def layer_groups(self) -> Tuple[int, int]:
        """(n_full_groups, n_remainder_layers): the reference stacks the
        parameters of each full pattern repetition on a leading axis."""
        plen = len(self.block_pattern)
        return self.num_layers // plen, self.num_layers % plen

    def validate(self) -> "ModelConfig":
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: num_heads={self.num_heads} not "
                             f"divisible by num_kv_heads={self.num_kv_heads}")
        for kind in self.block_pattern:
            if kind not in BLOCK_KINDS:
                raise ValueError(f"{self.name}: unknown block {kind!r}")
        if self.is_moe and self.num_experts_per_tok <= 0:
            raise ValueError(f"{self.name}: MoE needs num_experts_per_tok > 0")
        if "local_attn" in self.block_pattern and self.sliding_window <= 0:
            raise ValueError(f"{self.name}: local_attn needs a window")
        return self

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw).validate()

    @property
    def subquadratic(self) -> bool:
        """Does every attention block have a bounded context?"""
        blocks = set(self.blocks()) - {"ffn"}
        if "attn" in blocks:
            return False
        if "local_attn" in blocks:
            return self.sliding_window > 0
        return True  # pure recurrent


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (workload) input-shape cell, as the reference's."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    microbatches: int = 1  # gradient-accumulation splits for train


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
