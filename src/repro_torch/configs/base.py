"""Model configuration: the architecture's published numbers plus the
pixelfly knobs, as frozen dataclasses.

A copy of ``ModelConfig``/``GroupSpec`` from the JAX package with a
``torch_dtype`` property in place of ``jdtype``; field names and defaults
are unchanged, so a config built here describes exactly the model the
JAX package builds from the same fields.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ModelConfig", "GroupSpec"]


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """A run of structurally identical layers.

    ``param_key`` names the parameter subtree in the JAX package's params
    tree (the bridge maps it onto the port's per-layer modules); shared
    groups reuse the same key at several positions.
    """

    kind: str  # "dense" | "moe" | "ssm" | "shared_attn"
    count: int
    param_key: str
    shared: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention variants
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (half-dim splits)
    # io
    embed_inputs: bool = True
    tie_embeddings: bool = False
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0
    moe_first_dense: int = 0
    moe_dense_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_routing_groups: int = 1
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # hybrid (zamba2): one shared attention block after every N ssm layers
    attn_every: int = 0
    # pixelfly
    sparse: bool = False
    sparse_density: float = 0.2
    sparse_block: int = 128
    lowrank_frac: float = 0.25
    sparse_attention: bool = False
    attn_local_blocks: int = 2
    attn_global_blocks: int = 1
    attn_max_stride: int = 0  # 0 -> full butterfly on the block grid
    attn_block: int = 128
    # numerics / runtime
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024
    tp_size: int = 0
    batch_axes: tuple[str, ...] = ()

    # ------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype
        ]

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the JAX package's TP rule)."""
        return int(math.ceil(self.vocab_size / 256) * 256)

    def layer_groups(self) -> list[GroupSpec]:
        if self.family in ("dense", "vlm", "audio"):
            return [GroupSpec("dense", self.num_layers, "dense_0")]
        if self.family == "moe":
            groups = []
            if self.moe_first_dense:
                groups.append(GroupSpec("dense", self.moe_first_dense, "dense_0"))
            groups.append(
                GroupSpec("moe", self.num_layers - self.moe_first_dense, "moe_0")
            )
            return groups
        if self.family == "ssm":
            return [GroupSpec("ssm", self.num_layers, "ssm_0")]
        if self.family == "hybrid":
            if not self.attn_every:
                raise ValueError("hybrid family needs attn_every")
            groups: list[GroupSpec] = []
            n_cycles = self.num_layers // self.attn_every
            per = self.attn_every - 1
            for c in range(n_cycles):
                groups.append(GroupSpec("ssm", per, f"ssm_{c}"))
                groups.append(
                    GroupSpec("shared_attn", 1, "shared_attn", shared=True)
                )
            rem = self.num_layers - n_cycles * self.attn_every
            if rem:
                groups.append(GroupSpec("ssm", rem, f"ssm_{n_cycles}"))
            return groups
        raise ValueError(f"unknown family {self.family}")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
