"""Architecture registry of the port.

``get(name)`` returns the published config; ``get(name, sparse=True)`` its
pixelfly-sparsified twin (the same overrides as the JAX registry);
``get_smoke(name)`` the reduced same-family config. All ten of the JAX
registry's architectures are listed: the four of the dense decoder
family, the vlm and audio backbones (``qwen2-vl-7b``, ``musicgen-large``),
whose modality frontends are stubs that feed embeddings, the MoE family
(``deepseek-moe-16b``, ``kimi-k2-1t-a32b``), the SSM family
(``mamba2-130m``) and the hybrid (``zamba2-2.7b``: Mamba2 layers and one
shared attention block). ``sparse=True`` leaves attention dense for the
SSM family, which has none. The JAX registry's mesh tables
(``DEFAULT_STRATEGY``, ``LONG_CONTEXT_*``, ``shapes_for``) are copied as
they are: the dry-run (``launch.dryrun``) counts every cell over them.
``deepseek-67b`` (134 GB of bf16 weights) and ``kimi-k2-1t-a32b`` (344 GB
even when sparse) do not fit one 80 GB card: the port runs them at smoke
width, and at full width only builds them on the meta device. Tensor
parallelism (``distributed.sharding``) does not change that on one card:
its shards share the card. deepseek-67b would shard in the heads mode on
cards of its own; kimi-k2's experts wait for expert parallelism (ROADMAP
Queue 1 item 17).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

_MODULES = {
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

ARCH_NAMES = list(_MODULES)

# Mesh-usage strategy per arch (``distributed.sharding.Strategy``): tensor
# parallelism with FSDP for the big models, pure FSDP for the small ones,
# where tp 16 would be dominated by each layer's activation collectives.
DEFAULT_STRATEGY = {
    "deepseek-67b": "tp",
    "qwen3-1.7b": "fsdp",
    "qwen2-1.5b": "fsdp",
    "smollm-360m": "fsdp",
    "qwen2-vl-7b": "tp",
    "deepseek-moe-16b": "tp",  # expert parallelism needs the model axis
    "kimi-k2-1t-a32b": "tp",
    "musicgen-large": "tp",
    "zamba2-2.7b": "tp",
    "mamba2-130m": "fsdp",
}

# Archs whose long_500k cell runs (sub-quadratic sequence mixing).
LONG_CONTEXT_ARCHS = {"mamba2-130m", "zamba2-2.7b"}
# pixelfly-sparse attention makes decode sub-quadratic, so this
# full-attention arch also runs long_500k when sparse
LONG_CONTEXT_SPARSE_ARCHS = {"smollm-360m"}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; known: {', '.join(ARCH_NAMES)}"
        )
    return importlib.import_module(_MODULES[name])


def get(
    name: str,
    *,
    sparse: bool = False,
    density: float | None = None,
    **overrides,
) -> ModelConfig:
    cfg: ModelConfig = _module(name).FULL
    if sparse:
        cfg = cfg.replace(
            sparse=True,
            sparse_attention=(cfg.family not in ("ssm",)),
        )
        if density is not None:
            cfg = cfg.replace(sparse_density=density)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def get_smoke(name: str, *, sparse: bool = False, **overrides) -> ModelConfig:
    cfg: ModelConfig = _module(name).smoke()
    if sparse:
        cfg = cfg.replace(
            sparse=True,
            sparse_density=0.5,
            sparse_attention=(cfg.family not in ("ssm",)),
        )
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def shapes_for(name: str, *, sparse: bool = False) -> list[ShapeSpec]:
    """The dry-run's shape cells of an arch: train, prefill and decode, and
    long_500k where its sequence mixing is sub-quadratic."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if name in LONG_CONTEXT_ARCHS or (sparse and name in LONG_CONTEXT_SPARSE_ARCHS):
        out.append(SHAPES["long_500k"])
    return out
