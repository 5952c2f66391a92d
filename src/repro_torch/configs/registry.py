"""Architecture registry of the port.

``get(name)`` returns the published config; ``get(name, sparse=True)`` its
pixelfly-sparsified twin (the same overrides as the JAX registry);
``get_smoke(name)`` the reduced same-family config. The four
architectures of the dense decoder family are listed, and the vlm and
audio backbones (``qwen2-vl-7b``, ``musicgen-large``), whose modality
frontends are stubs that feed embeddings; the MoE, SSM and hybrid
families wait for their port (ROADMAP Queue 1). The JAX registry's mesh tables
(``DEFAULT_STRATEGY``, ``LONG_CONTEXT_*``, ``shapes_for``) wait for the
port of distribution (ROADMAP Queue 1 item 9). ``deepseek-67b`` (134 GB of
bf16 weights) does not fit one 80 GB card: the port runs it at smoke
width, and at full width only builds it on the meta device.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}

ARCH_NAMES = list(_MODULES)


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
