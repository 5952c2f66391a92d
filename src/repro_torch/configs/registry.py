"""Architecture registry of the port.

``get(name)`` returns the published config; ``get(name, sparse=True)`` its
pixelfly-sparsified twin (the same overrides as the JAX registry);
``get_smoke(name)`` the reduced same-family config. Only the architectures
the port serves so far are listed.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
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
