"""Weight bridge: a JAX params tree (numpy leaves) -> the port's state dict.

The tree is what the JAX package's ``transformer.init_model`` returns after
``jax.tree.map(np.asarray, ...)``. Leaves stacked over a layer group keep
their leading ``count`` axis there; the bridge splits them into the port's
per-layer modules. It takes numpy only, so it needs neither JAX nor the
JAX package.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import resolve_device

__all__ = ["params_from_jax"]


def _leaves(tree, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, (*path, key))
    else:
        yield path, np.asarray(tree)


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: go through float32, which
        # holds every bfloat16 exactly
        t = torch.from_numpy(a.astype(np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(
    tree: dict, cfg: ModelConfig, device: str | torch.device | None = None
) -> dict[str, torch.Tensor]:
    """Map every leaf of ``tree`` onto the port's parameter name, on
    ``device`` (default: the card), keeping each leaf's dtype. Load the
    result with ``LM.load_state_dict`` or pass it as ``Engine(params=)``."""
    dev = resolve_device(device)
    groups = {}
    offset = 0
    for g in cfg.layer_groups():
        if g.shared:
            raise NotImplementedError("shared layer groups are not ported yet")
        groups[g.param_key] = (offset, g.count)
        offset += g.count
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        if path[0] == "groups":
            first, count = groups[path[1]]
            if leaf.shape[:1] != (count,):
                raise ValueError(f"{'/'.join(path)}: leading axis is not the group's {count} layers")
            rest = ".".join(path[2:])
            for i in range(count):
                out[f"layers.{first + i}.{rest}"] = _tensor(leaf[i], dev)
        else:
            out[".".join(path)] = _tensor(leaf, dev)
    return out
