"""Weight bridge: a JAX params tree (numpy leaves) -> the port's state dict,
and a JAX optimizer state -> the port's optimizer state.

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

__all__ = ["params_from_jax", "opt_state_from_jax", "vision_params_from_jax"]


def _leaves(tree, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, (*path, key))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, (*path, str(i)))
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


def opt_state_from_jax(
    opt_tree: dict, cfg: ModelConfig, device: str | torch.device | None = None
) -> dict:
    """The JAX package's ``init_opt_state``/``apply_updates`` state (numpy
    leaves) as the port's optimizer state: ``step`` as an int, and ``mu``,
    ``nu`` (and ``ef`` with compressed gradients) as fp32 dicts keyed by
    the port's parameter names, through ``params_from_jax``'s mapping."""
    out = {"step": int(np.asarray(opt_tree["step"]))}
    for key in ("mu", "nu", "ef"):
        if key in opt_tree:
            out[key] = params_from_jax(opt_tree[key], cfg, device)
    return out


def vision_params_from_jax(
    tree: dict, device: str | torch.device | None = None
) -> dict[str, torch.Tensor]:
    """A JAX ViT or Mixer tree (``init_vit``/``init_mixer`` after
    ``jax.tree.map(np.asarray, ...)``) as the state dict of
    ``models.vision``: its ``layers`` is a list of per-layer dicts, so
    ``layers[i]["qkv"]["blocks"]`` becomes ``layers.i.qkv.blocks``; every
    other leaf keeps its dotted path. On ``device`` (default: the card),
    each leaf in its own dtype."""
    dev = resolve_device(device)
    return {".".join(path): _tensor(leaf, dev) for path, leaf in _leaves(tree)}
