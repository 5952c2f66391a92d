"""Meta-device stand-ins for every input of a dry-run cell, the twin of the
JAX package's ``launch/specs.py``.

The JAX package builds ``ShapeDtypeStruct``s with ``jax.eval_shape`` on its
initializers. The port builds the same shapes and dtypes as tensors on the
meta device, from its own constructors: ``transformer.skeleton`` (the
model built on meta, nothing drawn), ``optimizer.init_opt_state`` and
``transformer.init_cache`` on meta. Nothing is allocated. Tensors are
named as the port's state dict (``bridge.port_names`` maps the JAX tree's
leaves onto those names; a leaf stacked over a layer group is one tensor a
layer here).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import OptConfig, init_opt_state

__all__ = ["input_specs", "params_specs", "state_specs", "decode_cache_specs"]

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The batch inputs of one (arch, shape) cell: tokens, or embeddings
    for a model with a stub frontend, M-RoPE positions where the model has
    them and labels for training (train and prefill); the tokens and the
    shared position of a decode step. int32 as in the JAX specs."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.embed_inputs:
            batch["tokens"] = _sds((b, s), torch.int32)
        else:
            batch["embeds"] = _sds((b, s, cfg.d_model), cfg.torch_dtype)
        if cfg.mrope_sections:
            batch["positions"] = _sds((b, s, len(cfg.mrope_sections)), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _sds((b, s), torch.int32)
        return batch
    if shape.kind == "decode":
        return {"tokens": _sds((b,), torch.int32), "pos": _sds((), torch.int32)}
    raise ValueError(shape.kind)


def params_specs(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The model's state dict on meta (``transformer.skeleton``)."""
    return T.skeleton(cfg).state_dict()


def state_specs(cfg: ModelConfig, opt_cfg: OptConfig) -> dict:
    """{"params", "opt"}: the parameters and the optimizer state of
    ``init_opt_state`` (fp32 moments a parameter, the step an int32
    scalar as the JAX state holds it)."""
    p = params_specs(cfg)
    opt = init_opt_state(opt_cfg, {name: [t] for name, t in p.items()})
    out = {key: {name: v[0] for name, v in val.items()} for key, val in opt.items() if key != "step"}
    return {"params": p, "opt": {"step": _sds((), torch.int32), **out}}


def decode_cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> list:
    """The contiguous decode caches of ``transformer.init_cache`` for the
    cell's batch and length, on meta."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
