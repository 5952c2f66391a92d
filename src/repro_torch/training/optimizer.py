"""Optimizer: AdamW + warmup-cosine schedule + global-norm clipping, with
an optional error-feedback int8 gradient-compression hook.

The port of the JAX package's ``training/optimizer.py``, as plain functions
over dicts keyed by the model's parameter names. A parameter is a list of
its distinct shards (``training.loop.MeshState``; one on one device), and
so are its gradient and moments. The state is ``{"step": int, "mu": {...},
"nu": {...}}`` (+ ``"ef"`` with compressed gradients), the moments in
fp32. Where the JAX package returns new trees, ``apply_updates`` updates
the parameters and the state in place, which saves a copy of every
parameter and moment. The global norm counts each element once (a shard
replicated over a group of positions is one entry), an int8 scale is the
max over every shard of its reference leaf, and AdamW updates each shard
once, elementwise as the whole tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C

__all__ = ["OptConfig", "lr_at", "init_opt_state", "apply_updates", "decays", "reference_leaf"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # error-feedback int8 gradient compression (the numerics of a
    # compressed all-reduce)
    compress_grads: bool = False


def lr_at(cfg: OptConfig, step: int) -> float:
    """The learning rate at ``step``, computed in fp32 as the reference
    computes it: linear warm-up, then cosine down to ``min_lr_frac``."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = cfg.lr * (s + 1.0) / max(1, cfg.warmup_steps)
    t = torch.clamp(
        (s - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return float(warm if step < cfg.warmup_steps else cfg.lr * cos)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(cfg: OptConfig, params: dict[str, list[torch.Tensor]]) -> dict:
    """Zero fp32 moments shaped as ``params`` (a list of shards a name)."""

    def zeros32():
        return {k: [_zeros32(t) for t in p] for k, p in params.items()}

    state = {"step": 0, "mu": zeros32(), "nu": zeros32()}
    if cfg.compress_grads:
        state["ef"] = zeros32()  # error-feedback residual
    return state


@functools.lru_cache(maxsize=32)
def _layer_groups(model_cfg: ModelConfig) -> tuple[str, ...]:
    """The reference's group key of each ``layers.{i}`` of the port (the
    layers of the groups that are not shared, in depth order)."""
    return tuple(
        g.param_key for g in model_cfg.layer_groups() if not g.shared for _ in range(g.count)
    )


def reference_leaf(name: str, model_cfg: ModelConfig) -> str:
    """The reference's tree leaf that holds parameter ``name`` of a model
    of ``model_cfg``. It stacks the leaves of a layer group on a leading
    layer axis, so every layer's ``layers.{i}.<path>`` of one group is one
    leaf ``layers.<group>.<path>`` there. A shared group's block
    (``shared_attn.<path>``) and every parameter outside the layers is a
    leaf of its own, unstacked."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts[1] = _layer_groups(model_cfg)[int(parts[1])]
    return ".".join(parts)


def decays(name: str, p: torch.Tensor, model_cfg: ModelConfig) -> bool:
    """Weight decay where the reference's leaf has ndim >= 2. With the
    stacked layer axis, every ``layers.*`` parameter of ndim >= 1 decays
    there (the norm scales included) and only the scalar γ does not; an
    unstacked leaf (``final_norm.scale``, a shared block's norm scales)
    reads the tensor's own ndim and does not decay at ndim 1."""
    return p.ndim + (reference_leaf(name, model_cfg) != name) >= 2


def _compress_int8(
    grads: dict[str, list[torch.Tensor]],
    residual: dict[str, list[torch.Tensor]],
    model_cfg: ModelConfig,
) -> dict[str, list[torch.Tensor]]:
    """Symmetric int8 quantization with error feedback, one scale per leaf
    of the reference's tree (``reference_leaf``: the same parameter of every
    layer shares one scale, as the reference quantizes its stacked leaf),
    the max over every shard of the leaf. Returns the dequantized fp32
    gradients and updates ``residual`` in place."""
    leaves: dict[str, list[str]] = {}
    for k in grads:
        leaves.setdefault(reference_leaf(k, model_cfg), []).append(k)
    out = {}
    for names in leaves.values():
        gf = {k: [g.float() + r for g, r in zip(grads[k], residual[k])] for k in names}
        maxes = [g.abs().max() for k in names for g in gf[k]]
        scale = C.reduce_scalars(maxes, "max", maxes[0].device) / 127.0
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        for k in names:
            out[k] = []
            for g, r in zip(gf[k], residual[k]):
                s = scale.to(g.device)
                q = torch.clamp(torch.round(g / s), -127, 127) * s
                r.copy_(g - q)
                out[k].append(q)
    return out


@torch.no_grad()
def apply_updates(
    cfg: OptConfig,
    params: dict[str, list[torch.Tensor]],
    grads: dict[str, list[torch.Tensor]],
    state: dict,
    model_cfg: ModelConfig,
) -> dict:
    """One AdamW step, in place on ``params`` and ``state``. The gradient
    is clipped to a global norm, the moments and the update are fp32, and
    each parameter is cast back to its dtype. ``model_cfg`` keys weight
    decay and the int8 scales by the reference's leaves
    (``reference_leaf``). A value of ``params``, ``grads`` and the moments
    is the list of one parameter's distinct shards (module docstring).
    Returns {"grad_norm" (a device scalar), "lr"}."""
    if cfg.compress_grads:
        grads = _compress_int8(grads, state["ef"], model_cfg)
    sq = [g.float().square().sum() for k in params for g in grads[k]]
    gnorm = torch.sqrt(C.reduce_scalars(sq, "sum", sq[0].device))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    s32 = torch.tensor(float(step), dtype=torch.float32)
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** s32)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** s32)
    for k, shards in params.items():
        for p, g, mu, nu in zip(shards, grads[k], state["mu"][k], state["nu"][k]):
            g = g.float() * scale.to(g.device)
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
            p32 = p.float()
            wd = cfg.weight_decay if decays(k, p, model_cfg) else 0.0
            p.copy_(p32 - lr * (delta + wd * p32))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
