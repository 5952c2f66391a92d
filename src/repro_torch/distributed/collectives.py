"""Collectives of the one-controller tensor-parallel engine: each takes one
tensor a shard (a list in rank order) and gives each shard its result on
that shard's device.

A collective here is a device-to-device copy (peer to peer between two
cards; nothing on one card) followed by a concatenation or a sum, taken in
rank order, so a result does not depend on which device computed it. A
result is computed once for each distinct device and shared by the shards
on that device: on one card, ``tp`` shards share one tensor. There are no
process groups: the engine's one Python process drives every shard, as
the JAX package's engine drives one GSPMD program over its mesh.
"""

from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import torch

__all__ = ["per_device", "broadcast", "gather", "all_gather", "all_reduce"]

T = TypeVar("T")


def per_device(fn: Callable[[torch.device], T], devices: Sequence[torch.device]) -> list[T]:
    """``fn(device)`` for each entry of ``devices``, called once for each
    distinct device."""
    done: dict[str, T] = {}
    out = []
    for d in devices:
        key = str(d)
        if key not in done:
            done[key] = fn(torch.device(d))
        out.append(done[key])
    return out


def broadcast(t: torch.Tensor | None, devices: Sequence[torch.device]) -> list:
    """``t`` on every shard's device (None stays None)."""
    if t is None:
        return [None] * len(devices)
    return per_device(lambda d: t.to(d, non_blocking=True), devices)


def gather(shards: Sequence[torch.Tensor], dim: int, device: torch.device) -> torch.Tensor:
    """The shards concatenated along ``dim`` in rank order, on ``device``."""
    return torch.cat([s.to(device, non_blocking=True) for s in shards], dim=dim)


def all_gather(shards: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """``gather`` onto every shard's device."""
    return per_device(lambda d: gather(shards, dim, d), [s.device for s in shards])


def all_reduce(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the shards on every shard's device: accumulated in fp32
    in rank order and cast back to the shards' dtype."""

    def total(d: torch.device) -> torch.Tensor:
        acc = shards[0].to(d, torch.float32)
        for s in shards[1:]:
            acc = acc + s.to(d, torch.float32)
        return acc.to(shards[0].dtype)

    return per_device(total, [s.device for s in shards])
