"""Collectives of the one-controller tensor-parallel engine and mesh
trainer: each takes one tensor a shard (a list in rank order) and gives
each shard its result on that shard's device.

A collective here is a device-to-device copy (peer to peer between two
cards; nothing on one card) followed by a concatenation or a sum, taken in
rank order, so a result does not depend on which device computed it. A
result is computed once for each distinct device and shared by the shards
on that device: on one card, ``tp`` shards share one tensor. There are no
process groups: the engine's one Python process drives every shard, as
the JAX package's engine drives one GSPMD program over its mesh. Every
join is differentiable (one process holds the whole autograd graph):
``all_gather``'s backward sums each shard's slice of the gradient, and
``reduce_scatter`` is what the mesh trainer's gradients go through.

While a step is counted (``analysis.roofline``), each join is one
collective of the JAX walker's class: ``all_gather`` and ``gather`` add
their result's bytes for each position that receives it, ``all_reduce``
each position's operand bytes, and the ops inside are not counted (a
collective's bytes are not HBM bytes to the walker). The caller of
``reduce_scatter`` reports it (``training.loop.MeshState.accumulate``:
only it knows how many positions add into a slice). ``broadcast`` stands
for an input every device holds under JAX's input sharding and
``reduce_scalars`` for a psum of a few scalars: neither adds bytes. The
backward of a join is a collective too (JAX's transpose of an all-gather
is a reduce-scatter, of an all-reduce an all-reduce): a hook on each
result adds its gradient's bytes when the gradient arrives. While
counting, every position gets a result of its own, as on a mesh of
distinct devices, so the counted memory does not depend on how many
devices the positions stand on.
"""

from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import torch

from repro_torch.analysis import roofline as R

__all__ = ["per_device", "broadcast", "gather", "all_gather", "all_reduce", "reduce_scatter", "reduce_scalars"]

T = TypeVar("T")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def per_device(fn: Callable[[torch.device], T], devices: Sequence[torch.device]) -> list[T]:
    """``fn(device)`` for each entry of ``devices``, called once for each
    distinct device (for each entry while a step is counted)."""
    done: dict = {}
    each = R.tally() is not None
    out = []
    for i, d in enumerate(devices):
        key = i if each else str(d)
        if key not in done:
            done[key] = fn(torch.device(d))
        out.append(done[key])
    return out


def _backward(kind: str, outs: list) -> list:
    """While counting, report ``kind`` with each result's gradient bytes as
    the gradient arrives (the backward's collective)."""
    t = R.tally()
    if t is not None and not t.quiet:  # not a join inside another
        for o in {id(o): o for o in outs}.values():
            if o.requires_grad:
                o.register_hook(lambda g: R.collective(kind, _nbytes(g), lambda: None))
    return outs


def broadcast(t: torch.Tensor | None, devices: Sequence[torch.device]) -> list:
    """``t`` on every shard's device (None stays None)."""
    if t is None:
        return [None] * len(devices)
    if R.tally() is None:
        return per_device(lambda d: t.to(d, non_blocking=True), devices)
    return R.collective(None, 0, lambda: [t.to(d, non_blocking=True, copy=i > 0) for i, d in enumerate(devices)])


def gather(shards: Sequence[torch.Tensor], dim: int, device: torch.device) -> torch.Tensor:
    """The shards concatenated along ``dim`` in rank order, on ``device``."""
    nbytes = sum(map(_nbytes, shards))
    out = R.collective("all-gather", nbytes, lambda: torch.cat([s.to(device, non_blocking=True) for s in shards],
                                                                dim=dim))
    return _backward("reduce-scatter", [out])[0]


def all_gather(shards: Sequence[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """``gather`` onto every shard's device."""
    nbytes = len(shards) * sum(map(_nbytes, shards))
    out = R.collective("all-gather", nbytes, per_device, lambda d: gather(shards, dim, d),
                       [s.device for s in shards])
    return _backward("reduce-scatter", out)


def all_reduce(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the shards on every shard's device: accumulated in fp32
    in rank order and cast back to the shards' dtype."""

    def total(d: torch.device) -> torch.Tensor:
        acc = shards[0].to(d, torch.float32)
        for s in shards[1:]:
            acc = acc + s.to(d, torch.float32)
        return acc.to(shards[0].dtype)

    nbytes = sum(map(_nbytes, shards))
    out = R.collective("all-reduce", nbytes, per_device, total, [s.device for s in shards])
    return _backward("all-reduce", out)


def reduce_scatter(
    fulls: Sequence[torch.Tensor],
    dim: int | None,
    shard_sizes: Sequence[int],
    devices: Sequence[torch.device] | None = None,
    *,
    out: list[torch.Tensor] | None = None,
) -> list[torch.Tensor]:
    """The sum of ``fulls`` (one tensor a position, in rank order), cut
    along ``dim`` into ``shard_sizes``: shard i gets slice i of the sum,
    on ``devices[i]`` (default: ``fulls[i]``'s device, one shard a
    position). ``dim=None`` is one whole shard (an all-reduce to one
    owner; ``shard_sizes`` then has one entry, unread). With ``out`` (the
    shards of an earlier call, None where there are none yet) the slices
    are added to it, so a caller that computes the positions' tensors in
    turn holds one at a time; the sum is the same, term by term in rank
    order. A sum of two or more terms is fp32; a slice with one term is
    that term, in its own dtype (exact, and no copy). The caller reports
    it as a collective (module docstring)."""
    if devices is None:
        devices = [f.device for f in fulls]
    if out is None:
        out = [None] * len(shard_sizes)
    for full in fulls:
        a = 0
        for i, n in enumerate(shard_sizes):
            part = full if dim is None else full.narrow(dim, a, n)
            a += 0 if dim is None else n
            part = part.to(out[i].device if out[i] is not None else devices[i])
            out[i] = part if out[i] is None else out[i].float() + part.float()
    return out


def reduce_scalars(values: Sequence[torch.Tensor], op: str, device: torch.device | str) -> torch.Tensor:
    """The sum or max (``op``) of 0-d tensors, in the order given, on
    ``device``: one stack and one reduction, so the same values in the
    same order give the same bits on one device."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown op {op!r}")

    def run():
        stacked = torch.stack([v.to(device) for v in values])
        return stacked.sum() if op == "sum" else stacked.max()

    return R.collective(None, 0, run)
