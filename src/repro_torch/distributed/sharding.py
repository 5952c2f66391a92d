"""Sharding rules: parameter, batch and cache partition specs for a mesh, the
twin of the JAX package's ``distributed/sharding.py``.

Two layouts, chosen per architecture by the launcher:

- ``Strategy("tp")``: tensor parallel over ``model`` on the natural tensor
  axis (heads, ffn, experts, vocab, butterfly block rows), FSDP (ZeRO-3)
  over ``data`` (and ``pod``) on a second axis, batch over (pod, data).
- ``Strategy("fsdp")``: no tensor parallelism; every axis is a data axis.

Every rule is guarded by divisibility, as the JAX rules are: a dimension
the axis does not divide stays replicated. The specs are the port's own
``PartitionSpec`` tuples (the port imports no JAX), equal entry for entry
to the JAX package's (a one-axis tuple reads as the axis name, an empty
one as None, as ``jax.sharding.PartitionSpec`` normalises them).

The JAX package gives a spec to GSPMD, which lays the array out across the
mesh (``named``) and keeps it there inside a jitted step
(``constrain_pools``). Those two have no counterpart here: in the port a
layout *is* its shards. ``position_slices`` gives each position of a mesh
its slice of a tensor, as ``NamedSharding(mesh, spec).devices_indices_map``
places it (a dimension whose entry is a tuple of axes is cut into the
product of their sizes, position ``(i_a, i_b)`` taking block ``i_a * size_b
+ i_b``); ``shard_state_dict`` cuts a state dict into one dict a position,
``unshard_state_dict`` puts it back. A tensor-parallel engine holds the
shards of a ``(1, tp)`` mesh, one on each device, and joins their results
with ``distributed.collectives``; the mesh ``Trainer`` holds the shards of
any mesh and gathers and reduce-scatters them (``training.loop``). The
state dict is the port's (one module a layer), so a spec has no leading
layer entry: the JAX spec of a leaf stacked over a layer group, without its
first entry, is the spec of each layer's tensor (``bridge.port_names``).

``check_tp`` refuses what the port's shard-local forms do not cover, in
serving and in training alike, each refusal naming the ROADMAP item that
would shard it (``REFUSED``).
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import MODEL_AXIS, Mesh

__all__ = [
    "PartitionSpec",
    "Strategy",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "model_dim",
    "positions",
    "position_slices",
    "take",
    "shard_state_dict",
    "unshard_state_dict",
    "check_tp",
    "axes_size",
    "REFUSED",
]

# what the port's tensor parallelism leaves to later work, by ROADMAP item
REFUSED = {
    "attention": "ROADMAP Queue 1 item 16 (decode attention over a cache cut along the sequence)",
    "ssm_heads": "ROADMAP Queue 1 item 24 (an SSM mixer whose heads tp does not divide, or with more than one "
                 "group of B and C)",
    "engine_fsdp": "ROADMAP Queue 1 item 20 (an Engine holding FSDP-sharded weights on a (data, model) mesh, "
                   "the JAX Engine's strategy=\"fsdp\" on such a mesh)",
}


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), an axis name, or a tuple
    of axis names, normalised as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Strategy:
    """How the mesh axes are used ("tp" or "fsdp"; see the module
    docstring)."""

    def __init__(self, mesh: Mesh, kind: str = "tp"):
        if kind not in ("tp", "fsdp"):
            raise ValueError(kind)
        self.kind = kind
        self.mesh = mesh
        names = mesh.axis_names
        if kind == "tp":
            self.model_axis: str | None = MODEL_AXIS if MODEL_AXIS in names else None
            self.fsdp: tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
        else:
            self.model_axis = None
            self.fsdp = tuple(a for a in ("pod", "data", "model") if a in names)
        self.batch: tuple[str, ...] = self.fsdp

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.model_axis] if self.model_axis else 1


def axes_size(mesh: Mesh, axes) -> int:
    """How many slices a spec entry cuts a dimension into (1 for None)."""
    if not axes:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _fits(mesh: Mesh, dim: int, axes) -> bool:
    return axes is not None and dim % axes_size(mesh, axes) == 0


def _maybe(st: Strategy, dim: int, axes):
    if not axes:
        return None
    return axes if _fits(st.mesh, dim, axes) else None


def _batch_axes_for(st: Strategy, dim: int):
    """Largest suffix of the batch axes that divides ``dim`` (None if only
    a trivial size-1 sharding remains)."""
    axes = st.batch
    while axes and dim % axes_size(st.mesh, axes) != 0:
        axes = axes[1:]
    if not axes or axes_size(st.mesh, axes) == 1:
        return None
    return axes


def _greedy(st: Strategy, dims: tuple[int, ...]) -> list:
    """Put model then fsdp on the largest divisible dims."""
    entries: list[Any] = [None] * len(dims)
    used: set[int] = set()
    for axes in (st.model_axis, st.fsdp or None):
        if axes is None:
            continue
        cands = [
            d for d in range(len(dims))
            if d not in used and _fits(st.mesh, dims[d], axes) and dims[d] >= axes_size(st.mesh, axes)
        ]
        if cands:
            d = max(cands, key=lambda i: dims[i])
            entries[d] = axes
            used.add(d)
    return entries


def _param_spec(st: Strategy, path: str, dims: tuple[int, ...]) -> PartitionSpec:
    """The JAX package's ``_param_spec`` on one layer's tensor: ``path`` is
    the state-dict name with "/" for ".", ``dims`` its shape."""
    mesh = st.mesh
    ma, fsdp = st.model_axis, st.fsdp or None

    # ---- embeddings / lm head
    if re.search(r"embed/tok$", path):
        return P(_maybe(st, dims[0], ma), _maybe(st, dims[1], fsdp))
    if re.search(r"head/w$", path):
        return P(_maybe(st, dims[0], fsdp), _maybe(st, dims[1], ma))

    # ---- MoE experts (E, ...): expert-parallel over model
    if "/moe/" in path:
        if re.search(r"/router$", path):
            return P(None, _maybe(st, dims[-1], ma))
        if re.search(r"/moe/w[gud]($|/)", path):
            ent: list[Any] = [None] * len(dims)
            ent[0] = _maybe(st, dims[0], ma)
            if ent[0] is None and fsdp:  # fsdp strategy: shard experts on fsdp
                ent[0] = _maybe(st, dims[0], fsdp)
                return P(*ent)
            cands = [d for d in range(len(dims) - 1, 0, -1) if fsdp and _fits(mesh, dims[d], fsdp)]
            if cands:
                d = max(cands, key=lambda i: dims[i])
                ent[d] = fsdp
            return P(*ent)

    # ---- pixelfly sparse linears
    if re.search(r"/blocks$", path):  # (nb_out, r, b, b)
        nb, _, _, b2 = dims
        if _fits(mesh, nb, ma):
            return P(ma, None, None, _maybe(st, b2, fsdp))
        return P(_maybe(st, nb, fsdp), None, None, _maybe(st, b2, ma))
    if re.search(r"/U$", path):
        return P(_maybe(st, dims[0], fsdp), None)
    if re.search(r"/V$", path):
        return P(_maybe(st, dims[0], ma) or _maybe(st, dims[0], fsdp), None)

    # ---- dense linears
    if re.search(r"/(wo|wd|out_proj)/w$", path):
        return P(_maybe(st, dims[0], ma), _maybe(st, dims[1], fsdp))
    if re.search(r"/(wq|wk|wv|wg|wu|in_proj|w1|w2|qkv|proj)/w$", path):
        return P(_maybe(st, dims[0], fsdp), _maybe(st, dims[1], ma))
    if re.search(r"/b$", path) and len(dims) == 1:
        return P(_maybe(st, dims[0], ma))

    # ---- ssm internals
    if re.search(r"/conv_w$", path):
        return P(None, _maybe(st, dims[1], ma))

    if len(dims) <= 1:
        return P(*([None] * len(dims)))
    return P(*_greedy(st, dims))


def param_specs(st: Strategy, params: Mapping[str, Any]) -> dict[str, PartitionSpec]:
    """The spec of every tensor of a state dict (name -> anything with a
    ``shape``: tensors, meta tensors, numpy arrays)."""
    return {
        name: _param_spec(st, name.replace(".", "/"), tuple(int(n) for n in t.shape))
        for name, t in params.items()
    }


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def batch_specs(st: Strategy, batch) -> Any:
    """Shard every batch leaf's leading (batch) dim as much as divisible."""

    def spec(a):
        if len(a.shape) == 0:
            return P()
        return P(_batch_axes_for(st, a.shape[0]), *([None] * (len(a.shape) - 1)))

    return _tree_map(spec, batch)


def _paged_pool_spec(st: Strategy, shape: tuple[int, ...]) -> PartitionSpec:
    """Slot-shared page pools ``(count, n_pages, page, kv_heads,
    head_dim)``: the page axes are the allocator's (any page may map into
    any slot's table, and the host rewrites the table every step), so they
    stay whole; only a trailing head axis shards, kv_heads first, head_dim
    as the fallback for kv head counts the mesh does not divide. Data axes
    replicate: data parallelism in serving is replica routing."""
    ent: list[Any] = [None] * len(shape)
    ma = st.model_axis
    if ma and len(shape) >= 2:
        for d in (len(shape) - 2, len(shape) - 1):
            if _fits(st.mesh, shape[d], ma) and shape[d] >= axes_size(st.mesh, ma):
                ent[d] = ma
                break
    return P(*ent)


def cache_specs(st: Strategy, caches, *, layout: str = "decode") -> Any:
    """Decode caches: (count, B, ...) leaves. Batch over the data axes when
    divisible, model on the last divisible trailing dim (head_dim or
    state), never the sequence dim. ``layout="paged"``: the serving
    engine's slot-shared page pools (``_paged_pool_spec``)."""
    mesh = st.mesh
    if layout == "paged":
        return _tree_map(lambda a: _paged_pool_spec(st, tuple(a.shape)), caches)
    if layout != "decode":
        raise ValueError(f"unknown cache layout {layout!r}")

    def spec(a):
        shape = tuple(a.shape)
        if len(shape) <= 1:
            return P(*([None] * len(shape)))
        ent: list[Any] = [None] * len(shape)
        baxes = _batch_axes_for(st, shape[1])
        batch_sharded = bool(baxes) and shape[1] >= axes_size(mesh, baxes)
        if batch_sharded:
            ent[1] = baxes
        if st.model_axis:
            cands = [
                d for d in range(2, len(shape))
                if _fits(mesh, shape[d], st.model_axis) and shape[d] >= axes_size(mesh, st.model_axis)
            ]
            if cands:
                ent[cands[-1]] = st.model_axis
        if not batch_sharded and st.batch:
            # batch=1 long-context decode: shard the longest remaining dim
            # over the data axes instead of replicating the cache
            cands = [
                d for d in range(2, len(shape))
                if ent[d] is None and _fits(mesh, shape[d], st.batch) and shape[d] >= axes_size(mesh, st.batch)
            ]
            if cands:
                d = max(cands, key=lambda i: shape[i])
                ent[d] = st.batch
        return P(*ent)

    return _tree_map(spec, caches)


# ----------------------------------------------------------------------
# shards
# ----------------------------------------------------------------------


def model_dim(st: Strategy, spec: PartitionSpec) -> int | None:
    """The dimension a tensor-parallel spec shards over the model axis (None
    if it is replicated there, and always under ``Strategy("fsdp")``, which
    has no model axis). The tensor-parallel forms shard a dimension over
    the model axis alone: a spec that puts the model axis in a tuple with
    other axes is not one of their layouts."""
    for d, e in enumerate(spec):
        if e == st.model_axis and e is not None:
            return d
        if isinstance(e, tuple) and st.model_axis in e:
            raise ValueError(f"spec {spec} mixes the model axis with {e}: not a tensor-parallel layout")
    return None


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def positions(mesh: Mesh) -> list[dict[str, int]]:
    """Every position's coordinates (axis -> index), row-major over the
    mesh's axes: position i stands at ``mesh.devices.flat[i]``."""
    return [dict(zip(mesh.axis_names, c)) for c in itertools.product(*(range(n) for n in mesh.shape.values()))]


def position_slices(mesh: Mesh, spec: PartitionSpec, shape) -> list[tuple[tuple[int, int], ...]]:
    """Each position's slice of a tensor of ``shape`` laid out by ``spec``,
    row-major over the positions: one (start, stop) a dimension. A
    dimension whose entry names axes ``(a, b, ...)`` is cut into the
    product of their sizes and position ``(i_a, i_b, ...)`` takes block
    ``(i_a * size_b + i_b) ...`` (row-major in the tuple's order), as
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` places it."""
    shape = tuple(int(n) for n in shape)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for coords in positions(mesh):
        sl = []
        for n, e in zip(shape, entries):
            idx, count = 0, 1
            for a in _axes(e):
                idx, count = idx * mesh.shape[a] + coords[a], count * mesh.shape[a]
            if n % count:
                raise ValueError(f"spec {spec} cuts a dimension of {n} into {count}")
            sl.append((idx * n // count, (idx + 1) * n // count))
        out.append(tuple(sl))
    return out


def take(t: torch.Tensor, sl: tuple[tuple[int, int], ...]) -> torch.Tensor:
    """The slice ``sl`` of ``t`` (``position_slices``'s form), contiguous:
    ``t`` itself where the slice is the whole tensor, a view where only
    dimension 0 is cut."""
    for d, (a, b) in enumerate(sl):
        if (a, b) != (0, t.shape[d]):
            t = t.narrow(d, a, b - a)
    return t.contiguous()


def shard_state_dict(
    st: Strategy, mesh: Mesh, state_dict: Mapping[str, torch.Tensor]
) -> list[dict[str, torch.Tensor]]:
    """One state dict a position of ``mesh`` (row-major), each tensor cut
    by its spec (``position_slices``); positions that hold the same slice
    share one tensor, and a replicated tensor is the state dict's own in
    every position. Tensors stay where they are; the caller moves each
    shard to its device."""
    specs = param_specs(st, state_dict)
    out: list[dict[str, torch.Tensor]] = [{} for _ in range(mesh.size)]
    for name, t in state_dict.items():
        cut: dict = {}
        for p, sl in enumerate(position_slices(mesh, specs[name], t.shape)):
            if sl not in cut:
                cut[sl] = take(t, sl)
            out[p][name] = cut[sl]
    return out


def unshard_state_dict(
    st: Strategy, shards: list[Mapping[str, torch.Tensor]], specs: Mapping[str, PartitionSpec]
) -> dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict`` over ``st.mesh``, given the full
    tensors' specs (``param_specs`` of the state dict that was cut), on the
    first shard's device: each slice put back where its first position
    holds it; a replicated tensor is the first shard's."""
    out = {}
    for name, t in shards[0].items():
        shape = [n * max(1, int(np.prod([st.mesh.shape[a] for a in _axes(e)], dtype=np.int64)))
                 for n, e in zip(t.shape, tuple(specs[name]) + (None,) * t.ndim)]
        if list(t.shape) == shape:
            out[name] = t
            continue
        full = torch.empty(shape, dtype=t.dtype, device=t.device)
        done = set()
        for p, sl in enumerate(position_slices(st.mesh, specs[name], shape)):
            if sl not in done:
                done.add(sl)
                full[tuple(slice(a, b) for a, b in sl)] = shards[p][name].to(t.device)
        out[name] = full
    return out


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Refuse, with a ``ValueError`` naming the ROADMAP item, every
    configuration whose tensor-parallel layout the port does not have, in
    serving (prefill, partial prefill and decode) and in training alike.
    The port shards attention in the JAX "heads" mode (kv heads divisible
    by tp) and in the "seq" mode where tp does not divide the kv heads:
    the query rows over the shards in prefill and in training, the pools
    and caches on ``head_dim`` (the JAX rules' fallback, ``head_dim % tp ==
    0``). Dense and pixelfly linears shard on their output or input
    features (a pixelfly linear whose block rows tp does not divide on its
    blocks' output columns), the MoE family's experts and router on their
    expert axis, and the vocabulary. The Mamba2 mixer shards by its heads
    (``ssm.apply_ssm_tp``): tp must divide ``ssm_heads``, and B and C must
    be one group, which every shard takes whole."""
    if tp <= 1:
        return
    if cfg.has_ssm and (cfg.ssm_groups != 1 or cfg.ssm_heads % tp):
        raise ValueError(
            f"{cfg.name} at tp={tp}: its SSM mixer has {cfg.ssm_heads} heads and {cfg.ssm_groups} group(s) of B "
            f"and C, and the port shards it by whole heads of one group; {REFUSED['ssm_heads']}"
        )
    if cfg.num_kv_heads % tp == 0:
        return
    if cfg.head_dim % tp or cfg.head_dim < tp:
        raise ValueError(
            f"{cfg.name} at tp={tp}: neither its {cfg.num_kv_heads} kv heads nor its head_dim {cfg.head_dim} "
            f"divide over {tp} shards, so the JAX rules leave the pools whole, a layout the port does not have; "
            f"ROADMAP Queue 1 item 16"
        )
