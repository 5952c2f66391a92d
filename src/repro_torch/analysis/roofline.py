"""Roofline analysis of one step on an H100, the port of the JAX package's
``analysis/roofline.py``.

The JAX package parses a step's compiled HLO and walks its loops. Nothing
in the port has HLO, so the port counts one run of the step instead:

  - a ``TorchDispatchMode`` sees every aten op. It counts the FLOPs of the
    matmul-class ops only (mm, addmm, bmm, baddbmm, dot, mv, convolution,
    scaled-dot-product attention), as the JAX walker counts only dots and
    convolutions, and the bytes of every op that moves data: its operands
    plus its result. Views and allocations move none; a gather (embedding,
    index_select, gather, indexing) moves the rows it reads and writes; an
    in-place scatter (index_put_, copy_ into a view) the rows it writes.
  - the kernels' entry points in ``kernels/ops.py`` (``@metered``) report
    their own analytic FLOPs and bytes, the formulas behind
    ``chip_smoke.py``'s bound column: on the card the launches go through
    ``ctypes``, which a dispatch mode cannot see. While an entry point
    reports, the ops inside it (its plain version on the CPU) are not
    counted, so the CPU and the card read the same count.

  - the collectives of ``distributed.collectives`` and the mesh trainer's
    gathers and reduce-scatters (``training.loop.MeshState``) report
    themselves (``collective``): while one runs, the ops inside it (the
    one controller's copies, concatenations and sums) are not counted, and
    the collective adds its bytes to its class by the JAX walker's rule,
    the operand bytes of each position taking part, the result bytes for
    an all-gather. A copy that stays on one position is not a collective:
    the class and bytes are the caller's, who knows the positions, so a
    meta, a CPU and a card mesh count the same.
  - the memory the run creates: every storage an op (or a kernel entry
    point, or a collective, taken whole) creates is live from then until
    its last tensor dies (``weakref.finalize``); ``Tally.peak_bytes`` is
    the most that was live at once. While a step is counted, a collective
    gives each position its own result (``counting``), as a mesh of
    distinct devices holds it, so the count does not depend on how many
    devices the positions stand on.

The counts are per device. On one card collective bytes are 0; the
dry-run (``launch.dryrun``) counts the program of one position of a mesh.

Hardware constants: H100 SXM data sheet, 989 TFLOP/s bf16 dense on the
tensor cores, 67 TFLOP/s fp32 without them, 3.35 TB/s of HBM3, 450 GB/s
of NVLink a direction. ``HW.for_dtype`` picks the FLOP peak by dtype.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "HW",
    "Cost",
    "Tally",
    "count",
    "counting",
    "tally",
    "metered",
    "collective",
    "uncounted",
    "roofline_terms",
    "active_params",
    "model_flops",
]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12  # bf16 dense, tensor cores
    hbm_bw: float = 3.35e12  # bytes/s
    link_bw: float = 450e9  # bytes/s, NVLink 4, one direction
    fp32_flops: float = 67e12  # fp32, no tensor cores (the kernels use no TF32)

    def flops_for(self, dtype: str | torch.dtype) -> float:
        """The FLOP peak for a dtype: the fp32 one for float32, the bf16
        tensor-core one otherwise."""
        name = str(dtype).removeprefix("torch.")
        return self.fp32_flops if name == "float32" else self.peak_flops

    def for_dtype(self, dtype: str | torch.dtype) -> "HW":
        return dataclasses.replace(self, peak_flops=self.flops_for(dtype))


@dataclasses.dataclass
class Cost:
    flops: float
    bytes_accessed: float
    collective_bytes: dict  # per collective class (none on one card)
    n_collectives: int

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def divided(self, n: int) -> "Cost":
        """The count of one of ``n`` symmetric positions that this count
        covers together (a tensor-parallel replica's shards)."""
        return Cost(flops=self.flops / n, bytes_accessed=self.bytes_accessed / n,
                    collective_bytes={k: v / n for k, v in self.collective_bytes.items()},
                    n_collectives=self.n_collectives)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": dict(self.collective_bytes),
            "total_collective_bytes": self.total_collective_bytes,
        }


# ----------------------------------------------------------------------
# Counting one run
# ----------------------------------------------------------------------

aten = torch.ops.aten

# ops that move no bytes: allocations and aliasing
_FREE = {
    aten.detach, aten.alias, aten.empty, aten.empty_like, aten.empty_strided,
    aten.new_empty, aten.new_empty_strided, aten.lift_fresh, aten._unsafe_view,
    aten.resize_, aten.set_, aten._local_scalar_dense,
}
# gathers: they read the rows they write
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index}
# in-place scatters: they write (and read) the rows of their values
_SCATTERS = {aten.index_put_, aten._index_put_impl_}
_SDPA = {
    getattr(aten, name)
    for name in (
        "_scaled_dot_product_flash_attention",
        "_scaled_dot_product_efficient_attention",
        "_scaled_dot_product_cudnn_attention",
        "_scaled_dot_product_flash_attention_for_cpu",
        "_scaled_dot_product_attention_math",
    )
    if hasattr(aten, name)
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collect(x: Any, out: list) -> None:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _collect(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _collect(v, out)


def _tensors(x: Any) -> list[torch.Tensor]:
    """The tensors in ``x`` (nested tuples, lists and dicts), in order."""
    out: list = []
    _collect(x, out)
    return out


@functools.lru_cache(maxsize=None)
def _fresh(func) -> bool:
    """Whether every result of the aten op ``func`` is a new tensor (no
    result aliases an input: not a view, an in-place or an out= op)."""
    return not func.is_view and all(r.alias_info is None for r in func._schema.returns)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _matmul_flops(packet, args, out) -> float:
    """2 x (output elements) x (contraction length) for the matmul-class
    ops, 0 for every other op."""
    if packet in (aten.mm, aten.bmm):
        return 2.0 * _numel(out.shape) * args[0].shape[-1]
    if packet in (aten.addmm, aten.baddbmm):
        return 2.0 * _numel(out.shape) * args[1].shape[-1]
    if packet in (aten.dot, aten.mv):
        return 2.0 * _numel(args[0].shape)
    if packet is aten.addmv:
        return 2.0 * _numel(args[1].shape)
    if packet is aten.convolution:
        w, transposed = args[1], args[6]
        per_out = _numel(w.shape[1:]) if not transposed else w.shape[0] * _numel(w.shape[2:])
        return 2.0 * _numel(out.shape) * per_out
    if packet in _SDPA:
        q, k = args[0], args[1]  # (B, H, S, D)
        return 4.0 * _numel(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
    return 0.0


def _storages(tensors) -> list:
    return [t.untyped_storage() for t in tensors]


class Tally(TorchDispatchMode):
    """The count of one run (``counting``): FLOPs, bytes, collective bytes
    by class, and the memory the run created (``live_bytes`` now,
    ``peak_bytes`` at most)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes: dict[str, float] = {}
        self.n_collectives = 0
        self.quiet = 0  # > 0 while a metered entry point or a collective runs
        self.live_bytes = 0
        self.peak_bytes = 0
        self._created: dict[int, int] = {}  # live storages this run created

    def cost(self) -> Cost:
        return Cost(flops=self.flops, bytes_accessed=self.bytes,
                    collective_bytes=dict(self.collective_bytes), n_collectives=self.n_collectives)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.quiet:
            outs = _tensors(out)
            self._add(func, args, kwargs, outs)
            if outs and _fresh(func):
                self._track(outs, ())
        return out

    def note(self, inputs, outputs) -> None:
        """Track the storages of ``outputs`` that are not ``inputs``' and
        not yet tracked: created by the call that took ``inputs``."""
        outs = _tensors(outputs)
        if outs:
            self._track(outs, {st._cdata for st in _storages(_tensors(inputs))})

    def _track(self, outs: list, seen) -> None:
        for st in _storages(outs):
            key = st._cdata
            if key in seen or key in self._created:
                continue
            n = st.nbytes()
            self._created[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    def created_bytes(self, outputs) -> int:
        """Bytes of the distinct live storages of ``outputs`` that this run
        created."""
        keys = {st._cdata for st in _storages(_tensors(outputs))}
        return sum(self._created.get(k, 0) for k in keys)

    def _free(self, key: int, n: int) -> None:
        if self._created.pop(key, None) is not None:
            self.live_bytes -= n

    def _add(self, func, args, kwargs, outs: list) -> None:
        packet = func.overloadpacket
        if outs:
            self.flops += _matmul_flops(packet, args, outs[0])
        if packet in _FREE or func.is_view:
            return
        if packet in _GATHERS:
            idx = _tensors(args[1:]) + _tensors(kwargs)
            self.bytes += 2 * sum(map(_nbytes, outs)) + sum(map(_nbytes, idx))
        elif packet in _SCATTERS:
            values, idx = args[2], _tensors(args[1])
            self.bytes += 2 * _nbytes(values) + sum(map(_nbytes, idx))
        elif packet is aten.copy_:
            self.bytes += _nbytes(args[0]) + _nbytes(args[1])
        else:
            ins = _tensors(args) + _tensors(kwargs)
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


# the tally of the run being counted, if any
_active: Tally | None = None


def tally() -> Tally | None:
    """The tally of the run being counted (None outside ``counting``)."""
    return _active


def _reporting(fn: Callable, args, kwargs, report: Callable[[Tally, Any], None]):
    """``fn(*args, **kwargs)`` with its ops hidden from the active tally,
    then ``report(tally, result)`` and its new storages tracked."""
    c = _active
    if c is None or c.quiet:
        return fn(*args, **kwargs)
    c.quiet += 1
    try:
        out = fn(*args, **kwargs)
        report(c, out)
    finally:
        c.quiet -= 1
    c.note((args, kwargs), out)
    return out


def metered(cost_fn: Callable[..., tuple[float, float]]) -> Callable:
    """Decorator for a kernel entry point: while ``count`` runs, the call
    adds ``cost_fn(*args, **kwargs)`` = (FLOPs, bytes) and nothing of the
    ops inside it; its result's memory is tracked. Outside ``count`` it
    costs one global read."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _active is None:
                return fn(*args, **kwargs)

            def rep(c, out):
                flops, nbytes = cost_fn(*args, **kwargs)
                c.flops += flops
                c.bytes += nbytes

            return _reporting(fn, args, kwargs, rep)

        return inner

    return wrap


def uncounted(fn: Callable) -> Callable:
    """Decorator for a cached upload of a static table (a BSR pattern's
    tables, an attention schedule): while a step is counted its ops and
    its memory do not count, so a count does not depend on whether an
    earlier run in the process filled the cache."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        c = _active
        if c is None:
            return fn(*args, **kwargs)
        c.quiet += 1
        try:
            return fn(*args, **kwargs)
        finally:
            c.quiet -= 1

    return inner


def collective(kind: str | None, nbytes: float, fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``, the port's form of one collective, as
    the walker counts one: while ``count`` runs, its ops add no FLOPs or
    bytes, and ``nbytes`` (the operand bytes of every position taking
    part, the result bytes for an all-gather) go to class ``kind``
    ("all-gather", "all-reduce", "reduce-scatter"). ``kind=None`` moves
    nothing between positions (its ops are hidden all the same)."""

    def rep(c: Tally, out) -> None:
        if kind is not None and nbytes:
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + float(nbytes)
            c.n_collectives += 1

    return _reporting(fn, args, kwargs, rep)


@contextlib.contextmanager
def counting() -> Iterator[Tally]:
    """Count everything run inside the block into the yielded ``Tally``."""
    global _active
    if _active is not None:
        raise RuntimeError("roofline.count is not reentrant")
    t = Tally()
    _active = t
    try:
        with t:
            yield t
    finally:
        _active = None


def count(fn: Callable[[], Any]) -> tuple[Any, Cost]:
    """Run ``fn()`` once and return (its result, its Cost)."""
    with counting() as t:
        out = fn()
    return out, t.cost()


# ----------------------------------------------------------------------
# Roofline terms
# ----------------------------------------------------------------------


def roofline_terms(cost: Cost, hw: HW = HW()) -> dict:
    """Per-device time lower bounds for the three roofline terms."""
    t_c = cost.flops / hw.peak_flops
    t_m = cost.bytes_accessed / hw.hbm_bw
    t_x = cost.total_collective_bytes / hw.link_bw
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(t_c, t_m, t_x)
    terms["roofline_fraction_compute"] = t_c / total if total else 0.0
    return terms


# ----------------------------------------------------------------------
# Analytic MODEL_FLOPS (6·N·D, N_active for MoE)
# ----------------------------------------------------------------------


def active_params(cfg) -> int:
    """Matmul parameters touched per token (MoE: shared + top-k routed),
    excluding embeddings and the lm head (the 6ND convention)."""
    from repro_torch.core.pixelfly import param_count
    from repro_torch.models.layers import linear_spec
    from repro_torch.models.moe import MoeSpec
    from repro_torch.models.ssm import SsmSpec

    def mlp(d_ff: int) -> int:
        return sum(
            param_count(linear_spec(cfg, din, dout, False))
            for din, dout in ((cfg.d_model, d_ff), (cfg.d_model, d_ff), (d_ff, cfg.d_model))
        )

    total = 0
    for g in cfg.layer_groups():
        per_layer = 0
        if g.kind in ("dense", "shared_attn", "moe"):
            per_layer += sum(
                param_count(linear_spec(cfg, din, dout, bias))
                for din, dout, bias in (
                    (cfg.d_model, cfg.q_dim, cfg.qkv_bias),
                    (cfg.d_model, cfg.kv_dim, cfg.qkv_bias),
                    (cfg.d_model, cfg.kv_dim, cfg.qkv_bias),
                    (cfg.q_dim, cfg.d_model, False),
                )
            )
        if g.kind in ("dense", "shared_attn"):
            d_ff = cfg.d_ff
            if g.kind == "dense" and cfg.family == "moe" and cfg.moe_dense_ff:
                d_ff = cfg.moe_dense_ff
            per_layer += mlp(d_ff)
        if g.kind == "moe":
            spec = MoeSpec(cfg)
            if cfg.sparse:
                pat_gu, rank_gu = spec.sparse_layout(cfg.d_model, spec.d_ff)
                pat_d, rank_d = spec.sparse_layout(spec.d_ff, cfg.d_model)
                per_exp = (
                    2 * (pat_gu.nnz + rank_gu * (cfg.d_model + spec.d_ff))
                    + pat_d.nnz + rank_d * (cfg.d_model + spec.d_ff)
                )
            else:
                per_exp = 3 * cfg.d_model * spec.d_ff
            per_layer += cfg.moe_top_k * per_exp
            if cfg.moe_num_shared:
                per_layer += mlp(cfg.moe_num_shared * spec.d_ff)
            per_layer += cfg.d_model * spec.n_exp  # router
        if g.kind == "ssm":
            s = SsmSpec(cfg)
            per_layer += param_count(s.in_proj) + param_count(s.out_proj)
            per_layer += s.conv_dim * cfg.ssm_conv
        total += per_layer * g.count
    return total


def model_flops(cfg, n_tokens: int, *, backward: bool = True) -> float:
    """6·N_active·D (training) or 2·N_active·D (inference)."""
    mult = 6.0 if backward else 2.0
    return mult * active_params(cfg) * n_tokens
