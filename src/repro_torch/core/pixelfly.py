"""Pixelfly linear layer: ``W = γ·B + (1−γ)·U Vᵀ`` (paper §3.3 step 3).

A frozen ``LinearSpec`` (static pattern and shapes) plus a ``Linear``
module holding its parameters under the JAX package's names and layouts:
dense ``w`` is (in, out); sparse ``blocks`` (nb_out, r, b, b), ``U``
(in, rank), ``V`` (out, rank) and a float32 scalar ``gamma``. ``B`` is a
flat block butterfly in BSR layout (``repro_torch.core.butterfly``) whose
product runs through ``kernels.autograd.BsrMatmul`` (the forward and the
``dX`` of the backward are ``kernels.ops.bsr_matmul``). Every parameter
is trainable; serving runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

from repro_torch.analysis.roofline import uncounted
from repro_torch.core import budget as budget_lib
from repro_torch.core import butterfly
from repro_torch.kernels import autograd

__all__ = [
    "LinearSpec", "init_linear", "apply_linear", "linear_tables", "column_features", "param_count", "Linear",
]


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Static description of one linear layer (dense or pixelfly)."""

    in_features: int
    out_features: int
    sparse: bool = False
    block: int = 128
    max_stride: int = 1
    rank: int = 128
    use_bias: bool = False
    dtype: torch.dtype = torch.bfloat16

    def pattern(self) -> butterfly.FlatButterflyPattern:
        return butterfly.make_pattern(
            self.out_features,
            self.in_features,
            block=self.block,
            max_stride=self.max_stride,
        )

    @staticmethod
    def pixelfly(
        in_features: int,
        out_features: int,
        density: float,
        *,
        block: int = 128,
        lowrank_frac: float = 0.25,
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ) -> "LinearSpec":
        """Build a spec from a density budget (§3.3 step 2 split).

        If the features are not multiples of ``block``, the block is halved
        (down to 8) until they are; if even 8 does not divide, the layer
        falls back to dense. The CUDA kernel takes every block this gives
        (8, 16, 32, 64 and 128).
        """
        while block > 8 and (in_features % block or out_features % block):
            block //= 2
        if in_features % block or out_features % block:
            return LinearSpec.dense(
                in_features, out_features, use_bias=use_bias, dtype=dtype
            )
        rank, max_stride = budget_lib.split_sparse_lowrank(
            out_features,
            in_features,
            density,
            block=block,
            lowrank_frac=lowrank_frac,
        )
        return LinearSpec(
            in_features=in_features,
            out_features=out_features,
            sparse=True,
            block=block,
            max_stride=max_stride,
            rank=rank,
            use_bias=use_bias,
            dtype=dtype,
        )

    @staticmethod
    def dense(
        in_features: int,
        out_features: int,
        *,
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ) -> "LinearSpec":
        return LinearSpec(
            in_features=in_features,
            out_features=out_features,
            sparse=False,
            use_bias=use_bias,
            dtype=dtype,
        )


def _normal(
    shape: tuple[int, ...], std: float, gen: torch.Generator
) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def init_linear(spec: LinearSpec, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Random parameters with the JAX package's scales, drawn in float32
    on the CPU from ``gen`` and cast to the spec's dtype."""
    if not spec.sparse:
        std = 1.0 / math.sqrt(spec.in_features)
        p = {"w": _normal((spec.in_features, spec.out_features), std, gen)}
    else:
        pat = spec.pattern()
        # effective fan-in of the sparse term is r*block, of the low-rank
        # term `rank`: each is scaled so the summed variance matches dense
        p = {
            "blocks": _normal(
                (pat.nb_out, pat.r, spec.block, spec.block),
                1.0 / math.sqrt(pat.r * spec.block),
                gen,
            ),
            "U": _normal(
                (spec.in_features, spec.rank), 1.0 / math.sqrt(spec.in_features), gen
            ),
            "V": _normal(
                (spec.out_features, spec.rank), 1.0 / math.sqrt(max(1, spec.rank)), gen
            ),
        }
    p = {k: v.to(spec.dtype) for k, v in p.items()}
    if spec.sparse:
        p["gamma"] = torch.tensor(0.5, dtype=torch.float32)  # learnable γ
    if spec.use_bias:
        p["b"] = torch.zeros((spec.out_features,), dtype=spec.dtype)
    return p


def apply_linear(
    spec: LinearSpec,
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    rows: tuple[int, int] | None = None,
    cols: tuple[int, int] | None = None,
) -> torch.Tensor:
    """y = x @ W (+ bias), with the JAX package's rounding points: the BSR
    term comes back in x's dtype, ``x @ U`` and ``@ Vᵀ`` run in the model
    dtype, and ``γ·ys + (1−γ)·yl`` is combined in fp32 and cast back. The
    BSR term is ``autograd.BsrMatmul``; γ, U, V and the bias get their
    gradients from autograd, on the pattern's tables on x's device.

    ``rows`` (first, end): the params are a tensor-parallel shard that
    holds block rows [first, end) of the pattern (its rows of ``blocks``,
    ``V`` and the bias), and its tables are those rows of the global
    pattern's ``cols``. A shard's pattern is a row slice of the global
    butterfly, not the pattern of a narrower linear.

    ``cols`` (c0, c1): the shard holds output columns [c0, c1) of every
    block, ``blocks[:, :, :, c0:c1]`` (the JAX rules' layout where tp does
    not divide the block rows), and ``params["V"]`` and ``params["b"]`` are
    the whole ``V`` and bias (the caller gathers them: the JAX rules cut
    both in contiguous rows, which are not the shard's features). Its output is the features ``i·b + [c0, c1)``
    of every block row i, in that order (``column_features``). The BSR
    term runs on the kernel's square blocks: a (b, b/tp) block is tp
    stacked (b/tp)² blocks over consecutive input sub-blocks, so the shard
    is viewed as ``(nb_out, r·tp, b/tp, b/tp)`` over ``n_in / (b/tp)``
    input blocks (``linear_tables``); its dBlocks comes back through the
    view."""
    if not spec.sparse:
        y = torch.matmul(x, params["w"])
    else:
        g = params["gamma"].float()
        blocks, v = params["blocks"], params["V"]
        if cols is not None:
            nb, r, b, bc = blocks.shape
            blocks = blocks.reshape(nb, r * (b // bc), bc, bc)
            v = v.index_select(0, column_features(spec, cols, v.device))
        ys = autograd.bsr_matmul(x, blocks, linear_tables(spec, x.device, rows, cols))
        yl = torch.matmul(torch.matmul(x, params["U"]), v.t())
        y = (g * ys.float() + (1.0 - g) * yl.float()).to(x.dtype)
    if spec.use_bias:
        bias = params["b"]
        if cols is not None:
            bias = bias.index_select(0, column_features(spec, cols, bias.device))
        y = y + bias.to(y.dtype)
    return y


@functools.lru_cache(maxsize=512)
def linear_tables(
    spec: LinearSpec,
    device: torch.device,
    rows: tuple[int, int] | None = None,
    cols: tuple[int, int] | None = None,
) -> autograd.BsrTables:
    """The BSR tables (forward and transposed) of a sparse spec's pattern
    on ``device``, built once per spec, device and slice (``rows``: a
    shard's block rows of the pattern, all of them when None; ``cols``: a
    shard's output columns of every block, whose view of tp square blocks
    a slot reads input sub-block ``cols[i, t]·tp + j`` in slot ``t·tp + j``,
    ``apply_linear``)."""
    table = spec.pattern().cols
    if rows is not None:
        table = table[rows[0] : rows[1]]
    if cols is None:
        return autograd.bsr_tables(table, spec.in_features // spec.block, device)
    bc = cols[1] - cols[0]
    tp = spec.block // bc
    view = (table[:, :, None] * tp + np.arange(tp)).reshape(table.shape[0], -1)
    return autograd.bsr_tables(view, spec.in_features // bc, device)


@functools.lru_cache(maxsize=512)
@uncounted
def column_features(spec: LinearSpec, cols: tuple[int, int], device: torch.device) -> torch.Tensor:
    """The output features a column-sliced shard computes, in its order:
    ``i·b + c`` for every block row i and c in [c0, c1) (int64 on
    ``device``)."""
    nb = spec.out_features // spec.block
    idx = np.arange(nb)[:, None] * spec.block + np.arange(cols[0], cols[1])
    return torch.as_tensor(idx.reshape(-1), device=device)


def param_count(spec: LinearSpec) -> int:
    if not spec.sparse:
        n = spec.in_features * spec.out_features
    else:
        pat = spec.pattern()
        n = pat.nnz + spec.rank * (spec.in_features + spec.out_features) + 1
    return n + (spec.out_features if spec.use_bias else 0)


class Linear(nn.Module):
    """One dense or pixelfly linear; parameters named as in the JAX tree.
    A sparse pattern's BSR tables are looked up on the input's device at
    each call (cached per spec and device; not in the state dict).
    ``rows``: set on a tensor-parallel shard of a pixelfly linear, the
    block rows of the pattern it holds; ``cols``: set instead on a shard
    that holds output columns of every block, whose call takes the whole
    ``V`` and bias (``apply_linear``)."""

    def __init__(
        self, spec: LinearSpec, *, gen: torch.Generator, device: torch.device
    ):
        super().__init__()
        self.spec = spec
        self.rows: tuple[int, int] | None = None
        self.cols: tuple[int, int] | None = None
        for name, t in init_linear(spec, gen).items():
            self.register_parameter(name, nn.Parameter(t.to(device)))

    def forward(self, x: torch.Tensor, v: torch.Tensor | None = None, b: torch.Tensor | None = None) -> torch.Tensor:
        """``v``, ``b``: the whole ``V`` and bias of a column-sliced shard
        (else unused)."""
        params = self._parameters
        if v is not None or b is not None:
            params = {**params, **{k: t for k, t in (("V", v), ("b", b)) if t is not None}}
        return apply_linear(self.spec, params, x, self.rows, self.cols)
