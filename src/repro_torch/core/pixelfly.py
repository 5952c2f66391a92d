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

import torch
from torch import nn

from repro_torch.core import budget as budget_lib
from repro_torch.core import butterfly
from repro_torch.kernels import autograd

__all__ = [
    "LinearSpec", "init_linear", "apply_linear", "linear_tables", "param_count", "Linear",
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
) -> torch.Tensor:
    """y = x @ W (+ bias), with the JAX package's rounding points: the BSR
    term comes back in x's dtype, ``x @ U`` and ``@ Vᵀ`` run in the model
    dtype, and ``γ·ys + (1−γ)·yl`` is combined in fp32 and cast back. The
    BSR term is ``autograd.BsrMatmul``; γ, U, V and the bias get their
    gradients from autograd, on the pattern's tables on x's device."""
    if not spec.sparse:
        y = torch.matmul(x, params["w"])
    else:
        g = params["gamma"].float()
        ys = autograd.bsr_matmul(x, params["blocks"], linear_tables(spec, x.device))
        yl = torch.matmul(torch.matmul(x, params["U"]), params["V"].t())
        y = (g * ys.float() + (1.0 - g) * yl.float()).to(x.dtype)
    if spec.use_bias:
        y = y + params["b"].to(y.dtype)
    return y


@functools.lru_cache(maxsize=512)
def linear_tables(spec: LinearSpec, device: torch.device) -> autograd.BsrTables:
    """The BSR tables (forward and transposed) of a sparse spec's pattern
    on ``device``, built once per spec and device."""
    return autograd.bsr_tables(spec.pattern().cols, spec.in_features // spec.block, device)


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
    each call (cached per spec and device; not in the state dict)."""

    def __init__(
        self, spec: LinearSpec, *, gen: torch.Generator, device: torch.device
    ):
        super().__init__()
        self.spec = spec
        for name, t in init_linear(spec, gen).items():
            self.register_parameter(name, nn.Parameter(t.to(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_linear(self.spec, self._parameters, x)
