"""Flat block butterfly index math (paper §3, Defs 3.1-3.4, App. I.4).

A numpy copy of the part of the JAX package's ``core.butterfly`` that the
port uses. Patterns are static: they are fixed when the model is built.

A flat block butterfly of logical size ``(out, in)`` with block size ``b``
and maximum stride ``k`` is stored as

  blocks : (nb_out, r, b, b)   dense parameter blocks
  cols   : (nb_out, r)         static int32 column-block index per slot

with ``r = 1 + log2(k)``: the block diagonal plus one slot per stride
``s ∈ {1, 2, …, k/2}`` connecting block-row ``i`` to block-column
``i XOR s``. Rectangular matrices stretch the square pattern on the
smallest power-of-two grid covering both sides; duplicate columns that the
stretch produces are kept (they sum).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "log2_int",
    "next_pow2",
    "flat_butterfly_strides",
    "flat_butterfly_cols",
    "max_stride_for_density",
    "FlatButterflyPattern",
    "make_pattern",
]


def log2_int(x: int) -> int:
    """Exact integer log2; raises if ``x`` is not a positive power of 2."""
    if x <= 0 or (x & (x - 1)) != 0:
        raise ValueError(f"{x} is not a positive power of two")
    return x.bit_length() - 1


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (x >= 1)."""
    if x < 1:
        raise ValueError("x must be >= 1")
    return 1 << (x - 1).bit_length()


def flat_butterfly_strides(max_stride: int) -> list[int]:
    """Strides (block units) {1, 2, ..., k/2} of a flat butterfly of
    maximum stride ``k``."""
    if max_stride == 1:
        return []
    m = log2_int(max_stride)
    return [1 << t for t in range(m)]


def flat_butterfly_cols(
    nb_out: int, nb_in: int, max_stride: int
) -> np.ndarray:
    """Static block-column index table ``cols[nb_out, r]``."""
    if nb_out < 1 or nb_in < 1:
        raise ValueError("need at least one block in each dimension")
    g = next_pow2(max(nb_out, nb_in))
    max_stride = min(max_stride, g)
    strides = flat_butterfly_strides(max_stride)
    r = 1 + len(strides)
    cols = np.empty((nb_out, r), dtype=np.int32)
    for i in range(nb_out):
        gi = i * g // nb_out  # stretch the out-row onto the square grid
        cs = [gi] + [gi ^ s for s in strides]
        cols[i] = [c * nb_in // g for c in cs]
    return cols


def max_stride_for_density(n_in: int, b: int, density: float) -> int:
    """Largest power-of-2 max stride whose flat butterfly fits ``density``
    (inverts density = (1 + log2 k) * b / n_in); at least 1."""
    nb_in = max(1, n_in // b)
    g = next_pow2(nb_in)
    slots = max(1, int(density * n_in / b))
    k = 1 << min(slots - 1, log2_int(g))
    return max(1, k)


@dataclasses.dataclass(frozen=True)
class FlatButterflyPattern:
    """Frozen description of one flat block butterfly weight pattern."""

    out_features: int
    in_features: int
    block: int
    max_stride: int
    cols: np.ndarray  # (nb_out, r) int32

    @property
    def nb_out(self) -> int:
        return self.out_features // self.block

    @property
    def nb_in(self) -> int:
        return self.in_features // self.block

    @property
    def r(self) -> int:
        return self.cols.shape[1]

    @property
    def nnz(self) -> int:
        return self.nb_out * self.r * self.block * self.block


def make_pattern(
    out_features: int,
    in_features: int,
    *,
    block: int = 128,
    max_stride: int | None = None,
    density: float | None = None,
) -> FlatButterflyPattern:
    """Build the static pattern for an ``(out, in)`` weight. At most one
    of ``max_stride`` / ``density``; with neither, the full butterfly."""
    if out_features % block or in_features % block:
        raise ValueError(
            f"features ({out_features}, {in_features}) must be multiples of "
            f"block {block}"
        )
    nb_out, nb_in = out_features // block, in_features // block
    g = next_pow2(max(nb_out, nb_in))
    if max_stride is not None and density is not None:
        raise ValueError("give at most one of max_stride / density")
    if max_stride is None:
        if density is not None:
            max_stride = max_stride_for_density(in_features, block, density)
        else:
            max_stride = g
    max_stride = min(next_pow2(max_stride), g)
    cols = flat_butterfly_cols(nb_out, nb_in, max_stride)
    return FlatButterflyPattern(
        out_features=out_features,
        in_features=in_features,
        block=block,
        max_stride=max_stride,
        cols=cols,
    )
