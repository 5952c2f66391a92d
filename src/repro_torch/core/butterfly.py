"""Flat block butterfly index math (paper §3, Defs 3.1-3.4, App. A, I.4).

A numpy copy of the JAX package's ``core.butterfly``. Patterns are static: they are fixed when the model is built.

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
import math

import numpy as np

__all__ = [
    "log2_int",
    "next_pow2",
    "flat_butterfly_strides",
    "flat_butterfly_cols",
    "dense_mask_from_cols",
    "block_cover",
    "block_cover_density",
    "butterfly_factor_matrix",
    "max_stride_for_density",
    "density_for_max_stride",
    "transpose_tables",
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


def dense_mask_from_cols(
    nb_out: int, nb_in: int, cols: np.ndarray, b: int
) -> np.ndarray:
    """The dense {0, 1} mask (out, in) of a pattern, float32."""
    mask = np.zeros((nb_out * b, nb_in * b), dtype=np.float32)
    for i in range(nb_out):
        for j in cols[i]:
            mask[i * b : (i + 1) * b, j * b : (j + 1) * b] = 1.0
    return mask


def block_cover(mask: np.ndarray, b1: int, b2: int) -> np.ndarray:
    """(b1, b2)-block cover of a mask (Def. A.1): a b1 x b2 block of the
    cover is all ones iff any entry of that block of ``mask`` is nonzero."""
    m, n = mask.shape
    if m % b1 or n % b2:
        raise ValueError("mask dims must be divisible by block dims")
    any_nz = (mask.reshape(m // b1, b1, n // b2, b2) != 0).any(axis=(1, 3))
    return np.repeat(np.repeat(any_nz, b1, axis=0), b2, axis=1).astype(mask.dtype)


def block_cover_density(mask: np.ndarray, b: int) -> float:
    """Fraction of the elements a block-``b`` device touches (Table 7)."""
    return float((block_cover(mask, b, b) != 0).mean())


def butterfly_factor_matrix(
    n: int, k: int, rng: np.random.Generator, block: int = 1
) -> np.ndarray:
    """A random block butterfly factor ``B_k^{(n, b)}`` (Def. 3.2), dense,
    float64, (n*block, n*block) with ``n`` in blocks: blocks (i, i) and
    (i, i XOR k/2) inside each aligned group of k, each drawn from ``rng``
    with std 1/sqrt(2*block), in row then column order."""
    if k < 2:
        raise ValueError("stride k must be >= 2")
    out = np.zeros((n * block, n * block), dtype=np.float64)
    half = k // 2
    for i in range(n):
        base = (i // k) * k
        for j in (i, base + ((i - base) ^ half)):
            out[i * block : (i + 1) * block, j * block : (j + 1) * block] = (
                rng.standard_normal((block, block)) / math.sqrt(2 * block)
            )
    return out


def density_for_max_stride(nb_in: int, max_stride: int, b: int, n_in: int) -> float:
    """Element density of a flat block butterfly of maximum stride
    ``max_stride``: (1 + log2 k) * b / n_in."""
    return (1 + len(flat_butterfly_strides(max_stride))) * b / n_in


def max_stride_for_density(n_in: int, b: int, density: float) -> int:
    """Largest power-of-2 max stride whose flat butterfly fits ``density``
    (inverts density = (1 + log2 k) * b / n_in); at least 1."""
    nb_in = max(1, n_in // b)
    g = next_pow2(nb_in)
    slots = max(1, int(density * n_in / b))
    k = 1 << min(slots - 1, log2_int(g))
    return max(1, k)


def transpose_tables(
    cols: np.ndarray, nb_in: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static transposed-pattern tables for the BSR backward pass.

    For each *input* block j, the list of (out-block i, slot t) pairs with
    ``cols[i, t] == j``, padded to the max fan-in. Returns
    (src_i, src_t, valid), each (nb_in, w). The transposed flat butterfly
    is itself a flat butterfly (XOR is an involution), so w == r for square
    patterns; rectangular stretches give ragged fan-in, hence the padding.
    """
    nb_out, r = cols.shape
    lists: list[list[tuple[int, int]]] = [[] for _ in range(nb_in)]
    for i in range(nb_out):
        for t in range(r):
            lists[int(cols[i, t])].append((i, t))
    w = max(1, max(len(l) for l in lists))
    src_i = np.zeros((nb_in, w), np.int32)
    src_t = np.zeros((nb_in, w), np.int32)
    valid = np.zeros((nb_in, w), np.float32)
    for j, l in enumerate(lists):
        for u, (i, t) in enumerate(l):
            src_i[j, u] = i
            src_t[j, u] = t
            valid[j, u] = 1.0
    return src_i, src_t, valid


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

    @property
    def density(self) -> float:
        return self.nnz / (self.out_features * self.in_features)

    def dense_mask(self) -> np.ndarray:
        return dense_mask_from_cols(self.nb_out, self.nb_in, self.cols, self.block)


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
