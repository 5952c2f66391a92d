"""Per-layer split of a density budget into low-rank + flat butterfly
(paper §3.3 step 2). A numpy-only copy of ``split_sparse_lowrank`` from
the JAX package's ``core.budget``."""

from __future__ import annotations

from repro_torch.core import butterfly

__all__ = ["split_sparse_lowrank"]


def split_sparse_lowrank(
    out_features: int,
    in_features: int,
    density: float,
    *,
    block: int = 128,
    lowrank_frac: float = 0.25,
) -> tuple[int, int]:
    """Split a layer's density budget into (rank, max_stride).

    ~``lowrank_frac`` of the parameter budget goes to U Vᵀ; the rank is a
    multiple of 32, at least 32, and never more than ~1.5x its share. The
    remainder picks the largest flat-butterfly max stride that fits (at
    least the block diagonal).
    """
    total_params = density * out_features * in_features
    lr_params_per_rank = out_features + in_features
    gran = 32
    if lowrank_frac <= 0:
        return 0, butterfly.max_stride_for_density(
            in_features, block, max(density, block / in_features)
        )
    rank = int(lowrank_frac * total_params / lr_params_per_rank)
    rank = max(gran, (rank // gran) * gran)
    while rank > gran and rank * lr_params_per_rank > 1.5 * lowrank_frac * total_params:
        rank -= gran
    remaining = max(0.0, total_params - rank * lr_params_per_rank)
    sparse_density = remaining / (out_features * in_features)
    max_stride = butterfly.max_stride_for_density(
        in_features, block, max(sparse_density, block / in_features)
    )
    return rank, max_stride
