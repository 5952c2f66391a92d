"""Compute-budget allocation across layer types (paper §3.3, App. A, I.1):
give each layer type a share of the budget, then split each layer's share
~1/4 low rank : ~3/4 flat block butterfly. A copy of the JAX package's
``core.budget``, plain Python."""

from __future__ import annotations

import dataclasses

from repro_torch.core import butterfly

__all__ = [
    "LayerSchema",
    "dense_flops",
    "Allocation",
    "split_sparse_lowrank",
    "allocate",
    "solve_two_type_closed_form",
]


@dataclasses.dataclass(frozen=True)
class LayerSchema:
    """One row of the model schema {(type, repeats, m, n)} (App. K.2)."""

    kind: str  # e.g. "attn_proj", "mlp", "attention_matrix"
    repeats: int
    m: int  # out features (or sequence length for attention matrices)
    n: int  # in features
    seq_len: int = 1  # tokens multiplying this GEMM

    def dense_flops_per_token(self) -> float:
        return 2.0 * self.repeats * self.m * self.n


def dense_flops(schema: list[LayerSchema]) -> float:
    return sum(s.dense_flops_per_token() * s.seq_len for s in schema)


@dataclasses.dataclass(frozen=True)
class Allocation:
    """The density of one layer type and its split."""

    kind: str
    density: float
    lowrank_rank: int
    max_stride: int
    block: int


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


def allocate(
    schema: list[LayerSchema],
    total_density: float,
    *,
    block: int = 128,
    lowrank_frac: float = 0.25,
) -> dict[str, Allocation]:
    """The rule of thumb (§3.3 step 1): each layer type gets budget in
    proportion to its dense compute, which under a linear cost model is the
    same density ``total_density`` for every type; each is then split by
    ``split_sparse_lowrank`` at its own (m, n)."""
    out: dict[str, Allocation] = {}
    for s in schema:
        rank, max_stride = split_sparse_lowrank(
            s.m, s.n, total_density, block=block, lowrank_frac=lowrank_frac
        )
        out[s.kind] = Allocation(
            kind=s.kind, density=total_density, lowrank_rank=rank,
            max_stride=max_stride, block=block,
        )
    return out


def solve_two_type_closed_form(
    seq_len: int, d_model: int, param_budget: float
) -> tuple[float, float]:
    """App. I.1, Eq. 20: minimise d_a (s^2 + s d) + 2 d_m s d subject to
    params(d_a, d_m) <= budget, where attention holds 4 d^2 and the MLP
    8 d^2 parameters per unit density. The cost is linear, so the budget
    fills the type with the lower cost per parameter first. Returns
    (d_a, d_m), each in [0, 1]."""
    cost_a = seq_len * seq_len + seq_len * d_model
    cost_m = 2 * seq_len * d_model
    par_a = 4 * d_model * d_model
    par_m = 8 * d_model * d_model
    budget = param_budget
    dens = {"a": 0.0, "m": 0.0}
    order = sorted([("a", cost_a / par_a, par_a), ("m", cost_m / par_m, par_m)], key=lambda t: t[1])
    for kind, _, par in order:
        take = min(1.0, budget / par)
        dens[kind] = take
        budget -= take * par
        if budget <= 0:
            break
    return dens["a"], dens["m"]
