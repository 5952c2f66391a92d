"""Mixture-of-Experts FFN of the port: shared experts and routed top-k
(DeepSeekMoE-style), the counterpart of the JAX package's ``models/moe.py``.

Dispatch is sort-based: each routing group's (token, choice) pairs are
sorted by expert with a stable sort, cut at the expert capacity, and laid
into a (groups, experts, capacity, d) buffer, so the experts' products are
the activated products only. Tokens past capacity are dropped exactly where
the reference drops them, and padding tokens count against capacity as
they do there.

Expert weights are stacked on a leading expert axis, under the reference's
names: dense ``wg``/``wu``/``wd`` (E, in, out); with ``cfg.sparse`` each is
a pixelfly parameter set ``blocks`` (E, nb_out, r, b, b), ``U`` (E, in,
rank), ``V`` (E, out, rank) and ``gamma`` (E,). The routed experts' BSR
product is plain torch (per-slot block gathers and batched products), as
the reference computes it outside any Pallas kernel; the shared experts
are a ``layers.Mlp`` and run through the port's linears and their kernel.
The router is fp32.

The combine sums each token's k expert outputs in a fixed order (by
expert id, the order the reference's scatter-add visits them), through
the inverse of the sort permutation: no atomic scatter, so the CPU and
the card sum alike.

``apply_moe_tp`` is the expert-parallel form on ``tp`` shards, the JAX
rules' layout (experts and router columns on the model axis): the router
logits are all-gathered along E so every shard routes as one device does,
each shard runs its experts on its capacity rows, and the fp32 partial
combines are all-reduced (``distributed.collectives``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.roofline import uncounted
from repro_torch.configs.base import ModelConfig
from repro_torch.core import budget as budget_lib
from repro_torch.core import butterfly
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L

__all__ = ["MoeSpec", "Routing", "Moe", "capacity", "routing_groups", "route", "router_logits", "route_logits",
           "apply_moe", "apply_moe_tp"]


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    cfg: ModelConfig

    @property
    def n_exp(self) -> int:
        return self.cfg.moe_num_experts

    @property
    def d_ff(self) -> int:
        return self.cfg.moe_d_ff

    def sparse_layout(self, din: int, dout: int) -> tuple[butterfly.FlatButterflyPattern, int]:
        """(pattern, rank) of the pixelfly weight of an expert GEMM, at the
        config's block (no halving, as the reference)."""
        return _layout(self.cfg.sparse_density, self.cfg.sparse_block, self.cfg.lowrank_frac, din, dout)


@functools.lru_cache(maxsize=64)
def _layout(density: float, block: int, lowrank_frac: float, din: int, dout: int):
    rank, max_stride = budget_lib.split_sparse_lowrank(
        dout, din, density, block=block, lowrank_frac=lowrank_frac
    )
    return butterfly.make_pattern(dout, din, block=block, max_stride=max_stride), rank


@functools.lru_cache(maxsize=64)
@uncounted
def _cols(density, block, lowrank_frac, din, dout, device: torch.device) -> torch.Tensor:
    pat, _ = _layout(density, block, lowrank_frac, din, dout)
    return torch.as_tensor(pat.cols, dtype=torch.long, device=device)


def _normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


class ExpertPixelfly(nn.Module):
    """The stacked pixelfly weights of one expert GEMM, E experts."""

    def __init__(self, spec: MoeSpec, din: int, dout: int, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        c, e = spec.cfg, spec.n_exp
        pat, rank = spec.sparse_layout(din, dout)
        b = c.sparse_block
        dt = c.torch_dtype
        self.blocks = nn.Parameter(_normal((e, pat.nb_out, pat.r, b, b), 1 / math.sqrt(pat.r * b), gen).to(dt).to(device))
        self.U = nn.Parameter(_normal((e, din, rank), 1 / math.sqrt(din), gen).to(dt).to(device))
        self.V = nn.Parameter(_normal((e, dout, rank), 1 / math.sqrt(rank), gen).to(dt).to(device))
        self.gamma = nn.Parameter(torch.full((e,), 0.5, dtype=torch.float32, device=device))


class Moe(nn.Module):
    """Router (d, E) fp32, the routed experts' ``wg``/``wu``/``wd`` and,
    with ``moe_num_shared``, the shared experts' ``shared`` SwiGLU MLP of
    width ``moe_num_shared * moe_d_ff``."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        self.spec = spec = MoeSpec(cfg)
        e, d, f = spec.n_exp, cfg.d_model, spec.d_ff
        self.router = nn.Parameter(_normal((d, e), d ** -0.5, gen).to(device))
        for name, (din, dout) in (("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d))):
            if cfg.sparse:
                self.add_module(name, ExpertPixelfly(spec, din, dout, gen=gen, device=device))
            else:
                w = _normal((e, din, dout), 1 / math.sqrt(din), gen).to(cfg.torch_dtype).to(device)
                self.register_parameter(name, nn.Parameter(w))
        if cfg.moe_num_shared:
            self.shared = L.Mlp(cfg, cfg.moe_num_shared * f, gen=gen, device=device)


# ----------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for a routing group of t tokens: the reference's
    ``max(8, ceil(int(factor * t * k / E) / 8) * 8)``."""
    cap = int(cfg.moe_capacity_factor * t * cfg.moe_top_k / cfg.moe_num_experts)
    return max(8, int(math.ceil(cap / 8) * 8))


@dataclasses.dataclass
class Routing:
    """One call's routing, per group g of t tokens (tk = t * k pairs):
    ``idx`` (g, t, k) the chosen experts, ``gates`` their renormalised
    probabilities, ``order`` (g, tk) the stable sort of the flat choices
    by expert, ``slot`` (g, tk) each sorted pair's buffer row
    ``expert * cap + position`` (``E * cap``, a trash row, where dropped),
    ``keep`` (g, tk) whether it was kept, and the load-balance loss."""

    groups: int
    t: int
    cap: int
    idx: torch.Tensor
    gates: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    lb_loss: torch.Tensor


def routing_groups(cfg: ModelConfig, tokens: int) -> int:
    """The routing groups of ``tokens`` tokens: ``cfg.moe_routing_groups``,
    lowered until it divides them (at least 1)."""
    groups = max(1, min(cfg.moe_routing_groups, tokens))
    while tokens % groups:
        groups -= 1
    return groups


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor) -> Routing:
    """The reference's routing of x (B, S, D): groups, fp32 softmax over
    the router's logits, top-k with gates renormalised, the Switch-style
    load-balance loss, and the capacity cut of the sort-based dispatch."""
    return route_logits(cfg, router_logits(cfg, router, x))


def router_logits(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) in its routing groups (g, t, D), times the router's
    columns (all of them, or a shard's) in fp32: (g, t, columns)."""
    b, s, d = x.shape
    groups = routing_groups(cfg, b * s)
    xf = x.reshape(groups, b * s // groups, d)
    return torch.matmul(xf.float(), router.float())


def route_logits(cfg: ModelConfig, logits: torch.Tensor) -> Routing:
    """``route`` from the (g, t, E) fp32 router logits of every expert."""
    groups, t, e = logits.shape
    k = cfg.moe_top_k
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    me = probs.mean(dim=1)  # (g, e)
    fe = idx.reshape(groups, t * k)
    ce = torch.zeros((groups, e), device=dev).scatter_add_(1, fe, torch.ones(fe.shape, device=dev)) / (t * k)
    lb = e * (me * ce).sum(dim=-1).mean()

    cap = capacity(cfg, t)
    order = torch.argsort(fe, dim=-1, stable=True)
    se = torch.gather(fe, 1, order)  # sorted expert ids
    experts = torch.arange(e, device=dev).expand(groups, e).contiguous()
    starts = torch.searchsorted(se, experts)  # (g, e)
    pos = torch.arange(t * k, device=dev)[None] - torch.gather(starts, 1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)
    return Routing(groups, t, cap, idx, gates, order, slot, keep, lb)


# ----------------------------------------------------------------------
# experts
# ----------------------------------------------------------------------


def _bsr(x: torch.Tensor, blocks: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x (G, E, C, din) @ each expert's BSR weight: for every slot t of the
    pattern, gather the input blocks ``cols[:, t]`` and take the batched
    (C, b) @ (b, b) products, summed over t in the input's dtype."""
    b = blocks.shape[-1]
    nb_out, r = cols.shape
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // b, b)
    y = None
    for t in range(r):
        xg = xb.index_select(-2, cols[:, t])  # (G, E, C, nb_out, b)
        yt = torch.einsum("gecik,eikm->gecim", xg, blocks[:, :, t])
        y = yt if y is None else y + yt
    return y.reshape(*x.shape[:-1], nb_out * b)


def _expert_matmul(spec: MoeSpec, w, x: torch.Tensor, din: int, dout: int) -> torch.Tensor:
    """x (G, E, C, din) @ the per-expert weight -> (G, E, C, dout), with the
    reference's rounding points: the BSR term in x's dtype, the low-rank
    term in x's dtype then fp32, ``gamma`` mixing in fp32."""
    c = spec.cfg
    if not c.sparse:
        return torch.einsum("gecd,edf->gecf", x, w).to(x.dtype)
    cols = _cols(c.sparse_density, c.sparse_block, c.lowrank_frac, din, dout, x.device)
    if torch.is_grad_enabled():
        # recomputed in the backward, as the reference's jax.checkpoint
        ys = checkpoint(_bsr, x, w.blocks, cols, use_reentrant=False)
    else:
        ys = _bsr(x, w.blocks, cols)
    xu = torch.einsum("gecd,edr->gecr", x, w.U)
    yl = torch.einsum("gecr,eor->geco", xu, w.V).float()
    g = w.gamma[None, :, None, None].float()
    return (g * ys + (1.0 - g) * yl).to(x.dtype)


def _expert_ffn(spec: MoeSpec, moe: Moe, x: torch.Tensor) -> torch.Tensor:
    d, f = spec.cfg.d_model, spec.d_ff
    gate = _expert_matmul(spec, moe.wg, x, d, f)
    up = _expert_matmul(spec, moe.wu, x, d, f)
    h = F.silu(gate.float()).to(x.dtype) * up
    return _expert_matmul(spec, moe.wd, h, f, d)


def _dispatch(x: torch.Tensor, r: Routing, slot: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Every token's k copies, permuted into expert order (the sort is a
    permutation, so neither this gather nor its backward collides), laid
    into buffer rows ``slot`` (g, tk) of n_rows + 1, the last a trash row
    for the pairs this buffer does not keep: (g, n_rows, d)."""
    d = x.shape[-1]
    g, k = r.groups, r.idx.shape[-1]
    tk = r.t * k
    xk = x.reshape(g, r.t, 1, d).expand(g, r.t, k, d).reshape(g, tk, d)
    xs = torch.gather(xk, 1, r.order[..., None].expand(g, tk, d))
    buf = x.new_zeros((g, n_rows + 1, d)).scatter(1, slot[..., None].expand(g, tk, d), xs)
    return buf[:, :n_rows]


def _combine(yb: torch.Tensor, r: Routing, slot: torch.Tensor) -> torch.Tensor:
    """The gated sum of each token's k expert outputs read from buffer
    rows ``slot`` (the trash row reads zeros): fp32 (g, t, d), each
    token's choices summed in expert-id order through the inverse of the
    sort permutation (no atomics)."""
    g, n_rows, d = yb.shape
    k = r.idx.shape[-1]
    tk = r.t * k
    yflat = torch.cat([yb, yb.new_zeros((g, 1, d))], dim=1)
    ys = torch.gather(yflat, 1, slot[..., None].expand(g, tk, d))
    gflat = torch.gather(r.gates.reshape(g, tk), 1, r.order)
    contrib = ys.float() * gflat[..., None]
    inv = torch.argsort(r.order, dim=-1)  # back to (token, choice) order
    contrib = torch.gather(contrib, 1, inv[..., None].expand(g, tk, d)).reshape(g, r.t, k, d)
    by_expert = torch.argsort(r.idx, dim=-1)  # each token's choices by expert id
    contrib = torch.gather(contrib, 2, by_expert[..., None].expand(g, r.t, k, d))
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


def apply_moe(moe: Moe, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), load-balance loss). The dispatch,
    the expert products and the combine run inside the profiler ranges
    ``moe_dispatch``, ``moe_experts`` and ``moe_combine``."""
    spec = moe.spec
    cfg = spec.cfg
    b, s, d = x.shape
    with torch.profiler.record_function("moe_dispatch"):
        r = route(cfg, moe.router, x)
        n_rows = spec.n_exp * r.cap
        buf = _dispatch(x, r, r.slot, n_rows).reshape(r.groups, spec.n_exp, r.cap, d)
    with torch.profiler.record_function("moe_experts"):
        yb = _expert_ffn(spec, moe, buf)
    with torch.profiler.record_function("moe_combine"):
        y = _combine(yb.reshape(r.groups, n_rows, d), r, r.slot).to(x.dtype).reshape(b, s, d)
    if cfg.moe_num_shared:
        y = y + L.apply_mlp(moe.shared, x)
    return y, r.lb_loss


def apply_moe_tp(moes: list[Moe], xs: list[torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor]:
    """``apply_moe`` on ``tp`` expert-parallel shards, the JAX rules'
    layout: shard j holds the router's columns and the weights of experts
    [j·E/tp, (j+1)·E/tp) (``moes[j]``) and ``xs[j]`` is the (replicated)
    input on its device. Each shard takes its router columns' logits in
    fp32; they are all-gathered along E, so every shard routes every token
    as one device does (the global E in ``capacity``, the global stable
    sort: the same pairs are dropped). Each shard dispatches only into its
    experts' capacity rows, runs its experts, and combines its pairs (the
    others read zeros) in fp32; the partial combines are all-reduced, cast,
    and added to the shared experts' output (``layers.tp_mlp``). Returns
    each shard's y and the load-balance loss, taken once (shard 0's)."""
    spec = moes[0].spec
    cfg = spec.cfg
    b, s, d = xs[0].shape
    el = moes[0].router.shape[1]  # experts a shard
    with torch.profiler.record_function("moe_dispatch"):
        logits = C.all_gather([router_logits(cfg, m.router, x) for m, x in zip(moes, xs)], dim=-1)
        routes = [route_logits(cfg, lg) for lg in logits]
        slots, bufs = [], []
        for j, (x, r) in enumerate(zip(xs, routes)):
            n_rows = el * r.cap
            local = r.slot - j * n_rows
            slot = torch.where((local >= 0) & (local < n_rows), local, n_rows)
            slots.append(slot)
            bufs.append(_dispatch(x, r, slot, n_rows).reshape(r.groups, el, r.cap, d))
    with torch.profiler.record_function("moe_experts"):
        ybs = [_expert_ffn(spec, m, buf) for m, buf in zip(moes, bufs)]
    with torch.profiler.record_function("moe_combine"):
        parts = [_combine(yb.reshape(r.groups, el * r.cap, d), r, slot) for yb, r, slot in zip(ybs, routes, slots)]
        ys = [y.to(x.dtype).reshape(b, s, d) for y, x in zip(C.all_reduce(parts), xs)]
    if cfg.moe_num_shared:
        ys = [y + sh for y, sh in zip(ys, L.tp_mlp([m.shared for m in moes], xs))]
    return ys, routes[0].lb_loss
