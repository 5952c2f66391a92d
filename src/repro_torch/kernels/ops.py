"""The kernels' entry points for model code, dispatched by device.

A tensor on the CPU takes the plain PyTorch version (``ref``); a tensor on
a CUDA device launches the hand-written kernel, which raises on what it
does not take. There is no fallback from one to the other. A tensor on the
meta device computes nothing: the entry point returns an empty result of
the kernel's shape and dtype, and only its cost counts. Meta is the
dry-run's shape-only counting device (``launch.dryrun``), not a fallback.
Any other device raises.

Each entry point reports its own FLOPs and bytes to ``analysis.roofline``
while a step is counted (``@metered``); the ``*_cost`` functions are those
formulas, also the bound column of ``chip_smoke.py``: each input read
once, each output written once, and the work this call's data needs.
The block-sparse attention's schedule is a static pattern: its cost reads
the host ``BlockSchedule`` the tensors were built from
(``register_schedule``, called by ``models.layers``), so the CPU, the card
and meta count the same pairs. The paged read's keys depend on the
positions and the page table, which meta does not hold: there every slot
of the schedule counts as a kept, full page (the most the step can read).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch.analysis import guards
from repro_torch.analysis.roofline import metered
from repro_torch.kernels import ref
from repro_torch.kernels.bsr_attention import block_sparse_attention_cuda
from repro_torch.kernels.bsr_matmul import bsr_matmul_cuda
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.kernels.paged_partial import paged_decode_apply_cuda, paged_decode_scores_cuda

__all__ = [
    "bsr_matmul", "paged_decode_attention", "paged_decode_scores", "paged_decode_apply", "block_sparse_attention",
    "bsr_matmul_cost", "paged_decode_attention_cost", "paged_decode_scores_cost", "paged_decode_apply_cost",
    "block_sparse_attention_cost", "register_schedule",
]


def _route(t: torch.Tensor) -> str:
    """"cpu" (the plain version), "cuda" (the kernel) or "meta" (shapes
    only); any other device raises."""
    if t.device.type in ("cpu", "cuda", "meta"):
        return t.device.type
    raise ValueError(f"no kernel for device {t.device}")


# id(kv_index) -> the host (kv_index, valid) arrays it was built from
_SCHEDULES: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def register_schedule(kv_index: torch.Tensor, kv_host: np.ndarray, valid_host: np.ndarray) -> None:
    """Record that ``kv_index`` holds the host schedule ``(kv_host,
    valid_host)``, for ``block_sparse_attention_cost`` (forgotten when the
    tensor dies)."""
    key = id(kv_index)
    _SCHEDULES[key] = (np.asarray(kv_host), np.asarray(valid_host))
    weakref.finalize(kv_index, _SCHEDULES.pop, key, None)


def bsr_matmul_cost(x, blocks, cols, slots: int | None = None) -> tuple[float, float]:
    """(FLOPs, bytes) of ``bsr_matmul``: 2 M b^2 a b x b product of the
    pattern (``slots`` of them a row block, nb_out x r by default; a
    transposed table's padding is not work), and x, blocks, cols and y
    once each."""
    nb_out, r, b, _ = blocks.shape
    m = x.numel() // x.shape[-1]
    slots = nb_out * r if slots is None else slots
    nbytes = (x.numel() + blocks.numel() + m * nb_out * b) * x.element_size() + cols.numel() * 4
    return 2.0 * m * slots * b * b, float(nbytes)


def _visible_keys(logical, keep, pos, page) -> int:
    """The keys a paged read sees: the kept pages' positions up to each
    slot's own (read through one ``guards.device_get``); on meta, every
    slot of the schedule as a kept, full page."""
    if logical.is_meta:
        return logical.numel() * page
    base = logical.long() * page
    vis = ((pos.long()[:, None] - base + 1).clamp(0, page) * keep.long()).sum()
    return int(guards.device_get(vis))


def paged_decode_attention_cost(q, k_pages, v_pages, phys, logical, keep, pos, *, sm_scale) -> tuple[float, float]:
    """(FLOPs, bytes) of ``paged_decode_attention``: the keys each slot
    sees (``_visible_keys``), 4 G D FLOPs a key and kv head, their K and V
    rows, q and the output, and the schedule."""
    b, hk, g, d = q.shape
    n_vis = _visible_keys(logical, keep, pos, k_pages.shape[1])
    nbytes = (2 * q.numel() + 2 * n_vis * hk * d) * q.element_size() + 4 * (3 * phys.numel() + b)
    return 4.0 * g * d * n_vis * hk, float(nbytes)


def paged_decode_scores_cost(q, k_pages, phys, logical, keep, pos) -> tuple[float, float]:
    """(FLOPs, bytes) of ``paged_decode_scores``: 2 G Dc FLOPs a visible
    key and kv head, q and the visible keys' K rows read once, the fp32
    scores of every scheduled key written once (the output holds them
    all, 0 where a key is not visible), and the schedule."""
    b, hk, g, d = q.shape
    page = k_pages.shape[1]
    n_vis = _visible_keys(logical, keep, pos, page)
    nbytes = (q.numel() + n_vis * hk * d) * q.element_size() + 4 * (hk * g * phys.numel() * page
                                                                     + 3 * phys.numel() + b)
    return 2.0 * g * d * n_vis * hk, float(nbytes)


def paged_decode_apply_cost(scores, v_pages, phys, logical, keep, pos, *, sm_scale) -> tuple[float, float]:
    """(FLOPs, bytes) of ``paged_decode_apply``: 2 G Dc FLOPs a visible key
    and kv head (P @ V), the visible keys' fp32 scores and V rows read
    once (the rest of the scores is never read), the output written once,
    and the schedule."""
    b, hk, g, _ = scores.shape
    d = v_pages.shape[-1]
    n_vis = _visible_keys(logical, keep, pos, v_pages.shape[1])
    es = v_pages.element_size()
    nbytes = 4 * n_vis * hk * g + (n_vis * hk * d + b * hk * g * d) * es + 4 * (3 * phys.numel() + b)
    return 2.0 * g * d * n_vis * hk, float(nbytes)


def block_sparse_attention_cost(q, k, v, kv_index, valid, *, block, causal, sm_scale,
                                q_block0: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) of ``block_sparse_attention``: 4 D FLOPs a visible
    (query, key) pair of the schedule rows of q's query blocks and query
    head (a diagonal block holds block (block + 1) / 2 pairs when causal),
    q, k, v and the output once each, and those schedule rows (the host
    arrays it was registered with; else read back from the device)."""
    b, s, hk, g, d = q.shape
    host = _SCHEDULES.get(id(kv_index))
    if host is None and kv_index.is_meta:
        raise ValueError("block_sparse_attention on meta needs a schedule from ops.register_schedule")
    kv, ok = host if host is not None else guards.device_get((kv_index, valid))
    nqb = s // block
    kv, ok = kv[q_block0 : q_block0 + nqb], ok[q_block0 : q_block0 + nqb]
    rows = q_block0 + np.arange(kv.shape[0])[:, None]
    diag = (kv == rows) & bool(causal)
    pairs = int(np.where(ok > 0, np.where(diag, block * (block + 1) // 2, block * block), 0).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 8 * kv.size
    return 4.0 * d * pairs * b * hk * g, float(nbytes)


@metered(bsr_matmul_cost)
def bsr_matmul(
    x: torch.Tensor, blocks: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """y = x @ W for a flat-block-butterfly BSR weight: x (..., n_in) ->
    (..., nb_out * b) in x's dtype, summed in fp32."""
    route = _route(x)
    if route == "meta":
        return x.new_empty((*x.shape[:-1], blocks.shape[0] * blocks.shape[-1]))
    if route == "cpu":
        return ref.bsr_matmul_gather(x, blocks, cols)
    *lead, n_in = x.shape
    y = bsr_matmul_cuda(x.reshape(-1, n_in), blocks, cols)
    return y.reshape(*lead, y.shape[-1])


@metered(paged_decode_attention_cost)
def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    phys: torch.Tensor,
    logical: torch.Tensor,
    keep: torch.Tensor,
    pos: torch.Tensor,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """One decode query per slot, q (B, Hk, G, D), against the page pools
    (n_pages, page, Hk, D) through the (B, w) schedule phys/logical/keep."""
    route = _route(q)
    if route == "meta":
        return torch.empty_like(q)
    fn = paged_decode_attention_cuda if route == "cuda" else ref.paged_decode_attention_gather
    return fn(q, k_pages, v_pages, phys, logical, keep, pos, sm_scale=sm_scale)


@metered(paged_decode_scores_cost)
def paged_decode_scores(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    phys: torch.Tensor,
    logical: torch.Tensor,
    keep: torch.Tensor,
    pos: torch.Tensor,
) -> torch.Tensor:
    """One shard's partial scores of the decode read on pools cut along
    head_dim: q (B, Hk, G, Dc) against its key pool (n_pages, page, Hk,
    Dc) through the (B, w) schedule. Returns (B, Hk, G, w * page) fp32,
    0 where a key is not visible."""
    route = _route(q)
    if route == "meta":
        return q.new_empty((*q.shape[:3], phys.shape[1] * k_pages.shape[1]), dtype=torch.float32)
    fn = paged_decode_scores_cuda if route == "cuda" else ref.paged_decode_scores_gather
    return fn(q, k_pages, phys, logical, keep, pos)


@metered(paged_decode_apply_cost)
def paged_decode_apply(
    scores: torch.Tensor,
    v_pages: torch.Tensor,
    phys: torch.Tensor,
    logical: torch.Tensor,
    keep: torch.Tensor,
    pos: torch.Tensor,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """The masked softmax of the summed scores (B, Hk, G, w * page), then
    P @ V over one shard's value pool (n_pages, page, Hk, Dc). Returns
    (B, Hk, G, Dc) in the pool's dtype."""
    route = _route(scores)
    if route == "meta":
        return scores.new_empty((*scores.shape[:3], v_pages.shape[-1]), dtype=v_pages.dtype)
    fn = paged_decode_apply_cuda if route == "cuda" else ref.paged_decode_apply_gather
    return fn(scores, v_pages, phys, logical, keep, pos, sm_scale=sm_scale)


@metered(block_sparse_attention_cost)
def block_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_index: torch.Tensor,
    valid: torch.Tensor,
    *,
    block: int,
    causal: bool,
    sm_scale: float,
    q_block0: int = 0,
) -> torch.Tensor:
    """Block-sparse attention in the grouped layout: q (B, Sq, Hk, G, D),
    k, v (B, Sk, Hk, D), schedule (Sk // block, w); q holds the query
    blocks ``q_block0 .. q_block0 + Sq // block`` (the whole sequence by
    default). Returns (B, Sq, Hk, G, D). The kernel reads kv head h // G
    for query head h; nothing is repeated."""
    route = _route(q)
    if route == "meta":
        return torch.empty_like(q)
    if route == "cpu":
        return ref.sparse_attention(
            q, k, v, kv_index, valid, block=block, causal=causal, sm_scale=sm_scale, q_block0=q_block0
        )
    b, s, hk, g, d = q.shape
    o = block_sparse_attention_cuda(
        q.reshape(b, s, hk * g, d), k, v, kv_index, valid,
        block=block, causal=causal, sm_scale=sm_scale, q_block0=q_block0,
    )
    return o.reshape(b, s, hk, g, d)
