"""Hopper kernels: the decode read on page pools cut along head_dim.

Where tp does not divide a model's kv heads, the JAX rules put each
shard's page pools on a slice of head_dim (``sharding._paged_pool_spec``),
and the paged decode read is split over that slice
(``src/repro/kernels/paged_attention.py``'s ``paged_decode_attention_pallas``
under GSPMD). Its softmax needs whole dot products, so the port reads such
pools in two kernels around an all-reduce of the scores
(``csrc/paged_partial.cu``, whose note gives the design):
``paged_decode_scores_cuda`` gives a shard's partial scores, one block a
(page, kv head, slot); ``paged_decode_apply_cuda`` the softmax of their sum
times its slice of the values, as a split pass (one block a page, partial
softmax statistics to an fp32 workspace) and a combine pass that folds the
pages' partials in schedule order. The plain PyTorch versions are
``ref.paged_decode_scores_gather`` and ``ref.paged_decode_apply_gather``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, dtype_code

__all__ = ["SCORES_KERNEL", "APPLY_KERNEL", "paged_decode_scores_cuda", "paged_decode_apply_cuda"]

SCORES_KERNEL = CudaKernel(
    "paged_partial.cu",
    "paged_decode_scores_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_int],
)
APPLY_KERNEL = CudaKernel(
    "paged_partial.cu",
    "paged_decode_apply_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int],
)

_MAX_G = 8
_MAX_D = 128
_KEYS = 128  # keys of one split block: a page, or a chunk of a longer one (kKeys)


def _check_schedule(name: str, dev, b: int, phys, logical, keep, pos) -> int:
    if any(t.device != dev for t in (phys, logical, keep, pos)):
        raise ValueError(f"{name} needs every input on one CUDA device")
    w = phys.shape[1] if phys.ndim == 2 else -1
    for label, t in (("phys", phys), ("logical", logical), ("keep", keep)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b, w) or not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous int32 of shape (B, w)")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,) or not pos.is_contiguous():
        raise ValueError("pos must be contiguous int32 of shape (B,)")
    return w


def _check_pool(name: str, pool: torch.Tensor, hk: int, d: int) -> tuple[int, int, int]:
    if pool.ndim != 4 or tuple(pool.shape[2:]) != (hk, d):
        raise ValueError(f"{name}: the pool must be (n_pages, page, {hk}, {d}), not {tuple(pool.shape)}")
    s_page, s_row, s_head, s_d = pool.stride()
    if s_d != 1:
        raise ValueError(f"{name}: the pool's last axis must be contiguous")
    return s_page, s_row, s_head


def paged_decode_scores_cuda(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    phys: torch.Tensor,
    logical: torch.Tensor,
    keep: torch.Tensor,
    pos: torch.Tensor,
) -> torch.Tensor:
    """q (B, Hk, G, Dc) contiguous, a shard's slice of each query's head
    dim; k_pages (n_pages, page, Hk, Dc) with a contiguous last axis, of
    q's dtype; phys/logical/keep (B, w) and pos (B,) int32 contiguous; all
    on one CUDA device. G <= 8, Dc <= 128. Returns the fp32 partial scores
    (B, Hk, G, w * page), 0 where a key is not visible."""
    dev = q.device
    if not q.is_cuda or k_pages.device != dev:
        raise ValueError("paged_decode_scores_cuda needs every input on one CUDA device")
    if q.ndim != 4 or not q.is_contiguous():
        raise ValueError("q must be contiguous (B, Hk, G, Dc)")
    b, hk, g, d = q.shape
    if not (1 <= g <= _MAX_G and 1 <= d <= _MAX_D):
        raise ValueError(f"takes 1 <= G <= {_MAX_G} and 1 <= Dc <= {_MAX_D}")
    if k_pages.dtype != q.dtype:
        raise TypeError("the pool must have q's dtype")
    strides = _check_pool("paged_decode_scores_cuda", k_pages, hk, d)
    w = _check_schedule("paged_decode_scores_cuda", dev, b, phys, logical, keep, pos)
    page = k_pages.shape[1]
    out = torch.empty((b, hk, g, w * page), dtype=torch.float32, device=dev)
    if b == 0 or w == 0:
        return out.zero_()
    SCORES_KERNEL.launch(
        dev,
        q.data_ptr(), k_pages.data_ptr(), phys.data_ptr(), logical.data_ptr(), keep.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, hk, g, d, page, w, *strides, dtype_code(q.dtype),
    )
    return out


def paged_decode_apply_cuda(
    scores: torch.Tensor,
    v_pages: torch.Tensor,
    phys: torch.Tensor,
    logical: torch.Tensor,
    keep: torch.Tensor,
    pos: torch.Tensor,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """scores (B, Hk, G, w * page) fp32 contiguous, the shards' summed
    partial scores; v_pages (n_pages, page, Hk, Dc) with a contiguous last
    axis; the schedule as ``paged_decode_scores_cuda``'s. Returns (B, Hk,
    G, Dc) in the pool's dtype: the masked softmax of ``sm_scale`` times
    the scores, P rounded to that dtype, times the shard's value slice."""
    dev = scores.device
    if not scores.is_cuda or v_pages.device != dev:
        raise ValueError("paged_decode_apply_cuda needs every input on one CUDA device")
    if scores.ndim != 4 or scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("scores must be contiguous fp32 (B, Hk, G, w * page)")
    b, hk, g, n = scores.shape
    d = v_pages.shape[-1]
    if not (1 <= g <= _MAX_G and 1 <= d <= _MAX_D):
        raise ValueError(f"takes 1 <= G <= {_MAX_G} and 1 <= Dc <= {_MAX_D}")
    strides = _check_pool("paged_decode_apply_cuda", v_pages, hk, d)
    w = _check_schedule("paged_decode_apply_cuda", dev, b, phys, logical, keep, pos)
    page = v_pages.shape[1]
    if n != w * page:
        raise ValueError(f"scores hold {n} keys a row, the schedule {w} pages of {page}")
    out = torch.empty((b, hk, g, d), dtype=v_pages.dtype, device=dev)
    if b == 0 or w == 0:
        return out.zero_()
    # the split pass's partials: acc (G, Dc), m and l for every chunk of every page
    ws = torch.empty((b, hk, w * -(-page // _KEYS), g, d + 2), dtype=torch.float32, device=dev)
    APPLY_KERNEL.launch(
        dev,
        scores.data_ptr(), v_pages.data_ptr(), phys.data_ptr(), logical.data_ptr(), keep.data_ptr(),
        pos.data_ptr(), out.data_ptr(), ws.data_ptr(), b, hk, g, d, page, w, *strides, float(sm_scale),
        dtype_code(v_pages.dtype),
    )
    return out
