"""Hopper kernel: paged decode attention over the K/V page pools.

The port of ``paged_decode_attention_pallas``
(``src/repro/kernels/paged_attention.py``); the CUDA source and its design
note are in ``csrc/paged_attention.cu``: a split pass with one block per
schedule slot writes partial softmax statistics to an fp32 workspace, and a
combine pass folds them in schedule order, both launched by one C call. The
plain PyTorch version of the same function is
``ref.paged_decode_attention_gather``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_aligned, dtype_code

__all__ = ["KERNEL", "paged_decode_attention_cuda"]

KERNEL = CudaKernel(
    "paged_attention.cu",
    "paged_decode_attention_launch",
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 3
    + [ctypes.c_float, ctypes.c_int],
)

_MAX_G = 8  # query rows per kv head: the n = 8 of the kernel's MMA
_MAX_D = 256


def paged_decode_attention_cuda(
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
    """q (B, Hk, G, D) contiguous; k_pages, v_pages (n_pages, page, Hk, D)
    with a contiguous last axis; phys/logical/keep (B, w) and pos (B,)
    int32 contiguous; all on one CUDA device, q and the pools of one dtype.
    q and the pools are read in 16-byte chunks: their data must be 16-byte
    aligned and the pools' strides whole 16-byte chunks. G <= 8, D <= 256.
    Returns (B, Hk, G, D) in q's dtype."""
    dev = q.device
    tensors = (k_pages, v_pages, phys, logical, keep, pos)
    if not q.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention_cuda needs every input on one CUDA device")
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("q must be (B, Hk, G, D) and the pools (n_pages, page, Hk, D)")
    b, hk, g, d = q.shape
    _, page, hk_p, d_p = k_pages.shape
    if (hk_p, d_p) != (hk, d):
        raise ValueError("pool head/dim mismatch with q")
    if not (1 <= g <= _MAX_G and 1 <= d <= _MAX_D):
        raise ValueError(f"takes 1 <= G <= {_MAX_G} and 1 <= D <= {_MAX_D}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("the pools must have q's dtype")
    s_page, s_row, s_head, s_d = strides = k_pages.stride()
    if v_pages.stride() != strides or s_d != 1:
        raise ValueError("the pools must share strides with a contiguous last axis")
    es = q.element_size()
    if (d * es) % 16 or (s_page * es) % 16 or (s_row * es) % 16 or (s_head * es) % 16:
        raise ValueError(
            "paged_decode_attention_cuda reads pool rows in 16-byte chunks: D and "
            f"the pool strides must be whole 16-byte chunks (D={d}, strides "
            f"{strides}, {es}-byte elements)"
        )
    w = phys.shape[1] if phys.ndim == 2 else -1
    for name, t in (("phys", phys), ("logical", logical), ("keep", keep)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b, w) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 of shape (B, w)")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,) or not pos.is_contiguous():
        raise ValueError("pos must be contiguous int32 of shape (B,)")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    out = torch.empty_like(q)
    if b == 0 or w == 0:
        return out.zero_()
    q_ptr, k_ptr, v_ptr = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    if (q_ptr | k_ptr | v_ptr) % 16:
        check_aligned("paged_decode_attention_cuda", q=q, k_pages=k_pages, v_pages=v_pages)
    # the split pass's partials: acc (G, D), m and l for every schedule slot
    ws = torch.empty((b, hk, w, g, d + 2), dtype=torch.float32, device=dev)
    KERNEL.launch(
        dev,
        q_ptr, k_ptr, v_ptr,
        phys.data_ptr(), logical.data_ptr(), keep.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(),
        b, hk, g, d, page, w,
        s_page, s_row, s_head,
        float(sm_scale), dtype_code(q.dtype),
    )
    return out
