"""Hopper kernel: paged decode attention over the K/V page pools.

The port of ``paged_decode_attention_pallas``
(``src/repro/kernels/paged_attention.py``); the CUDA source and its design
note are in ``csrc/paged_attention.cu``. The plain PyTorch version of the
same function is ``ref.paged_decode_attention_gather``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, dtype_code

__all__ = ["KERNEL", "paged_decode_attention_cuda"]

KERNEL = CudaKernel(
    "paged_attention.cu",
    "paged_decode_attention_launch",
    [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 3
    + [ctypes.c_float, ctypes.c_int],
)

_MAX_G = 8
_CHUNK = 32  # keys staged in shared memory at a time (csrc kChunk)
_SMEM_LIMIT = 48 * 1024


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
    if g > _MAX_G or d > 256:
        raise ValueError(f"takes G <= {_MAX_G} and D <= 256")
    # dynamic (q rows, staged K/V chunk, probabilities) + static (3 x 8 stats)
    smem = 4 * (g * d + _CHUNK * (2 * d + 1) + g * _CHUNK + 3 * _MAX_G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G={g}, D={d} needs {smem} bytes of shared memory, over 48 KB")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("the pools must have q's dtype")
    if k_pages.stride() != v_pages.stride() or k_pages.stride(-1) != 1:
        raise ValueError("the pools must share strides with a contiguous last axis")
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
    s_page, s_row, s_head, _ = k_pages.stride()
    KERNEL.launch(
        dev,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        phys.data_ptr(), logical.data_ptr(), keep.data_ptr(), pos.data_ptr(),
        out.data_ptr(),
        b, hk, g, d, page, w,
        s_page, s_row, s_head,
        float(sm_scale), dtype_code(q.dtype),
    )
    return out
