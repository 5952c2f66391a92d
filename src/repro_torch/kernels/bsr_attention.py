"""Hopper kernel: causal block-sparse flash attention over a static
schedule (the pixelfly prefill attention).

The port of ``block_sparse_attention_pallas``
(``src/repro/kernels/bsr_attention.py``); the CUDA source and its design
note are in ``csrc/bsr_attention.cu``. The plain PyTorch version of the
same function is ``ref.sparse_attention``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_aligned, dtype_code

__all__ = ["KERNEL", "HEAD_DIMS", "block_sparse_attention_cuda"]

# the head dims the kernel is instantiated at (csrc/bsr_attention.cu)
HEAD_DIMS = (64, 80, 128)

KERNEL = CudaKernel(
    "bsr_attention.cu",
    "block_sparse_attention_launch",
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int],
)


def block_sparse_attention_cuda(
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
    """q (B, Sq, H, D); k, v (B, Sk, Hk, D), H a multiple of Hk (query head
    h reads kv head h // (H // Hk)); kv_index/valid (Sk // block, nkv)
    int32, the schedule of the whole sequence. q holds the query blocks
    ``q_block0 .. q_block0 + Sq // block`` (all of them by default; a
    query slice in the sequence-parallel mode): they read those schedule
    rows and are masked causally at their absolute positions. All
    contiguous on one CUDA device, q/k/v of one dtype; D is one of
    ``HEAD_DIMS`` (64, 80, 128) and block a multiple of 32 dividing Sq and
    Sk. bfloat16 runs on the tensor cores and also needs block a multiple
    of 64 and q, k, v 16-byte aligned; it takes every H // Hk (a thread
    block holds 4, 2 or 1 heads of a group, the largest that divides it).
    Returns (B, Sq, H, D)."""
    dev = q.device
    if not q.is_cuda or any(t.device != dev for t in (k, v, kv_index, valid)):
        raise ValueError("block_sparse_attention_cuda needs every input on one CUDA device")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, Sq, H, D) and k, v (B, Sk, Hk, D)")
    b, s, h, d = q.shape
    bk, sk, hk, dk = k.shape
    if (bk, dk) != (b, d) or h % hk:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"block_sparse_attention_cuda takes head dims {', '.join(map(str, HEAD_DIMS))}, not {d}"
        )
    if block % 32 or s % block or sk % block:
        raise ValueError(f"block {block} must be a multiple of 32 dividing Sq={s} and Sk={sk}")
    nqb, nkb = s // block, sk // block
    if q_block0 < 0 or q_block0 + nqb > nkb:
        raise ValueError(f"query blocks {q_block0}..{q_block0 + nqb} lie outside the {nkb} blocks of k")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share a dtype")
    for name, t in (("kv_index", kv_index), ("valid", valid)):
        if t.dtype != torch.int32 or t.ndim != 2 or t.shape[0] != nkb:
            raise ValueError(f"{name} must be int32 of shape (Sk // block, nkv)")
    if kv_index.shape != valid.shape:
        raise ValueError("kv_index and valid must share a shape")
    if not all(t.is_contiguous() for t in (q, k, v, kv_index, valid)):
        raise ValueError("block_sparse_attention_cuda needs contiguous inputs")
    if q.dtype == torch.bfloat16:
        if block % 64:
            raise ValueError(
                f"the bfloat16 kernel takes a block that is a multiple of 64, not {block}"
            )
        check_aligned("block_sparse_attention_cuda", q=q, k=k, v=v)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    KERNEL.launch(
        dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_index.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, s, sk, q_block0 * block, h, hk, d, kv_index.shape[1], block, int(causal),
        float(sm_scale), dtype_code(q.dtype),
    )
    return out
