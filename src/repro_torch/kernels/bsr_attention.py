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

__all__ = ["KERNEL", "block_sparse_attention_cuda"]

KERNEL = CudaKernel(
    "bsr_attention.cu",
    "block_sparse_attention_launch",
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 8
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
) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, S, Hk, D), H a multiple of Hk (query head
    h reads kv head h // (H // Hk)); kv_index/valid (S // block, nkv)
    int32. All contiguous on one CUDA device, q/k/v of one dtype; D is 64
    or 128 and block a multiple of 32 dividing S. bfloat16 runs on the
    tensor cores and also needs block a multiple of 64, H // Hk in
    {1, 2, 4} and q, k, v 16-byte aligned. Returns (B, S, H, D)."""
    dev = q.device
    if not q.is_cuda or any(t.device != dev for t in (k, v, kv_index, valid)):
        raise ValueError("block_sparse_attention_cuda needs every input on one CUDA device")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, S, H, D) and k, v (B, S, Hk, D)")
    b, s, h, d = q.shape
    bk, sk, hk, dk = k.shape
    if (bk, sk, dk) != (b, s, d) or h % hk:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"block_sparse_attention_cuda takes head dims 64 and 128, not {d}")
    if block % 32 or s % block:
        raise ValueError(f"block {block} must be a multiple of 32 dividing S={s}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share a dtype")
    nqb = s // block
    for name, t in (("kv_index", kv_index), ("valid", valid)):
        if t.dtype != torch.int32 or t.ndim != 2 or t.shape[0] != nqb:
            raise ValueError(f"{name} must be int32 of shape (S // block, nkv)")
    if kv_index.shape != valid.shape:
        raise ValueError("kv_index and valid must share a shape")
    if not all(t.is_contiguous() for t in (q, k, v, kv_index, valid)):
        raise ValueError("block_sparse_attention_cuda needs contiguous inputs")
    if q.dtype == torch.bfloat16:
        if block % 64 or h // hk not in (1, 2, 4):
            raise ValueError(
                f"the bfloat16 kernel takes a block that is a multiple of 64 and "
                f"H // Hk in (1, 2, 4), not block {block} and H // Hk {h // hk}"
            )
        check_aligned("block_sparse_attention_cuda", q=q, k=k, v=v)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    KERNEL.launch(
        dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_index.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, s, h, hk, d, kv_index.shape[1], block, int(causal),
        float(sm_scale), dtype_code(q.dtype),
    )
    return out
