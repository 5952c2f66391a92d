"""Hopper kernel: flat-block-butterfly (BSR) sparse matmul.

The port of ``bsr_matmul_pallas`` (``src/repro/kernels/bsr_matmul.py``);
the CUDA source and its design note are in ``csrc/bsr_matmul.cu``. The
plain PyTorch version of the same function is ``ref.bsr_matmul_gather``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_aligned, dtype_code

__all__ = ["KERNEL", "bsr_matmul_cuda"]

KERNEL = CudaKernel(
    "bsr_matmul.cu",
    "bsr_matmul_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6,
)


def bsr_matmul_cuda(
    x: torch.Tensor, blocks: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """``y[:, i*b:(i+1)*b] = sum_t x[:, cols[i,t]*b : +b] @ blocks[i, t]``.

    x (M, n_in) and blocks (nb_out, r, b, b) of one dtype (float32 or
    bfloat16), cols (nb_out, r) int32, all contiguous on one CUDA device;
    b must be 64 or 128. bfloat16 x and blocks are read in 16-byte chunks
    and must be 16-byte aligned. Returns y (M, nb_out * b) in x's dtype.
    """
    if not (x.is_cuda and blocks.device == x.device and cols.device == x.device):
        raise ValueError("bsr_matmul_cuda needs x, blocks, cols on one CUDA device")
    if x.ndim != 2 or blocks.ndim != 4:
        raise ValueError("x must be (M, n_in) and blocks (nb_out, r, b, b)")
    nb_out, r, b, b2 = blocks.shape
    if b != b2:
        raise ValueError("blocks must be square")
    if b not in (64, 128):
        raise ValueError(
            f"bsr_matmul_cuda takes block sizes 64 and 128, not {b} (a layer "
            "whose features forced a smaller block has no kernel yet)"
        )
    m, n_in = x.shape
    if n_in % b:
        raise ValueError(f"n_in {n_in} is not a multiple of the block {b}")
    if blocks.dtype != x.dtype:
        raise TypeError(f"blocks dtype {blocks.dtype} != x dtype {x.dtype}")
    if cols.dtype != torch.int32 or tuple(cols.shape) != (nb_out, r):
        raise ValueError(f"cols must be int32 of shape {(nb_out, r)}")
    if not (x.is_contiguous() and blocks.is_contiguous() and cols.is_contiguous()):
        raise ValueError("bsr_matmul_cuda needs contiguous inputs")
    if x.dtype == torch.bfloat16:
        check_aligned("bsr_matmul_cuda", x=x, blocks=blocks)
    y = torch.empty((m, nb_out * b), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    KERNEL.launch(
        x.device,
        x.data_ptr(), blocks.data_ptr(), cols.data_ptr(), y.data_ptr(),
        m, n_in, nb_out, r, b, dtype_code(x.dtype),
    )
    return y
