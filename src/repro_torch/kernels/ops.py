"""The kernels' entry points for model code, dispatched by device.

A tensor on the CPU takes the plain PyTorch version (``ref``); a tensor on
a CUDA device launches the hand-written kernel, which raises on what it
does not take. There is no fallback from one to the other, and any other
device raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bsr_attention import block_sparse_attention_cuda
from repro_torch.kernels.bsr_matmul import bsr_matmul_cuda
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda

__all__ = ["bsr_matmul", "paged_decode_attention", "block_sparse_attention"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {t.device}")


def bsr_matmul(
    x: torch.Tensor, blocks: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """y = x @ W for a flat-block-butterfly BSR weight: x (..., n_in) ->
    (..., nb_out * b) in x's dtype, summed in fp32."""
    if not _on_cuda(x):
        return ref.bsr_matmul_gather(x, blocks, cols)
    *lead, n_in = x.shape
    y = bsr_matmul_cuda(x.reshape(-1, n_in), blocks, cols)
    return y.reshape(*lead, y.shape[-1])


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
    fn = (
        paged_decode_attention_cuda
        if _on_cuda(q)
        else ref.paged_decode_attention_gather
    )
    return fn(q, k_pages, v_pages, phys, logical, keep, pos, sm_scale=sm_scale)


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
) -> torch.Tensor:
    """Block-sparse attention in the grouped layout: q (B, S, Hk, G, D),
    k, v (B, S, Hk, D), schedule (S // block, w). Returns (B, S, Hk, G, D).
    The kernel reads kv head h // G for query head h; nothing is repeated."""
    if not _on_cuda(q):
        return ref.sparse_attention(
            q, k, v, kv_index, valid, block=block, causal=causal, sm_scale=sm_scale
        )
    b, s, hk, g, d = q.shape
    o = block_sparse_attention_cuda(
        q.reshape(b, s, hk * g, d), k, v, kv_index, valid,
        block=block, causal=causal, sm_scale=sm_scale,
    )
    return o.reshape(b, s, hk, g, d)
