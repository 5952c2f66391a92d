"""Autograd for the port's two training kernels.

``BsrMatmul`` and ``BlockSparseAttention`` are ``torch.autograd.Function``s
whose forward is the kernel entry point of ``ops`` (the CUDA kernel on the
card, its plain version on the CPU), so the CPU tests run the very backward
that the card runs.

* ``BsrMatmul`` is the JAX package's ``ref.bsr_matmul_custom_vjp``. The
  transpose of a flat butterfly is a BSR matrix of the same kind, so
  ``dX = dY @ Wᵀ`` is one more ``ops.bsr_matmul``, on the transposed
  tables of ``butterfly.transpose_tables`` and a transposed copy of the
  blocks (padding slots point at block 0 and carry zero blocks). ``dBlocks``
  (``bsr_dblocks``) is the per-slot contraction over the tokens, a batched
  matmul in the model dtype that accumulates in fp32: the JAX package
  computes it in jnp, outside any Pallas kernel.
* ``BlockSparseAttention``: the forward is the block-sparse attention
  kernel; the backward is the JAX package's own gradient, autodiff of the
  gathered sparse attention (``ref.sparse_attention``), recomputed from
  the saved q, k, v. Neither package has an attention backward kernel.

Each backward piece runs inside a ``torch.profiler.record_function`` range
(``bsr_matmul_dx``, ``bsr_matmul_dblocks``, ``sparse_attention_vjp``), so a
profile reads its device time by name.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.analysis.roofline import uncounted
from repro_torch.core.butterfly import transpose_tables
from repro_torch.kernels import ops, ref

__all__ = [
    "BsrTables",
    "bsr_tables",
    "transposed_blocks",
    "bsr_dblocks",
    "BsrMatmul",
    "bsr_matmul",
    "sparse_attention_vjp",
    "BlockSparseAttention",
    "block_sparse_attention",
]


@dataclasses.dataclass(frozen=True)
class BsrTables:
    """One BSR pattern's tables on one device.

    ``cols`` (nb_out, r) int32 drives the forward; ``cols_t`` (nb_in, w)
    int32 is the transposed pattern's column table (``src_i``), ``take``
    (nb_in * w,) int64 the flat slot ``src_i * r + src_t`` whose block
    lands in each transposed slot, and ``valid`` (nb_in, w, 1, 1) bool
    marks the slots that are not padding."""

    cols: torch.Tensor
    cols_t: torch.Tensor
    take: torch.Tensor
    valid: torch.Tensor


def bsr_tables(cols: np.ndarray, nb_in: int, device: str | torch.device) -> BsrTables:
    """The tables of the static pattern ``cols`` on ``device``, built once
    per pattern and device (cached, as the JAX package caches its custom
    VJP per table)."""
    cols = np.ascontiguousarray(cols, np.int32)
    return _tables(cols.tobytes(), cols.shape, nb_in, str(torch.device(device)))


@functools.lru_cache(maxsize=512)
@uncounted
def _tables(cols_bytes: bytes, shape: tuple[int, int], nb_in: int, device: str) -> BsrTables:
    cols = np.frombuffer(cols_bytes, np.int32).reshape(shape)
    src_i, src_t, valid = transpose_tables(cols, nb_in)
    nb_in_, w = src_i.shape
    take = src_i.astype(np.int64) * shape[1] + src_t
    return BsrTables(
        cols=torch.as_tensor(cols.copy(), device=device),
        cols_t=torch.as_tensor(src_i, device=device),
        take=torch.as_tensor(take.reshape(-1), device=device),
        valid=torch.as_tensor(valid > 0, device=device).reshape(nb_in_, w, 1, 1),
    )


def transposed_blocks(blocks: torch.Tensor, tables: BsrTables) -> torch.Tensor:
    """``blocks_t[j, u] = valid[j, u] · blocks[src_i[j, u], src_t[j, u]]ᵀ``,
    (nb_in, w, b, b) contiguous in blocks' dtype: the blocks of Wᵀ in the
    layout ``ops.bsr_matmul`` takes."""
    nb_out, r, b, _ = blocks.shape
    nb_in, w = tables.cols_t.shape
    picked = blocks.reshape(nb_out * r, b, b)[tables.take].reshape(nb_in, w, b, b)
    zero = torch.zeros((), dtype=blocks.dtype, device=blocks.device)
    return torch.where(tables.valid, picked.transpose(-1, -2), zero).contiguous()


def bsr_dblocks(x: torch.Tensor, dy: torch.Tensor, tables: BsrTables, block: int) -> torch.Tensor:
    """The blocks' gradient, as ``ref.py``'s custom VJP computes it: for
    each slot t, the sum over the tokens of ``x_b[:, cols[i, t]]ᵀ dy_b[:, i]``,
    a gather and a batched matmul (nb_out, b, M) @ (nb_out, M, b) in x's
    dtype with fp32 accumulation. x (..., n_in), dy (..., n_out) ->
    (nb_out, r, b, b) in x's dtype."""
    nb_out, r = tables.cols.shape
    xb = x.reshape(-1, x.shape[-1] // block, block)
    dyb = dy.reshape(-1, nb_out, block).transpose(0, 1)  # (nb_out, M, b)
    cols = tables.cols.long()
    return torch.stack(
        [torch.matmul(xb[:, cols[:, t]].permute(1, 2, 0), dyb) for t in range(r)], dim=1
    )


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor whose data is 16-byte aligned, as the kernels
    read it (a cotangent is often a strided or offset view)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class BsrMatmul(torch.autograd.Function):
    """``y = x @ W`` for a flat-block-butterfly BSR weight, with the
    transposed-gather backward of ``ref.bsr_matmul_custom_vjp``."""

    @staticmethod
    def forward(ctx, x, blocks, tables):
        ctx.save_for_backward(x, blocks)
        ctx.tables = tables
        return ops.bsr_matmul(x, blocks, tables.cols)

    @staticmethod
    def backward(ctx, dy):
        x, blocks = ctx.saved_tensors
        tables = ctx.tables
        dy = _kernel_ready(dy.to(x.dtype))
        dx = dblocks = None
        if ctx.needs_input_grad[0]:
            with record_function("bsr_matmul_dx"):
                dx = ops.bsr_matmul(dy, transposed_blocks(blocks, tables), tables.cols_t)
        if ctx.needs_input_grad[1]:
            with record_function("bsr_matmul_dblocks"):
                dblocks = bsr_dblocks(x, dy, tables, blocks.shape[-1]).to(blocks.dtype)
        return dx, dblocks, None


def bsr_matmul(x: torch.Tensor, blocks: torch.Tensor, tables: BsrTables) -> torch.Tensor:
    """``y = x @ W`` through ``BsrMatmul``: x (..., n_in) -> (..., n_out)."""
    return BsrMatmul.apply(x, blocks, tables)


def sparse_attention_vjp(q, k, v, kv_index, valid, do, *, block, causal, sm_scale):
    """The JAX package's attention gradient: autodiff of the gathered
    sparse attention ``ref.sparse_attention``, recomputed from q, k, v
    (grouped layout) and contracted with the output cotangent ``do``.
    Returns (dq, dk, dv)."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        o = ref.sparse_attention(
            qd, kd, vd, kv_index, valid, block=block, causal=causal, sm_scale=sm_scale
        )
        return torch.autograd.grad(o, (qd, kd, vd), do)


class BlockSparseAttention(torch.autograd.Function):
    """Causal pixelfly block-sparse attention: the kernel forward, the
    JAX package's gradient (``sparse_attention_vjp``) backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_index, valid, block, causal, sm_scale):
        ctx.save_for_backward(q, k, v, kv_index, valid)
        ctx.kw = dict(block=block, causal=causal, sm_scale=sm_scale)
        return ops.block_sparse_attention(q, k, v, kv_index, valid, **ctx.kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_index, valid = ctx.saved_tensors
        with record_function("sparse_attention_vjp"):
            dq, dk, dv = sparse_attention_vjp(q, k, v, kv_index, valid, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def block_sparse_attention(q, k, v, kv_index, valid, *, block, causal, sm_scale):
    """``ops.block_sparse_attention`` through ``BlockSparseAttention``:
    q (B, S, Hk, G, D), k, v (B, S, Hk, D) -> (B, S, Hk, G, D)."""
    return BlockSparseAttention.apply(q, k, v, kv_index, valid, block, causal, sm_scale)
