"""Transformer building blocks of the port: norms, RoPE, GQA attention over
the paged cache, the SwiGLU MLP, embedding and logits.

The attention-family subset of the JAX package's ``models/layers.py``.
Every GEMM of a block goes through ``core.pixelfly.Linear``, so the dense
and the pixelfly-sparse model share this code. Attention math is plain
functions on tensors; the three kernels are reached through
``kernels.ops`` (prefill block-sparse attention, the BSR matmul inside the
linears, and the paged decode read); a dense model's bf16 attention on the
card is PyTorch's flash kernel, as no TPU kernel stands behind it. Every parameter is trainable:
``apply_attention(mode="train")`` is the training step's attention, and
the two training kernels run through ``kernels.autograd``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.roofline import uncounted
from repro_torch.configs.base import ModelConfig
from repro_torch.core import attn_pattern as ap
from repro_torch.core.butterfly import next_pow2
from repro_torch.core.pixelfly import Linear, LinearSpec
from repro_torch.distributed import collectives
from repro_torch.kernels import autograd, ops

__all__ = [
    "rmsnorm",
    "rope_angles",
    "apply_rope",
    "flash_attention",
    "chunked_attention",
    "prefill_schedule",
    "sparse_prefill_attention",
    "prefix_flash_attention",
    "decode_attention",
    "sparse_decode_attention",
    "paged_sparse_schedule",
    "paged_dense_schedule",
    "DecodeIndex",
    "decode_index",
    "paged_decode_attention",
    "paged_sparse_decode_attention",
    "RMSNorm",
    "Attention",
    "Mlp",
    "Embedding",
    "apply_attention",
    "attention_heads",
    "apply_mlp",
    "mlp_hidden",
    "tp_project",
    "embed_tokens",
    "embed_tokens_tp",
    "lm_logits",
]


# ----------------------------------------------------------------------
# Norms and RoPE
# ----------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS over the last axis in fp32, scaled, cast back to x's dtype. Also
    the qk-norm over the head dim of (..., heads, head_dim)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_angles(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    mrope_sections: tuple[int, ...] = (),
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) -> cos, sin (B, S, 1, head_dim // 2), fp32.

    M-RoPE (Qwen2-VL): with ``mrope_sections``, positions are (B, S, n)
    and the half-dim splits into the sections, in order; section i keeps
    the global frequencies [off, off + sec) and rotates by position stream
    i (temporal / height / width), as the JAX package's ``apply_rope``.
    Each angle is the same fp32 product of one position and one
    frequency, so n equal streams give plain RoPE's bits."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # theta ** exps rounded once to fp32, as the JAX package's frequencies
    # are (fp32 pow on the CPU is 1 ulp off for a few of them, which moves
    # an angle by 3e-5 rad at position 4096)
    theta32 = torch.tensor(theta, dtype=torch.float32).double()
    freqs = torch.pow(theta32, exps.double()).float()
    if mrope_sections:
        if positions.ndim != 3 or positions.shape[-1] != len(mrope_sections):
            raise ValueError(
                f"M-RoPE needs positions (B, S, {len(mrope_sections)}), got {tuple(positions.shape)}"
            )
        if sum(mrope_sections) != half:
            raise ValueError(f"mrope_sections {mrope_sections} do not sum to head_dim // 2 = {half}")
        offs = [sum(mrope_sections[:i]) for i in range(len(mrope_sections) + 1)]
        ang = torch.cat(
            [positions[..., i : i + 1].float() * freqs[offs[i] : offs[i + 1]] for i in range(len(mrope_sections))],
            dim=-1,
        )  # (B, S, half)
    else:
        ang = positions[..., None].float() * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Plain RoPE on x (B, S, H, D) with angles from ``rope_angles``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------
# Prefill attention
# ----------------------------------------------------------------------


def _online_softmax_scan(
    q_in: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    chunk: int,
    mask_fn,
) -> torch.Tensor:
    """The online-softmax core shared by the dense causal and the partial
    prefill attention, the JAX package's ``_online_softmax_scan``: a loop
    over KV chunks that never holds an (Sq, Sk) score tensor.

    q_in (B,Sq,Hk,G,D) fp32, the scaled q already rounded to the model
    dtype; k, v (B,Sk,Hk,D) with Sk a ``chunk`` multiple; ``mask_fn(c0)``
    gives a bool mask broadcastable to the (B,Hk,G,Sq,chunk) scores of the
    chunk starting at key c0 (False = masked out). Scores and P @ V sum in
    fp32 with P rounded to v's dtype; m, l and acc are fp32, and l == 0 ->
    1. While autograd records, each chunk is recomputed in the backward
    (the reference's ``jax.checkpoint`` of the scan body), so the saved
    tensors stay (B,Hk,G,Sq,D)-sized per chunk."""
    b, sq, hk, g, d = q_in.shape
    dev = q_in.device

    def body(m, l, acc, kb, vb, mask):
        s = torch.einsum("bqhgd,bkhd->bhgqk", q_in, kb.float()).masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        masked = torch.isneginf(m_new)
        alpha = torch.where(masked, 1.0, torch.exp(m - m_new))
        p = torch.where(masked[..., None], 0.0, torch.exp(s - m_new[..., None]))
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
        acc = acc * alpha[..., None] + pv
        return m_new, l, acc

    m = torch.full((b, hk, g, sq), float("-inf"), device=dev)
    l = torch.zeros((b, hk, g, sq), device=dev)
    acc = torch.zeros((b, hk, g, sq, d), device=dev)
    for c0 in range(0, k.shape[1], chunk):
        args = (m, l, acc, k[:, c0 : c0 + chunk], v[:, c0 : c0 + chunk], mask_fn(c0))
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(body, *args, use_reentrant=False)
        else:
            m, l, acc = body(*args)
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]  # (B, Hk, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: float,
    chunk: int,
) -> torch.Tensor:
    """Causal attention for the dense prefill and training branch: q
    (B,S,Hk,G,D), k, v (B,S,Hk,D) -> (B,S,Hk,G,D).

    bfloat16 on the card: PyTorch's flash-attention kernel
    (``scaled_dot_product_attention`` with only the flash backend
    allowed, so a shape it cannot take raises), grouped-query attention
    read in place. The JAX package computes dense attention in jnp, not
    in a Pallas kernel, so no TPU kernel stands behind this: it is the
    dense baseline's attention. Everything else (the CPU, fp32 on the
    card): ``chunked_attention``, the JAX package's algorithm."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        return _sdpa_flash(q, k, v, sm_scale=sm_scale)
    return chunked_attention(q, k, v, sm_scale=sm_scale, chunk=chunk)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: float,
    chunk: int,
) -> torch.Tensor:
    """The JAX package's ``flash_attention_jnp`` (causal): q (B,Sq,Hk,G,D),
    k, v (B,Sk,Hk,D), query i at key position i; an online softmax over
    chunks of ``min(chunk, Sk)`` keys, Sk zero-padded to a whole chunk and
    the padded keys masked, the scale folded into q in fp32 and q cast
    back to the model dtype. Holds no (Sq, Sk) tensor."""
    sq, sk = q.shape[1], k.shape[1]
    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_in = (q.float() * sm_scale).to(q.dtype).float()
    qpos = torch.arange(sq, device=q.device)

    def mask_fn(c0):
        kpos = c0 + torch.arange(chunk, device=q.device)
        return ((kpos[None, :] < sk) & (kpos[None, :] <= qpos[:, None]))[None, None, None]

    return _online_softmax_scan(q_in, k, v, chunk, mask_fn).to(q.dtype)


def _sdpa_flash(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float
) -> torch.Tensor:
    b, sq, hk, g, d = q.shape
    qt = q.reshape(b, sq, hk * g, d).transpose(1, 2)  # head h = hk * G + g
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = F.scaled_dot_product_attention(
            qt, k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=sm_scale, enable_gqa=g > 1,
        )
    return o.transpose(1, 2).reshape(b, sq, hk, g, d)


@functools.lru_cache(maxsize=64)
def prefill_schedule(
    seq: int, block: int, local: int, stride: int, glob: int
) -> ap.BlockSchedule:
    """The causal pixelfly block schedule of a length-``seq`` prefill."""
    mask = ap.pixelfly_attention_block_mask(
        seq,
        seq,
        ap.AttentionPatternConfig(
            block=block, local_blocks=local, max_stride=stride, global_blocks=glob
        ),
        causal=True,
    )
    return ap.block_schedule(mask, block, block)


@functools.lru_cache(maxsize=64)
@uncounted
def _schedule_tensors(
    seq: int, block: int, local: int, stride: int, glob: int, device: str
) -> tuple[torch.Tensor, torch.Tensor]:
    sched = prefill_schedule(seq, block, local, stride, glob)
    kv_index = torch.as_tensor(sched.kv_index, device=device)
    ops.register_schedule(kv_index, sched.kv_index, sched.valid)
    return kv_index, torch.as_tensor(sched.valid, device=device)


def sparse_prefill_attention(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Causal pixelfly attention of a prefill: q (B,S,Hk,G,D), k, v
    (B,S,Hk,D), S a multiple of ``cfg.attn_block``. The card runs the
    block-sparse attention kernel, the CPU its plain version, both through
    ``autograd.BlockSparseAttention`` (whose backward is the JAX package's
    gradient of the gathered sparse attention)."""
    kv_index, valid = _schedule_tensors(
        q.shape[1],
        cfg.attn_block,
        cfg.attn_local_blocks,
        cfg.attn_max_stride,
        cfg.attn_global_blocks,
        str(q.device),
    )
    return autograd.block_sparse_attention(
        q, k, v, kv_index, valid,
        block=cfg.attn_block, causal=True, sm_scale=sm_scale,
    )


def _pixelfly_visible(
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    *,
    block: int,
    local_blocks: int,
    global_blocks: int,
    max_stride: int,
) -> torch.Tensor:
    """Elementwise causal pixelfly visibility by absolute positions (int64
    tensors, broadcast against each other).

    Exactly the causal-visible entries of
    ``attn_pattern.pixelfly_attention_block_mask`` on a power-of-two block
    grid: local window, global cross, and the butterfly strides (``qb ^
    kb`` a power of two below the stride cap). Causal-visible entries do
    not depend on the total block count, so the rule holds for every
    bucket and a cached prefix sees the mask its donor prefill used."""
    qb = torch.div(qpos, block, rounding_mode="floor")
    kb = torch.div(kpos, block, rounding_mode="floor")
    diff = qb ^ kb
    stride = (diff > 0) & ((diff & (diff - 1)) == 0)
    if max_stride:
        stride = stride & (diff < next_pow2(max_stride))
    vis = (
        (kb < global_blocks)
        | (qb < global_blocks)
        | ((qb >= kb) & (qb - kb < local_blocks))
        | stride
    )
    return vis & (kpos <= qpos)


def prefix_flash_attention(
    q: torch.Tensor,
    k_suf: torch.Tensor,
    v_suf: torch.Tensor,
    k_pre: torch.Tensor,
    v_pre: torch.Tensor,
    prefix_len: torch.Tensor,
    *,
    sm_scale: float,
    chunk: int,
    block_cfg: tuple[int, int, int, int] | None = None,
) -> torch.Tensor:
    """Partial-prefill attention: suffix queries over [prefix ; suffix],
    the JAX package's ``prefix_flash_attention_jnp``.

    q (B,Sq,Hk,G,D) are the uncached suffix queries, at absolute positions
    ``prefix_len[b] + i``; k_suf/v_suf (B,Sq,Hk,D) their keys; k_pre/v_pre
    (B,Lp,Hk,D) the cached prefix K/V gathered through the page table
    (rows valid where j < prefix_len[b]; the rest is trash-page padding).
    Online softmax over KV chunks of ``chunk`` keys with per-row masks
    (prefix validity, causality on absolute positions); ``block_cfg`` =
    (block, local_blocks, global_blocks, max_stride) adds the elementwise
    pixelfly mask (``_pixelfly_visible``) so a sparse-attention model's
    partial prefill matches its full prefill (``prefix_len`` a multiple of
    the block). None = dense causal. Plain torch ops: the JAX package
    computes this outside Pallas, so no kernel stands behind it. The scale
    is folded into q in fp32 and q cast back to the model dtype; scores
    and P @ V accumulate in fp32, with P rounded to the model dtype."""
    sq = q.shape[1]
    lp = k_pre.shape[1]
    k = torch.cat([k_pre.to(k_suf.dtype), k_suf], dim=1)
    v = torch.cat([v_pre.to(v_suf.dtype), v_suf], dim=1)
    sk = lp + sq
    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_in = (q.float() * sm_scale).to(q.dtype).float()
    plen = prefix_len.long()[:, None]
    qpos = plen + torch.arange(sq, device=dev)[None, :]  # (B, Sq) absolute

    def mask_fn(c0):
        j = c0 + torch.arange(chunk, device=dev)[None, :]  # [prefix ; suffix]
        is_pre = j < lp
        # absolute key positions: prefix token j sits at j, suffix token
        # j - lp at prefix_len + (j - lp); padded tails land beyond every
        # query position and die to the causal mask
        kpos = torch.where(is_pre, j, plen + (j - lp))  # (B, chunk)
        valid = torch.where(is_pre, j < plen, j < sk)
        mask = valid[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None])
        if block_cfg is not None:
            blk, loc, glo, stride = block_cfg
            mask = mask & _pixelfly_visible(
                qpos[:, :, None], kpos[:, None, :],
                block=blk, local_blocks=loc, global_blocks=glo,
                max_stride=stride,
            )
        return mask[:, None, None]

    return _online_softmax_scan(q_in, k, v, chunk, mask_fn).to(q.dtype)


# ----------------------------------------------------------------------
# Decode attention over a contiguous cache (the fixed-batch Server's path)
# ----------------------------------------------------------------------


def _decode_softmax_out(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ok: torch.Tensor, sm_scale: float
) -> torch.Tensor:
    """q (B,1,Hk,G,D) against k, v (B,Sk,Hk,D) where ``ok`` (Sk,) is True:
    fp32 scores and P @ V with P rounded to v's dtype, as the JAX
    package's grouped einsums with an fp32 preferred type. A row with no
    visible key gives 0."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * sm_scale
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Single-token decode, the JAX package's ``decode_attention_jnp``: q
    (B,1,Hk,G,D) against the cache (B,S,Hk,D) at positions <= ``pos``.
    Plain torch ops: the JAX package computes it in jnp, with no kernel."""
    ok = torch.arange(k_cache.shape[1], device=q.device) <= pos
    return _decode_softmax_out(q, k_cache, v_cache, ok, sm_scale)


def sparse_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    sm_scale: float,
    block: int,
    local_blocks: int,
    global_blocks: int,
) -> torch.Tensor:
    """Pixelfly-sparse decode over a contiguous cache, the JAX package's
    ``sparse_decode_attention_jnp``: the query reads only the key blocks
    of its global, local and butterfly schedule. The contiguous cache is
    the paged layout with an identity page table, so the schedule is
    ``paged_sparse_schedule``'s; a block listed twice (an XOR collision)
    is read once."""
    b, _, hk, _, d = q.shape
    nb = k_cache.shape[1] // block
    table = torch.arange(nb, dtype=torch.int32, device=q.device)[None]
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=q.device)
    idx, _, first = paged_sparse_schedule(
        table, pos_t, block, local_blocks=local_blocks, global_blocks=global_blocks
    )
    idx, first = idx[0].long(), first[0].bool()  # (w,)
    w = idx.shape[0]
    kg = k_cache.reshape(b, nb, block, hk, d)[:, idx].reshape(b, w * block, hk, d)
    vg = v_cache.reshape(b, nb, block, hk, d)[:, idx].reshape(b, w * block, hk, d)
    kpos = (idx[:, None] * block + torch.arange(block, device=q.device)[None]).reshape(-1)
    ok = (kpos <= pos) & first.repeat_interleave(block)
    return _decode_softmax_out(q, kg, vg, ok, sm_scale)


# ----------------------------------------------------------------------
# Paged decode attention
# ----------------------------------------------------------------------


def paged_sparse_schedule(
    page_table: torch.Tensor,
    pos: torch.Tensor,
    page: int,
    *,
    local_blocks: int,
    global_blocks: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-slot pixelfly decode schedule over a paged cache.

    Global anchors + local window + butterfly XOR strides of the slot's
    current block, clamped causal. Returns ``(logical, phys, keep)``, each
    (B, w) int32: logical block ids, physical pages through
    ``page_table``, and a first-occurrence mask (a stable sort keeps the
    first of equal ids) disabling duplicate slots.
    """
    b, np_ = page_table.shape
    cur = torch.div(pos, page, rounding_mode="floor").to(torch.int32)
    n_str = int(math.log2(np_)) if np_ > 1 else 0
    idx = [
        torch.full((b,), i, dtype=torch.int32, device=pos.device)
        for i in range(global_blocks)
    ]
    for j in range(local_blocks):
        idx.append(torch.clamp(cur - j, min=0))
    for t in range(n_str):
        idx.append(cur ^ (1 << t))
    logical = torch.stack(idx, dim=1)
    logical = torch.minimum(logical, torch.clamp(cur, min=0)[:, None])
    w = logical.shape[1]
    phys = torch.gather(page_table, 1, logical.long())
    order = torch.argsort(logical, dim=1, stable=True)
    sorted_idx = torch.gather(logical, 1, order)
    newgrp = torch.cat(
        [
            torch.ones((b, 1), dtype=torch.bool, device=pos.device),
            torch.diff(sorted_idx, dim=1) != 0,
        ],
        dim=1,
    )
    keep = torch.zeros((b, w), dtype=torch.bool, device=pos.device)
    keep = keep.scatter(1, order, newgrp)
    return logical, phys.to(torch.int32), keep.to(torch.int32)


def paged_dense_schedule(
    page_table: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense paged read as a schedule: every logical page of the
    slot's table, all kept. Returns ``(logical, phys, keep)`` (B, P)."""
    b, np_ = page_table.shape
    logical = torch.arange(np_, dtype=torch.int32, device=page_table.device)
    logical = logical[None].expand(b, np_).contiguous()
    keep = torch.ones((b, np_), dtype=torch.int32, device=page_table.device)
    return logical, page_table.to(torch.int32).contiguous(), keep


@dataclasses.dataclass(frozen=True)
class DecodeIndex:
    """Where one decode step writes and reads the paged cache, the same for
    every layer: each slot's write page and offset, and the (B, w) read
    schedule ``logical``/``phys``/``keep`` of the paged decode kernel."""

    write_page: torch.Tensor  # (B,) int64
    write_off: torch.Tensor   # (B,) int64
    logical: torch.Tensor
    phys: torch.Tensor
    keep: torch.Tensor


def decode_index(
    cfg: ModelConfig, page_table: torch.Tensor, pos: torch.Tensor, page: int
) -> DecodeIndex:
    """Build the step's ``DecodeIndex``: the pixelfly schedule when the
    model has sparse attention and the page is the attention block, else
    the dense read (every logical page, all kept)."""
    pos_l = pos.long()
    write_page = torch.gather(page_table, 1, (pos_l // page)[:, None])[:, 0].long()
    if cfg.sparse_attention and page == cfg.attn_block:
        logical, phys, keep = paged_sparse_schedule(
            page_table, pos, page,
            local_blocks=cfg.attn_local_blocks,
            global_blocks=cfg.attn_global_blocks,
        )
    else:
        logical, phys, keep = paged_dense_schedule(page_table)
    return DecodeIndex(write_page, pos_l % page, logical, phys, keep)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Decode against a paged cache, dense over logical pages: q
    (B,1,Hk,G,D); pools (n_pages, page, Hk, D); page_table (B, P); pos (B,)
    int32. Returns (B,1,Hk,G,D). The JAX package's
    ``paged_decode_attention_jnp``: the kernel with logical = arange and
    every slot kept."""
    logical, phys, keep = paged_dense_schedule(page_table)
    o = ops.paged_decode_attention(
        q[:, 0].contiguous(), k_pages, v_pages, phys, logical, keep, pos,
        sm_scale=sm_scale,
    )
    return o[:, None]


def paged_sparse_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    *,
    sm_scale: float,
    local_blocks: int,
    global_blocks: int,
) -> torch.Tensor:
    """Pixelfly-sparse paged decode: each slot reads only the pages of its
    ``paged_sparse_schedule``. Shapes as ``paged_decode_attention``."""
    logical, phys, keep = paged_sparse_schedule(
        page_table, pos, k_pages.shape[1],
        local_blocks=local_blocks, global_blocks=global_blocks,
    )
    o = ops.paged_decode_attention(
        q[:, 0].contiguous(), k_pages, v_pages, phys, logical, keep, pos,
        sm_scale=sm_scale,
    )
    return o[:, None]


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------


def linear_spec(cfg: ModelConfig, din: int, dout: int, bias: bool) -> LinearSpec:
    if cfg.sparse:
        return LinearSpec.pixelfly(
            din,
            dout,
            cfg.sparse_density,
            block=cfg.sparse_block,
            lowrank_frac=cfg.lowrank_frac,
            use_bias=bias,
            dtype=cfg.torch_dtype,
        )
    return LinearSpec.dense(din, dout, use_bias=bias, dtype=cfg.torch_dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class RMSNorm(nn.Module):
    """Holds the fp32 ``scale`` of one ``rmsnorm``."""

    def __init__(self, dim: int, *, device: torch.device):
        super().__init__()
        self.scale = _param(torch.ones((dim,), dtype=torch.float32, device=device))


class Attention(nn.Module):
    """q/k/v/o projections (+ qk-norm scales); math in ``apply_attention``."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        c = cfg
        self.wq = Linear(linear_spec(c, c.d_model, c.q_dim, c.qkv_bias), gen=gen, device=device)
        self.wk = Linear(linear_spec(c, c.d_model, c.kv_dim, c.qkv_bias), gen=gen, device=device)
        self.wv = Linear(linear_spec(c, c.d_model, c.kv_dim, c.qkv_bias), gen=gen, device=device)
        self.wo = Linear(linear_spec(c, c.q_dim, c.d_model, False), gen=gen, device=device)
        if c.qk_norm:
            self.q_norm = _param(torch.ones((c.head_dim,), dtype=torch.float32, device=device))
            self.k_norm = _param(torch.ones((c.head_dim,), dtype=torch.float32, device=device))


class Mlp(nn.Module):
    """SwiGLU: wd(silu(wg x) * wu x)."""

    def __init__(self, cfg: ModelConfig, d_ff: int, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        self.wg = Linear(linear_spec(cfg, cfg.d_model, d_ff, False), gen=gen, device=device)
        self.wu = Linear(linear_spec(cfg, cfg.d_model, d_ff, False), gen=gen, device=device)
        self.wd = Linear(linear_spec(cfg, d_ff, cfg.d_model, False), gen=gen, device=device)


class Embedding(nn.Module):
    """Token table ``tok`` (padded_vocab, d_model), also the tied head."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        tok = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen) * 0.02
        self.tok = _param(tok.to(cfg.torch_dtype).to(device))


# ----------------------------------------------------------------------
# Forward functions
# ----------------------------------------------------------------------


def apply_attention(
    cfg: ModelConfig,
    attn: Attention,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    **kw,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Returns (y, fresh K/V): ``attention_heads`` and the ``o``
    projection."""
    o, fresh = attention_heads(cfg, attn, x, cos, sin, **kw)
    return attn.wo(o), fresh


def attention_heads(
    cfg: ModelConfig,
    attn: Attention,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    mode: str,
    cache: dict[str, torch.Tensor] | None = None,
    index: DecodeIndex | None = None,
    pos: torch.Tensor | int | None = None,
    prefix_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Returns (the heads' output before ``o``, (B, S, H·D), fresh K/V).
    x (B, S, d_model); cos/sin from ``rope_angles`` of the tokens'
    positions. The head counts are read off the q and k projections, so a
    tensor-parallel shard (its q and kv heads, the JAX "heads" mode) runs
    this unchanged on its own heads and its own pools.

    ``mode="prefill"``: causal attention over the S tokens (pixelfly
    block-sparse when the model has sparse attention and S is a multiple
    of the attention block, else dense); the fresh (k, v), each
    (B, S, Hk, D), are returned for the caller's page scatter.

    ``mode="train"``: the same attention, and no K/V returned.

    ``mode="prefill_prefix"``: cache-aware partial prefill. x holds each
    request's uncached suffix (cos/sin at its absolute positions),
    ``cache`` this layer's slot-shared pools, ``prefix_rows`` (B, P_pre)
    the cached prefix pages and ``pos`` (B,) the prefix lengths (page
    multiples; 0 for a miss). The suffix queries attend the gathered
    prefix keys and their own causal window (``prefix_flash_attention``);
    the fresh suffix (k, v) are returned for the caller's page scatter and
    the shared prefix pages are only read.

    ``mode="decode"``: one token per row at the shared position ``pos``
    (an int) against a contiguous cache ``{"k", "v"}`` (B, S_max, Hk, D):
    the token's K/V are written at ``pos`` in place, then read with
    ``sparse_decode_attention`` when the model has sparse attention and
    S_max is a multiple of at least two attention blocks, else
    ``decode_attention`` (the JAX package's ``decode``/``decode_sparse``).

    ``mode="decode_paged"``: one token per slot (S = 1). ``cache`` holds
    this layer's pools ``k``/``v`` (n_pages, page, Hk, D); the token's K/V
    are written into them in place (the JAX package returns new pools; the
    port has no buffer to donate, so it updates the pools), then the paged
    kernel reads them through ``index``; ``pos`` (B,) int32.
    """
    c = cfg
    b, s, _ = x.shape
    d = c.head_dim
    scale = d ** -0.5
    q = attn.wq(x).reshape(b, s, -1, d)
    k = attn.wk(x).reshape(b, s, -1, d)
    v = attn.wv(x).reshape(b, s, -1, d)
    hk = k.shape[2]
    g = q.shape[2] // hk
    if c.qk_norm:
        q = rmsnorm(attn.q_norm, q, c.norm_eps)  # qk-norm over head_dim
        k = rmsnorm(attn.k_norm, k, c.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qg = q.reshape(b, s, hk, g, d)

    fresh = None
    if mode in ("prefill", "train"):
        if c.sparse_attention and s >= c.attn_block and s % c.attn_block == 0:
            o = sparse_prefill_attention(c, qg, k, v, sm_scale=scale)
        else:
            o = flash_attention(qg, k, v, sm_scale=scale, chunk=c.attn_chunk)
        if mode == "prefill":
            fresh = (k, v)
    elif mode == "prefill_prefix":
        page = cache["k"].shape[1]
        rows = prefix_rows.long()
        npre = rows.shape[1]
        kp = cache["k"][rows].reshape(b, npre * page, hk, d)
        vp = cache["v"][rows].reshape(b, npre * page, hk, d)
        block_cfg = (
            (c.attn_block, c.attn_local_blocks, c.attn_global_blocks, c.attn_max_stride)
            if c.sparse_attention and s >= c.attn_block and s % c.attn_block == 0
            else None
        )
        with torch.profiler.record_function("prefix_flash_attention"):
            o = prefix_flash_attention(
                qg, k, v, kp, vp, pos,
                sm_scale=scale, chunk=c.attn_chunk, block_cfg=block_cfg,
            )
        fresh = (k, v)
    elif mode == "decode_paged":
        # write-at-position: each slot's token lands in its own page; idle
        # slots all write the shared trash page 0 (never read back)
        kc, vc = cache["k"], cache["v"]
        kc[index.write_page, index.write_off] = k[:, 0].to(kc.dtype)
        vc[index.write_page, index.write_off] = v[:, 0].to(vc.dtype)
        o = ops.paged_decode_attention(
            qg[:, 0].contiguous(), kc, vc,
            index.phys, index.logical, index.keep, pos,
            sm_scale=scale,
        )
    elif mode == "decode":
        kc, vc = cache["k"], cache["v"]
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        smax = kc.shape[1]
        if c.sparse_attention and smax % c.attn_block == 0 and smax >= 2 * c.attn_block:
            o = sparse_decode_attention(
                qg, kc, vc, pos, sm_scale=scale, block=c.attn_block,
                local_blocks=c.attn_local_blocks, global_blocks=c.attn_global_blocks,
            )
        else:
            o = decode_attention(qg, kc, vc, pos, sm_scale=scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    return o.reshape(b, s, hk * g * d), fresh


def apply_mlp(mlp: Mlp, x: torch.Tensor) -> torch.Tensor:
    return mlp.wd(mlp_hidden(mlp, x))


def mlp_hidden(mlp: Mlp, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU's hidden activation ``silu(wg x) * wu x`` (a shard's slice of
    it on a tensor-parallel shard)."""
    gate = mlp.wg(x)
    up = mlp.wu(x)
    return F.silu(gate.float()).to(x.dtype) * up


def tp_project(linears: list[Linear], hs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The output projection (``o`` or ``down``) of ``tp`` shards, from each
    shard's slice of its input (its heads, its hidden units) to the whole
    output on every shard, as the JAX layouts place it
    (``distributed.sharding``): a pixelfly linear is column-parallel (its
    block rows of the output), so the inputs are all-gathered first and
    the output slices after; a dense one is row-parallel (its rows of
    ``w``), so the partial products are all-reduced."""
    if linears[0].spec.sparse:
        full = collectives.all_gather(hs, dim=-1)
        return collectives.all_gather([lin(h) for lin, h in zip(linears, full)], dim=-1)
    return collectives.all_reduce([lin(h) for lin, h in zip(linears, hs)])


def embed_tokens(embed: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tok`` (a gather). ``F.embedding``, not indexing: its
    backward sums each row's gradient in a fixed order, where indexing's
    scatter-add on the CPU does not, so a training step repeats exactly."""
    return F.embedding(tokens, embed.tok)


def embed_tokens_tp(embeds: list[Embedding], tokens: list[torch.Tensor], first: list[int]) -> list[torch.Tensor]:
    """The lookup of a vocab-sharded table: shard r holds rows [first[r],
    first[r] + its rows) and looks up the tokens in that range, zeros for
    the rest; the all-reduce then gives every shard each token's row
    exactly (one term is the row, the others zero)."""
    out = []
    for embed, toks, lo in zip(embeds, tokens, first):
        n = embed.tok.shape[0]
        local = toks - lo
        mine = (local >= 0) & (local < n)
        rows = F.embedding(torch.where(mine, local, 0), embed.tok)
        out.append(torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)))
    return collectives.all_reduce(out)


def lm_logits(
    cfg: ModelConfig, head: nn.Module | None, embed: Embedding, x: torch.Tensor
) -> torch.Tensor:
    """fp32 logits over the padded vocabulary (tied: ``x @ tok.T``). The
    product is taken in fp32, as the JAX package's einsum with an fp32
    preferred type."""
    w = embed.tok.t() if cfg.tie_embeddings else head.w
    return torch.matmul(x.float(), w.float())
