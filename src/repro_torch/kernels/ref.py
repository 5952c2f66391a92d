"""Plain PyTorch versions of the functions the port's kernels compute.

The CPU path of ``ops`` runs these, the CPU tests hold them against the
JAX package, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card. The main path on the card never calls them. Each one computes in
fp32 and casts to the input dtype at the point where its kernel does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bsr_to_dense",
    "bsr_matmul_gather",
    "bsr_matmul_dense_mask",
    "paged_decode_attention_gather",
    "sparse_attention",
    "block_mask_to_dense",
    "dense_attention_ref",
    "block_sparse_attention_ref",
]


# ----------------------------------------------------------------------
# BSR matmul
# ----------------------------------------------------------------------


def bsr_to_dense(
    blocks: torch.Tensor, cols: torch.Tensor, n_in: int
) -> torch.Tensor:
    """Scatter BSR blocks into the dense (n_in, n_out) weight; duplicate
    column slots sum."""
    nb_out, r, b, _ = blocks.shape
    w = torch.zeros(
        (n_in // b, nb_out, b, b), dtype=blocks.dtype, device=blocks.device
    )
    iblk = torch.arange(nb_out, device=blocks.device)[:, None].expand(nb_out, r)
    w.index_put_(
        (cols.long().reshape(-1), iblk.reshape(-1)),
        blocks.reshape(-1, b, b),
        accumulate=True,
    )
    return w.permute(0, 2, 1, 3).reshape(n_in, nb_out * b)


def bsr_matmul_gather(
    x: torch.Tensor, blocks: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """Gather + einsum BSR matmul: x (..., n_in), blocks (nb_out, r, b, b),
    cols (nb_out, r) -> (..., nb_out * b). One slot at a time, summed in
    fp32, cast to x's dtype once at the end (as the kernel does)."""
    *lead, n_in = x.shape
    nb_out, r, b, _ = blocks.shape
    xb = x.reshape(*lead, n_in // b, b).float()
    cols = cols.long()
    y = None
    for t in range(r):
        xg = xb[..., cols[:, t], :]  # (..., nb_out, b)
        yt = torch.einsum("...ik,ikc->...ic", xg, blocks[:, t].float())
        y = yt if y is None else y + yt
    return y.reshape(*lead, nb_out * b).to(x.dtype)


def bsr_matmul_dense_mask(
    x: torch.Tensor, blocks: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """Masked-dense oracle (full dense FLOPs) — tests only."""
    w = bsr_to_dense(blocks, cols, x.shape[-1])
    return (x.float() @ w.float()).to(x.dtype)


# ----------------------------------------------------------------------
# Paged decode attention
# ----------------------------------------------------------------------


def paged_decode_attention_gather(
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
    """One decode query per slot against the pages of its schedule.

    q (B, Hk, G, D); pools (n_pages, page, Hk, D); phys/logical/keep
    (B, w); pos (B,). Key ``logical * page + offset`` is visible iff it is
    <= pos and its slot is kept. Returns (B, Hk, G, D) in q's dtype; a row
    with no visible key is 0."""
    b, hk, g, d = q.shape
    page = k_pages.shape[1]
    w = phys.shape[1]
    kg = k_pages[phys.long()].reshape(b, w * page, hk, d)
    vg = v_pages[phys.long()].reshape(b, w * page, hk, d)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), kg.float()) * sm_scale
    off = torch.arange(page, device=q.device)
    kpos = (logical.long()[:, :, None] * page + off).reshape(b, w * page)
    ok = (kpos <= pos.long()[:, None]) & keep.bool().repeat_interleave(page, dim=1)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_pages.dtype).float(), vg.float())
    return out.to(q.dtype)


# ----------------------------------------------------------------------
# Block-sparse prefill attention
# ----------------------------------------------------------------------


def sparse_attention(
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
    """Pixelfly block-sparse attention in the grouped layout: q
    (B, S, Hk, G, D), k, v (B, S, Hk, D), schedule kv_index/valid
    (S // block, w). Every query block gathers its scheduled key blocks
    and normalises over all of them at once. Returns (B, S, Hk, G, D)."""
    b, sq, hk, g, d = q.shape
    sk = k.shape[1]
    nqb = sq // block
    kv = kv_index.long()
    w = kv.shape[1]
    qb = q.reshape(b, nqb, block, hk, g, d).float()
    kg = k.reshape(b, sk // block, block, hk, d)[:, kv].float()  # (b,nqb,w,bk,hk,d)
    vg = v.reshape(b, sk // block, block, hk, d)[:, kv]
    s = torch.einsum("biqhgd,biwkhd->bihgqwk", qb, kg) * sm_scale
    ar = torch.arange(block, device=q.device)
    kpos = kv[:, :, None] * block + ar  # (nqb, w, bk)
    ok = (valid[:, :, None] == 1).expand(nqb, w, block)
    if causal:
        qpos = torch.arange(nqb, device=q.device)[:, None] * block + ar  # (nqb, bq)
        ok = ok[:, None] & (kpos[:, None] <= qpos[..., None, None])  # (nqb,bq,w,bk)
        s = s.masked_fill(~ok[None, :, None, None], float("-inf"))
    else:
        s = s.masked_fill(~ok[None, :, None, None, None], float("-inf"))
    sf = s.reshape(*s.shape[:-2], w * block)
    m = sf.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(sf - m)
    l = p.sum(dim=-1, keepdim=True)
    p = (p / torch.where(l == 0, torch.ones_like(l), l)).reshape(s.shape)
    out = torch.einsum("bihgqwk,biwkhd->biqhgd", p.to(v.dtype).float(), vg.float())
    return out.to(q.dtype).reshape(b, sq, hk, g, d)


def block_mask_to_dense(
    block_mask: np.ndarray, bq: int, bk: int, sq: int, sk: int, causal: bool
) -> np.ndarray:
    """Expand an (nqb, nkb) boolean block mask to an (sq, sk) element mask."""
    m = np.repeat(np.repeat(block_mask, bq, axis=0), bk, axis=1)[:sq, :sk]
    if causal:
        m = m & (np.arange(sk)[None, :] <= np.arange(sq)[:, None])
    return m


def dense_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain masked softmax attention. q, k, v: (B, H, S, D); mask (Sq, Sk)."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if mask is not None:
        logits = logits.masked_fill(~mask, neg)
    if causal:
        cm = torch.arange(sk, device=q.device)[None, :] <= torch.arange(
            sq, device=q.device
        )[:, None]
        logits = logits.masked_fill(~cm, neg)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def block_sparse_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_mask: np.ndarray,
    *,
    block_q: int,
    block_k: int,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Oracle: dense attention under the expanded block mask, (B, H, S, D)."""
    sq, sk = q.shape[-2], k.shape[-2]
    m = block_mask_to_dense(block_mask, block_q, block_k, sq, sk, causal)
    return dense_attention_ref(
        q, k, v, torch.as_tensor(m, device=q.device), causal=False, sm_scale=sm_scale
    )
