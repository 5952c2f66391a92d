"""Transformer building blocks of the port: norms, RoPE, GQA attention over
the paged cache, the SwiGLU MLP, embedding and logits.

The attention-family subset of the JAX package's ``models/layers.py``.
Every GEMM of a block goes through ``core.pixelfly.Linear``, so the dense
and the pixelfly-sparse model share this code. Attention math is plain
functions on tensors; the three kernels are reached through
``kernels.ops`` (prefill block-sparse attention, the BSR matmul inside the
linears, and the paged decode read).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attn_pattern as ap
from repro_torch.core.pixelfly import Linear, LinearSpec
from repro_torch.kernels import ops

__all__ = [
    "rmsnorm",
    "rope_angles",
    "apply_rope",
    "flash_attention",
    "prefill_schedule",
    "sparse_prefill_attention",
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
    "apply_mlp",
    "embed_tokens",
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
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) -> cos, sin (B, S, 1, head_dim // 2), fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float
) -> torch.Tensor:
    """Plain causal attention for the dense prefill branch: q (B,S,Hk,G,D),
    k, v (B,S,Hk,D) -> (B,S,Hk,G,D). Scores in fp32, scale folded into q
    in fp32 and q cast back to the model dtype (the JAX package's flash
    path does the same)."""
    sq, sk = q.shape[1], k.shape[1]
    q32 = (q.float() * sm_scale).to(q.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32.float(), k.float())
    causal = torch.arange(sk, device=q.device)[None, :] <= torch.arange(
        sq, device=q.device
    )[:, None]
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


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
def _schedule_tensors(
    seq: int, block: int, local: int, stride: int, glob: int, device: str
) -> tuple[torch.Tensor, torch.Tensor]:
    sched = prefill_schedule(seq, block, local, stride, glob)
    return (
        torch.as_tensor(sched.kv_index, device=device),
        torch.as_tensor(sched.valid, device=device),
    )


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
    block-sparse attention kernel, the CPU its plain version."""
    kv_index, valid = _schedule_tensors(
        q.shape[1],
        cfg.attn_block,
        cfg.attn_local_blocks,
        cfg.attn_max_stride,
        cfg.attn_global_blocks,
        str(q.device),
    )
    return ops.block_sparse_attention(
        q, k, v, kv_index, valid,
        block=cfg.attn_block, causal=True, sm_scale=sm_scale,
    )


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
    return nn.Parameter(t, requires_grad=False)


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
    *,
    mode: str,
    cache: dict[str, torch.Tensor] | None = None,
    index: DecodeIndex | None = None,
    pos: torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Returns (y, fresh K/V). x (B, S, d_model); cos/sin from
    ``rope_angles`` of the tokens' positions.

    ``mode="prefill"``: causal attention over the S tokens (pixelfly
    block-sparse when the model has sparse attention and S is a multiple
    of the attention block, else dense); the fresh (k, v), each
    (B, S, Hk, D), are returned for the caller's page scatter.

    ``mode="decode_paged"``: one token per slot (S = 1). ``cache`` holds
    this layer's pools ``k``/``v`` (n_pages, page, Hk, D); the token's K/V
    are written into them in place (the JAX package returns new pools; the
    port has no buffer to donate, so it updates the pools), then the paged
    kernel reads them through ``index``; ``pos`` (B,) int32.
    """
    c = cfg
    b, s, _ = x.shape
    hk, g, d = c.num_kv_heads, c.num_heads // c.num_kv_heads, c.head_dim
    scale = d ** -0.5
    q = attn.wq(x).reshape(b, s, c.num_heads, d)
    k = attn.wk(x).reshape(b, s, hk, d)
    v = attn.wv(x).reshape(b, s, hk, d)
    if c.qk_norm:
        q = rmsnorm(attn.q_norm, q, c.norm_eps)  # qk-norm over head_dim
        k = rmsnorm(attn.k_norm, k, c.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qg = q.reshape(b, s, hk, g, d)

    fresh = None
    if mode == "prefill":
        if c.sparse_attention and s >= c.attn_block and s % c.attn_block == 0:
            o = sparse_prefill_attention(c, qg, k, v, sm_scale=scale)
        else:
            o = flash_attention(qg, k, v, sm_scale=scale)
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
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    y = attn.wo(o.reshape(b, s, c.q_dim))
    return y, fresh


def apply_mlp(mlp: Mlp, x: torch.Tensor) -> torch.Tensor:
    gate = mlp.wg(x)
    up = mlp.wu(x)
    h = F.silu(gate.float()).to(x.dtype) * up
    return mlp.wd(h)


def embed_tokens(embed: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return embed.tok[tokens]


def lm_logits(
    cfg: ModelConfig, head: nn.Module | None, embed: Embedding, x: torch.Tensor
) -> torch.Tensor:
    """fp32 logits over the padded vocabulary (tied: ``x @ tok.T``). The
    product is taken in fp32, as the JAX package's einsum with an fp32
    preferred type."""
    w = embed.tok.t() if cfg.tie_embeddings else head.w
    return torch.matmul(x.float(), w.float())
