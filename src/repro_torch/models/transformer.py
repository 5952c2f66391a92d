"""Decoder LM of the port (the dense/attention family) and its paged
serving entry points.

The JAX package scans each layer group with ``lax.scan``; here the layers
are an ``nn.ModuleList`` walked by a Python loop, and each layer group's
paged KV pools are one tensor ``(count, n_pages, page, Hk, D)`` of which
layer i reads and writes ``pool[i]`` in place.

Entry points:
  init_model(cfg, seed=, device=)                  -> LM
  init_paged_cache(cfg, n_pages, page, device=)    -> [{"k", "v"}] per group
  prefill_paged(cfg, model, tokens, plens, caches, page_rows)
                                  -> ((N, V) last-real-token logits, caches)
  decode_step_paged(cfg, model, caches, tokens, positions, page_table)
                                  -> ((B, V) logits, caches)
Every entry point runs on the card unless the caller passes another device.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = [
    "resolve_device",
    "Block",
    "LM",
    "init_model",
    "init_paged_cache",
    "prefill_paged",
    "decode_step_paged",
]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none raises:
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


class Block(nn.Module):
    """One decoder layer: pre-norm attention and SwiGLU MLP, residual."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        self.attn_norm = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, gen=gen, device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, device=device)
        self.mlp = L.Mlp(cfg, cfg.d_ff, gen=gen, device=device)


class LM(nn.Module):
    """Parameter names follow the JAX params tree: ``embed.tok``,
    ``final_norm.scale``, ``head.w`` (untied only) and
    ``layers.{i}.<path in the group's subtree>``."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        if cfg.family not in ("dense",):
            raise NotImplementedError(
                f"family {cfg.family!r}: the port serves the dense decoder "
                "family so far (ROADMAP Queue 1 item 8)"
            )
        self.cfg = cfg
        self.embed = L.Embedding(cfg, gen=gen, device=device)
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            w = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen)
            w = (w / cfg.d_model ** 0.5).to(cfg.torch_dtype).to(device)
            self.head.w = nn.Parameter(w, requires_grad=False)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, gen=gen, device=device) for _ in range(cfg.num_layers)
        )


def init_model(
    cfg: ModelConfig, *, seed: int = 0, device: str | torch.device | None = None
) -> LM:
    """Random weights from a CPU ``torch.Generator`` seeded with ``seed``,
    moved to ``device`` tensor by tensor: the same seed gives the same
    weights on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return LM(cfg, gen=gen, device=dev)


def init_paged_cache(
    cfg: ModelConfig, n_pages: int, page: int, *, device: str | torch.device | None = None
) -> list[dict[str, torch.Tensor]]:
    """Slot-shared page pools, one ``{"k", "v"}`` per layer group, each
    (count, n_pages, page, Hk, D) in the model dtype. Physical page 0 is
    the trash page."""
    dev = resolve_device(device)
    shape = (n_pages, page, cfg.num_kv_heads, cfg.head_dim)
    return [
        {
            name: torch.zeros((g.count, *shape), dtype=cfg.torch_dtype, device=dev)
            for name in ("k", "v")
        }
        for g in cfg.layer_groups()
    ]


def _layer_pools(cfg: ModelConfig, caches: list) -> list[dict[str, torch.Tensor]]:
    """Per-layer views ``{"k": pool[i], "v": pool[i]}`` in layer order."""
    out = []
    for g, pool in zip(cfg.layer_groups(), caches):
        out.extend({"k": pool["k"][i], "v": pool["v"][i]} for i in range(g.count))
    return out


def prefill_paged(
    cfg: ModelConfig,
    model: LM,
    tokens: torch.Tensor,
    plens: torch.Tensor,
    caches: list,
    page_rows: torch.Tensor,
):
    """Batched bucketed prefill into the paged cache.

    ``tokens`` (N, S) holds N prompts right-padded to a shared page-multiple
    bucket S; ``plens`` (N,) the real lengths; ``page_rows`` (N, S // page)
    each request's physical pages, with entries past its real pages on the
    trash page 0. Each layer's fresh K/V is scattered into its pools in
    place, where the JAX package scatters into a donated buffer (in one
    shot for all N rows; rows collide only on the trash page,
    where the last write wins harmlessly: every read masks it by logical
    position). The tail of each prompt's last page receives the padding
    tokens' K/V; those positions lie beyond the prompt, so every read masks
    them until decode overwrites them. Returns (logits at each request's
    last real token (N, V), caches).
    """
    x = L.embed_tokens(model.embed, tokens.long())
    n, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(n, s)
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    rows = page_rows.long()
    for blk, pool in zip(model.layers, _layer_pools(cfg, caches)):
        h = L.rmsnorm(blk.attn_norm.scale, x, cfg.norm_eps)
        y, (k, v) = L.apply_attention(cfg, blk.attn, h, cos, sin, mode="prefill")
        for buf, fresh in ((pool["k"], k), (pool["v"], v)):
            page = buf.shape[1]
            buf[rows] = fresh.reshape(n, s // page, page, *fresh.shape[2:]).to(buf.dtype)
        x = x + y
        x = x + L.apply_mlp(blk.mlp, L.rmsnorm(blk.mlp_norm.scale, x, cfg.norm_eps))
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    last = x[torch.arange(n, device=x.device), plens.long() - 1]  # (N, d)
    return L.lm_logits(cfg, model.head, model.embed, last), caches


def decode_step_paged(
    cfg: ModelConfig,
    model: LM,
    caches: list,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    page_table: torch.Tensor,
):
    """Slot-indexed decode step over the paged cache: tokens (B,) one per
    slot; positions (B,) int32 ragged per-slot write positions; page_table
    (B, P) int32. Idle slots pass position 0 with an all-trash row. The
    step's write targets and read schedule are computed once for all
    layers. Returns (logits (B, V), caches)."""
    x = L.embed_tokens(model.embed, tokens.long()[:, None])
    pos = positions.to(torch.int32).contiguous()
    page = caches[0]["k"].shape[2]
    index = L.decode_index(cfg, page_table, pos, page)
    cos, sin = L.rope_angles(pos.long()[:, None], cfg.head_dim, cfg.rope_theta)
    for blk, pool in zip(model.layers, _layer_pools(cfg, caches)):
        h = L.rmsnorm(blk.attn_norm.scale, x, cfg.norm_eps)
        y, _ = L.apply_attention(
            cfg, blk.attn, h, cos, sin,
            mode="decode_paged", cache=pool, index=index, pos=pos,
        )
        x = x + y
        x = x + L.apply_mlp(blk.mlp, L.rmsnorm(blk.mlp_norm.scale, x, cfg.norm_eps))
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    return L.lm_logits(cfg, model.head, model.embed, x[:, 0]), caches
