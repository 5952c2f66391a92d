"""Decoder LM of the port (the dense/attention family) and its paged
serving entry points.

The JAX package scans each layer group with ``lax.scan``; here the layers
are an ``nn.ModuleList`` walked by a Python loop, and each layer group's
paged KV pools are one tensor ``(count, n_pages, page, Hk, D)`` of which
layer i reads and writes ``pool[i]`` in place.

Entry points:
  init_model(cfg, seed=, device=, params=)         -> LM
  init_cache(cfg, batch, max_len, device=)         -> [{"k", "v"}] per group
  prefill(cfg, model, batch)       -> ((B, V) last-token logits, caches)
  decode_step(cfg, model, caches, tokens, pos)     -> ((B, V) logits, caches)
  init_paged_cache(cfg, n_pages, page, device=)    -> [{"k", "v"}] per group
  prefill_paged(cfg, model, tokens, plens, caches, page_rows,
                prefix_rows=, prefix_lens=, full_tokens=, full_plens=,
                sampler=, sampler_candidates=)
                                  -> ((N, V) last-real-token logits, caches)
                                     or (tokens (N,), caches, presence)
  decode_step_paged(cfg, model, caches, tokens, positions, page_table,
                    sampler=, sampler_candidates=)
                                  -> ((B, V) logits, caches)
                                     or (tokens (B,), caches, presence)
  forward_train(cfg, model, batch) -> (loss, {"nll", "lb_loss"})
Every entry point runs on the card unless the caller passes another device.
``init_cache``/``prefill``/``decode_step`` are the contiguous-cache path
of the fixed-batch ``launch.serve.Server``. The serving entry points
build no autograd graph (``torch.no_grad``);
``forward_train`` does, and recomputes each layer in the backward when
``cfg.remat`` is set.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.serving import sampling as sampling_lib

__all__ = [
    "resolve_device",
    "Block",
    "LM",
    "init_model",
    "init_cache",
    "prefill",
    "decode_step",
    "init_paged_cache",
    "prefill_paged",
    "decode_step_paged",
    "forward_train",
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
                "family so far (ROADMAP Queue 1 items 6 and 12)"
            )
        self.cfg = cfg
        self.embed = L.Embedding(cfg, gen=gen, device=device)
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            w = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen)
            w = (w / cfg.d_model ** 0.5).to(cfg.torch_dtype).to(device)
            self.head.w = nn.Parameter(w)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, gen=gen, device=device) for _ in range(cfg.num_layers)
        )


def init_model(
    cfg: ModelConfig,
    *,
    seed: int = 0,
    device: str | torch.device | None = None,
    params: dict[str, torch.Tensor] | None = None,
) -> LM:
    """Random weights from a CPU ``torch.Generator`` seeded with ``seed``,
    moved to ``device`` tensor by tensor: the same seed gives the same
    weights on every device. With ``params`` (a state dict, from
    ``bridge.params_from_jax`` or another model's ``state_dict()``) nothing
    is drawn: the modules are built on the meta device and take the given
    tensors, moved to ``device`` and cast to each parameter's dtype (no
    copy where both already match, so two models may share weights)."""
    dev = resolve_device(device)
    if params is None:
        return LM(cfg, gen=torch.Generator().manual_seed(seed), device=dev)
    meta = torch.device("meta")
    with meta:
        model = LM(cfg, gen=torch.Generator(), device=meta)
    like = model.state_dict()
    model.load_state_dict(
        {k: v.to(dev, like[k].dtype) if k in like else v for k, v in params.items()},
        strict=True,
        assign=True,
    )
    return model


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device: str | torch.device | None = None
) -> list[dict[str, torch.Tensor]]:
    """Contiguous per-row caches, one ``{"k", "v"}`` per layer group, each
    (count, batch, max_len, Hk, D) in the model dtype, zeros."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [
        {
            name: torch.zeros((g.count, *shape), dtype=cfg.torch_dtype, device=dev)
            for name in ("k", "v")
        }
        for g in cfg.layer_groups()
    ]


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
    """Per-layer views ``{"k": pool[i], "v": pool[i]}`` in layer order
    (paged pools or contiguous caches alike)."""
    out = []
    for g, pool in zip(cfg.layer_groups(), caches):
        out.extend({"k": pool["k"][i], "v": pool["v"][i]} for i in range(g.count))
    return out


@torch.no_grad()
def prefill(cfg: ModelConfig, model: LM, batch: dict) -> tuple[torch.Tensor, list]:
    """Full-sequence inference pass, the JAX package's ``prefill``: batch
    {"tokens": (B, S)} (a tensor or numpy, moved to the model's device) ->
    (logits of the last token (B, V), caches [{"k", "v"}] per layer group,
    each (count, B, S, Hk, D))."""
    tokens = torch.as_tensor(batch["tokens"], device=model.embed.tok.device).long()
    x = L.embed_tokens(model.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    fresh = []
    for blk in model.layers:
        h = L.rmsnorm(blk.attn_norm.scale, x, cfg.norm_eps)
        y, kv = L.apply_attention(cfg, blk.attn, h, cos, sin, mode="prefill")
        fresh.append(kv)
        x = x + y
        x = x + L.apply_mlp(blk.mlp, L.rmsnorm(blk.mlp_norm.scale, x, cfg.norm_eps))
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = L.lm_logits(cfg, model.head, model.embed, x[:, -1])
    caches, i = [], 0
    for g in cfg.layer_groups():
        group = fresh[i : i + g.count]
        caches.append({
            name: torch.stack([kv[j] for kv in group]) for j, name in enumerate(("k", "v"))
        })
        i += g.count
    return logits, caches


@torch.no_grad()
def decode_step(
    cfg: ModelConfig, model: LM, caches: list, tokens: torch.Tensor, pos: int
) -> tuple[torch.Tensor, list]:
    """One decode step over contiguous caches, the JAX package's
    ``decode_step``: tokens (B,), every row at position ``pos`` (an int).
    Each layer writes its K/V at ``pos`` in place (the JAX package returns
    new caches). Returns (logits (B, V), caches)."""
    x = L.embed_tokens(model.embed, tokens.long()[:, None])
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long, device=x.device)
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for blk, cache in zip(model.layers, _layer_pools(cfg, caches)):
        h = L.rmsnorm(blk.attn_norm.scale, x, cfg.norm_eps)
        y, _ = L.apply_attention(cfg, blk.attn, h, cos, sin, mode="decode", cache=cache, pos=pos)
        x = x + y
        x = x + L.apply_mlp(blk.mlp, L.rmsnorm(blk.mlp_norm.scale, x, cfg.norm_eps))
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    return L.lm_logits(cfg, model.head, model.embed, x[:, 0]), caches


@torch.no_grad()
def prefill_paged(
    cfg: ModelConfig,
    model: LM,
    tokens: torch.Tensor,
    plens: torch.Tensor,
    caches: list,
    page_rows: torch.Tensor,
    *,
    prefix_rows: torch.Tensor | None = None,
    prefix_lens: torch.Tensor | None = None,
    full_tokens: torch.Tensor | None = None,
    full_plens: torch.Tensor | None = None,
    sampler: dict | None = None,
    sampler_candidates: int | None = None,
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
    them until decode overwrites them.

    Cache-aware partial prefill (prefix-cache hits): with ``prefix_lens``
    (N,), ``tokens``/``plens`` carry only each request's uncached suffix
    and ``prefix_rows`` (N, P_pre) the physical pages already holding its
    prefix K/V (trash-padded past the real prefix). Suffix queries run at
    absolute positions ``prefix_len + i`` and attend the prefix through
    the pages (``apply_attention`` mode ``prefill_prefix``); only suffix
    K/V is computed and scattered. Prefix lengths are whole pages, so the
    suffix starts on a fresh page and the padding tail written above never
    lands in a shared prefix page. ``full_tokens``/``full_plens`` (the
    whole prompts) seed the sampler's presence rows, which must cover the
    cached prefix too.

    Returns (logits at each request's last real token (N, V), caches); or,
    with ``sampler`` (the engine's packed per-request params, see
    ``serving.sampling.sample_prefill``), the first tokens sampled on the
    device: (token ids (N,), caches, presence).
    """
    x = L.embed_tokens(model.embed, tokens.long())
    n, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(n, s)
    mode = "prefill"
    if prefix_lens is not None:
        mode = "prefill_prefix"
        positions = prefix_lens.long()[:, None] + positions
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    rows = page_rows.long()
    for blk, pool in zip(model.layers, _layer_pools(cfg, caches)):
        h = L.rmsnorm(blk.attn_norm.scale, x, cfg.norm_eps)
        y, (k, v) = L.apply_attention(
            cfg, blk.attn, h, cos, sin, mode=mode,
            cache=pool, pos=prefix_lens, prefix_rows=prefix_rows,
        )
        for buf, fresh in ((pool["k"], k), (pool["v"], v)):
            page = buf.shape[1]
            buf[rows] = fresh.reshape(n, s // page, page, *fresh.shape[2:]).to(buf.dtype)
        x = x + y
        x = x + L.apply_mlp(blk.mlp, L.rmsnorm(blk.mlp_norm.scale, x, cfg.norm_eps))
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    last = x[torch.arange(n, device=x.device), plens.long() - 1]  # (N, d)
    logits = L.lm_logits(cfg, model.head, model.embed, last)
    if sampler is None:
        return logits, caches
    with torch.profiler.record_function("sampler"):
        toks, presence = sampling_lib.sample_prefill(
            logits,
            tokens if full_tokens is None else full_tokens,
            plens if full_plens is None else full_plens,
            sampler,
            valid_vocab=cfg.vocab_size,
            candidates=sampler_candidates,
        )
    return toks, caches, presence


@torch.no_grad()
def decode_step_paged(
    cfg: ModelConfig,
    model: LM,
    caches: list,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    page_table: torch.Tensor,
    *,
    sampler: dict | None = None,
    sampler_candidates: int | None = None,
):
    """Slot-indexed decode step over the paged cache: tokens (B,) one per
    slot; positions (B,) int32 ragged per-slot write positions; page_table
    (B, P) int32. Idle slots pass position 0 with an all-trash row. The
    step's write targets and read schedule are computed once for all
    layers. Returns (logits (B, V), caches); or, with ``sampler``, every
    slot's next token sampled on the device (``serving.sampling.
    sample_decode``): (token ids (B,), caches, presence)."""
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
    logits = L.lm_logits(cfg, model.head, model.embed, x[:, 0])
    if sampler is None:
        return logits, caches
    with torch.profiler.record_function("sampler"):
        toks, presence = sampling_lib.sample_decode(
            logits, sampler, valid_vocab=cfg.vocab_size, candidates=sampler_candidates
        )
    return toks, caches, presence


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------


def _train_block(
    cfg: ModelConfig, blk: Block, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    h = L.rmsnorm(blk.attn_norm.scale, x, cfg.norm_eps)
    y, _ = L.apply_attention(cfg, blk.attn, h, cos, sin, mode="train")
    x = x + y
    return x + L.apply_mlp(blk.mlp, L.rmsnorm(blk.mlp_norm.scale, x, cfg.norm_eps))


def forward_train(
    cfg: ModelConfig, model: LM, batch: dict
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The JAX package's ``forward_train``: batch {"tokens", "labels"}
    (B, S) int (tensors or numpy, moved to the model's device) -> (loss,
    {"nll", "lb_loss"}), differentiable with respect to every parameter.

    The loss is the masked mean next-token NLL over ``labels >= 0``: the
    log-partition by logsumexp over the fp32 logits, the gold logit by an
    indicator reduce over the vocabulary, as the reference computes both.
    ``loss = nll + 0.01 * lb``, where the load-balancing term lb is 0 for
    the dense family.

    With ``cfg.remat`` each layer runs under non-reentrant activation
    checkpointing: the backward keeps one residual per layer and runs the
    layer's forward again. The reference checkpoints in two levels (an
    outer checkpoint over about sqrt(n) layers); one level keeps 28 rather
    than 7 + 4 residuals of (B, S, d_model) at full width and does not run
    every layer's forward a third time.
    """
    dev = model.embed.tok.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    x = L.embed_tokens(model.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for blk in model.layers:
        if cfg.remat:
            x = checkpoint(_train_block, cfg, blk, x, cos, sin, use_reentrant=False)
        else:
            x = _train_block(cfg, blk, x, cos, sin)
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = L.lm_logits(cfg, model.head, model.embed, x)
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=dev)
    gold = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    mask = (labels >= 0).float()
    nll = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
    lb = torch.zeros((), device=dev)
    return nll + 0.01 * lb, {"nll": nll, "lb_loss": lb}
