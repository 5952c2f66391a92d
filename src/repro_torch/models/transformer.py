"""Decoder LM of the port, every family of the JAX package: dense, the vlm
and audio backbones, MoE, SSM (Mamba2) and hybrid (zamba2), with the
contiguous-cache entry points of the fixed-batch ``Server`` and the paged
serving entry points.

The JAX package scans each layer group with ``lax.scan``; here the layers
of the groups are an ``nn.ModuleList`` walked by a Python loop
(``LM.blocks()`` gives every depth position's kind and module), and each
group's caches are tensors with a leading ``count`` axis of which layer i
reads and writes row i in place. A block is one of the reference's kinds:
``dense`` (attention and SwiGLU MLP; the MoE family's leading dense layers
take ``moe_dense_ff``), ``moe`` (attention and ``models.moe``), ``ssm``
(pre-norm and a Mamba2 mixer, ``models.ssm``) and ``shared_attn``
(zamba2's attention+MLP block: one parameter set, the module
``LM.shared_attn``, run at each of its positions with a KV cache a
position; its gradient sums over the uses).

Entry points:
  init_model(cfg, seed=, device=, params=)         -> LM
  init_cache(cfg, batch, max_len, device=)         -> per group {"k", "v"}
                                                      or {"conv", "state"}
  prefill(cfg, model, batch, max_len=)
                                  -> ((B, V) last-token logits, caches)
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
``forward_train`` and ``prefill`` take a batch of ``tokens`` or of
``embeds`` (B, S, d_model), the stub modality frontends' contract (vlm,
audio), with optional ``positions``: (B, S), or (B, S, n) M-RoPE streams
when ``cfg.mrope_sections`` is set. The paged entry points embed tokens and
give every M-RoPE stream the token's position, as the JAX package does.
``init_cache``/``prefill``/``decode_step`` are the contiguous-cache path
of the fixed-batch ``launch.serve.Server``, the one path of the SSM and
hybrid families (their state is a row of each slot, not pages:
``init_paged_cache`` refuses them, as the reference does). The serving
entry points build no autograd graph (``torch.no_grad``);
``forward_train`` does, and recomputes each layer in the backward when
``cfg.remat`` is set.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.guards import hot_path
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
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
    """One layer of kind ``dense``/``shared_attn`` (pre-norm attention and
    SwiGLU MLP), ``moe`` (attention and the MoE FFN) or ``ssm`` (pre-norm
    Mamba2 mixer), residual; parameter names as the reference's block."""

    def __init__(self, cfg: ModelConfig, kind: str = "dense", *, gen: torch.Generator, device: torch.device):
        super().__init__()
        if kind == "ssm":
            self.norm = L.RMSNorm(cfg.d_model, device=device)
            self.ssm = ssm_lib.Ssm(cfg, gen=gen, device=device)
            return
        if kind not in ("dense", "shared_attn", "moe"):
            raise ValueError(f"unknown block kind {kind!r}")
        self.attn_norm = L.RMSNorm(cfg.d_model, device=device)
        self.attn = L.Attention(cfg, gen=gen, device=device)
        self.mlp_norm = L.RMSNorm(cfg.d_model, device=device)
        if kind == "moe":
            self.moe = moe_lib.Moe(cfg, gen=gen, device=device)
        else:
            d_ff = cfg.d_ff
            if kind == "dense" and cfg.family == "moe" and cfg.moe_dense_ff:
                d_ff = cfg.moe_dense_ff
            self.mlp = L.Mlp(cfg, d_ff, gen=gen, device=device)


class LM(nn.Module):
    """Parameter names follow the JAX params tree: ``embed.tok``,
    ``final_norm.scale``, ``head.w`` (untied only),
    ``layers.{i}.<path in the group's subtree>`` for the i-th layer of the
    groups that are not shared (counted in depth order), and
    ``<param_key>.<path>`` for a shared group's one block (zamba2's
    ``shared_attn``)."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.embed = L.Embedding(cfg, gen=gen, device=device)
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            w = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen)
            w = (w / cfg.d_model ** 0.5).to(cfg.torch_dtype).to(device)
            self.head.w = nn.Parameter(w)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device)
        self.layers = nn.ModuleList()
        for g in cfg.layer_groups():
            if g.shared:
                if g.param_key not in self._modules:
                    self.add_module(g.param_key, Block(cfg, g.kind, gen=gen, device=device))
            else:
                self.layers.extend(Block(cfg, g.kind, gen=gen, device=device) for _ in range(g.count))

    def blocks(self) -> list[tuple[str, Block]]:
        """(kind, module) of every depth position, in order; a shared
        group's module at each of its positions."""
        out, i = [], 0
        for g in self.cfg.layer_groups():
            for _ in range(g.count):
                if g.shared:
                    out.append((g.kind, self._modules[g.param_key]))
                else:
                    out.append((g.kind, self.layers[i]))
                    i += 1
        return out


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
    """Contiguous per-row caches, one per layer group, zeros: ``{"k",
    "v"}`` (count, batch, max_len, Hk, D) in the model dtype for attention
    groups, ``{"conv", "state"}`` (``ssm.init_ssm_cache`` with a leading
    count) for SSM groups."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [
        ssm_lib.init_ssm_cache(cfg, batch, device=dev, count=g.count)
        if g.kind == "ssm"
        else {
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
    the trash page. A model with SSM layers raises, as the reference does:
    their state is a slot's row, not pages."""
    dev = resolve_device(device)
    if cfg.has_ssm:
        raise NotImplementedError(
            "paged serving caches cover attention families; SSM state is "
            "slot-indexed, not paged"
        )
    shape = (n_pages, page, cfg.num_kv_heads, cfg.head_dim)
    return [
        {
            name: torch.zeros((g.count, *shape), dtype=cfg.torch_dtype, device=dev)
            for name in ("k", "v")
        }
        for g in cfg.layer_groups()
    ]


def _streams(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """(B, S) positions, broadcast to (B, S, n) for the model's n M-RoPE
    streams when it has them."""
    if cfg.mrope_sections:
        return positions[..., None].expand(*positions.shape, len(cfg.mrope_sections))
    return positions


def _angles(cfg: ModelConfig, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return L.rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)


def _inputs_to_x(cfg: ModelConfig, model: LM, batch: dict) -> torch.Tensor:
    """The batch's ``embeds`` cast to the model dtype, else its ``tokens``
    embedded (either a tensor or numpy, moved to the model's device)."""
    dev = model.embed.tok.device
    if "embeds" in batch:
        return torch.as_tensor(batch["embeds"], device=dev).to(cfg.torch_dtype)
    return L.embed_tokens(model.embed, torch.as_tensor(batch["tokens"], device=dev).long())


def _positions(cfg: ModelConfig, batch: dict, b: int, s: int, device: torch.device) -> torch.Tensor:
    """The batch's ``positions`` if it has them, else 0..S-1 per row (on
    every M-RoPE stream)."""
    if "positions" in batch:
        return torch.as_tensor(batch["positions"], device=device).long()
    return _streams(cfg, torch.arange(s, device=device)[None].expand(b, s))


def _layer_pools(cfg: ModelConfig, caches: list) -> list[dict[str, torch.Tensor]]:
    """Per-layer views ``{name: cache[name][i]}`` in depth order (paged
    pools, contiguous KV caches and SSM caches alike)."""
    out = []
    for g, pool in zip(cfg.layer_groups(), caches):
        out.extend({name: t[i] for name, t in pool.items()} for i in range(g.count))
    return out


def _attn_block(
    cfg: ModelConfig, kind: str, blk: Block, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    **attn_kw,
) -> tuple[torch.Tensor, tuple | None, torch.Tensor | None]:
    """An attention block (``dense``, ``shared_attn`` or ``moe``): returns
    (x, the attention's fresh K/V, the MoE load-balance loss or None)."""
    h = L.rmsnorm(blk.attn_norm.scale, x, cfg.norm_eps)
    y, fresh = L.apply_attention(cfg, blk.attn, h, cos, sin, **attn_kw)
    x = x + y
    h = L.rmsnorm(blk.mlp_norm.scale, x, cfg.norm_eps)
    lb = None
    if kind == "moe":
        y, lb = moe_lib.apply_moe(blk.moe, h)
    else:
        y = L.apply_mlp(blk.mlp, h)
    return x + y, fresh, lb


def _ssm_block(cfg: ModelConfig, blk: Block, x: torch.Tensor, **kw):
    """An SSM block over the whole sequence: (x, the cache of
    ``apply_ssm_train``)."""
    y, cache = ssm_lib.apply_ssm_train(blk.ssm, L.rmsnorm(blk.norm.scale, x, cfg.norm_eps), **kw)
    return x + y, cache


def _stack_groups(cfg: ModelConfig, per_layer: list[dict[str, torch.Tensor]]) -> list[dict[str, torch.Tensor]]:
    """Per-layer caches in depth order -> one dict a group, each entry
    stacked on a leading count axis."""
    caches, i = [], 0
    for g in cfg.layer_groups():
        group = per_layer[i : i + g.count]
        caches.append({name: torch.stack([c[name] for c in group]) for name in group[0]})
        i += g.count
    return caches


@torch.no_grad()
def prefill(
    cfg: ModelConfig, model: LM, batch: dict, *, max_len: int | None = None
) -> tuple[torch.Tensor, list]:
    """Full-sequence inference pass, the JAX package's ``prefill``: batch
    {"tokens": (B, S)} or {"embeds", "positions"} (tensors or numpy, moved
    to the model's device) -> (logits of the last token (B, V), caches per
    layer group: attention groups' {"k", "v"} (count, B, S, Hk, D), SSM
    groups' {"conv", "state"} (the state after the last token)). With
    ``max_len`` the K/V caches are ``init_cache``'s (count, B, max_len,
    Hk, D), the prompt's K/V in the first S rows and zeros after, so
    ``decode_step`` continues from position S."""
    x = _inputs_to_x(cfg, model, batch)
    b, s, _ = x.shape
    cos, sin = _angles(cfg, _positions(cfg, batch, b, s, x.device))
    fresh = []
    for kind, blk in model.blocks():
        if kind == "ssm":
            x, cache = _ssm_block(cfg, blk, x, return_state=True)
        else:
            x, (k, v), _ = _attn_block(cfg, kind, blk, x, cos, sin, mode="prefill")
            if max_len is not None:
                k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, max_len - s)) for t in (k, v))
            cache = {"k": k, "v": v}
        fresh.append(cache)
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = L.lm_logits(cfg, model.head, model.embed, x[:, -1])
    return logits, _stack_groups(cfg, fresh)


@torch.no_grad()
def decode_step(
    cfg: ModelConfig, model: LM, caches: list, tokens: torch.Tensor, pos: int
) -> tuple[torch.Tensor, list]:
    """One decode step over contiguous caches, the JAX package's
    ``decode_step``: tokens (B,), every row at position ``pos`` (an int).
    Each attention layer writes its K/V at ``pos`` in place, each SSM
    layer its new conv window and state (the JAX package returns new
    caches). Returns (logits (B, V), caches)."""
    x = L.embed_tokens(model.embed, tokens.long()[:, None])
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long, device=x.device)
    cos, sin = _angles(cfg, _streams(cfg, positions))
    for (kind, blk), cache in zip(model.blocks(), _layer_pools(cfg, caches)):
        if kind == "ssm":
            h = L.rmsnorm(blk.norm.scale, x, cfg.norm_eps)
            y, new = ssm_lib.apply_ssm_decode(blk.ssm, h, cache)
            for name, t in new.items():
                cache[name].copy_(t)
            x = x + y
        else:
            x, _, _ = _attn_block(cfg, kind, blk, x, cos, sin, mode="decode", cache=cache, pos=pos)
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
    cos, sin = _angles(cfg, _streams(cfg, positions))
    rows = page_rows.long()
    for (kind, blk), pool in zip(model.blocks(), _layer_pools(cfg, caches)):
        x, (k, v), _ = _attn_block(
            cfg, kind, blk, x, cos, sin, mode=mode,
            cache=pool, pos=prefix_lens, prefix_rows=prefix_rows,
        )
        for buf, fresh in ((pool["k"], k), (pool["v"], v)):
            page = buf.shape[1]
            buf[rows] = fresh.reshape(n, s // page, page, *fresh.shape[2:]).to(buf.dtype)
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


@hot_path
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
    cos, sin = _angles(cfg, _streams(cfg, pos.long()[:, None]))
    for (kind, blk), pool in zip(model.blocks(), _layer_pools(cfg, caches)):
        x, _, _ = _attn_block(
            cfg, kind, blk, x, cos, sin,
            mode="decode_paged", cache=pool, index=index, pos=pos,
        )
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
    cfg: ModelConfig, kind: str, blk: Block, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One block of the training forward: (x, its load-balance loss, 0
    unless it is an MoE block)."""
    if kind == "ssm":
        x, _ = _ssm_block(cfg, blk, x)
        lb = None
    else:
        x, _, lb = _attn_block(cfg, kind, blk, x, cos, sin, mode="train")
    return x, torch.zeros((), device=x.device) if lb is None else lb


def forward_train(
    cfg: ModelConfig, model: LM, batch: dict
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The JAX package's ``forward_train``: batch {"tokens" | "embeds",
    "labels"} with optional "positions" (tensors or numpy, moved to the
    model's device; embeds cast to the model dtype) -> (loss, {"nll",
    "lb_loss"}), differentiable with respect to every parameter. A
    parameter the loss does not reach (the token table when a model with
    an untied head reads embeddings) gets no gradient here;
    ``training.loop`` gives it zeros, as JAX's ``grad`` does.

    The loss is the masked mean next-token NLL over ``labels >= 0``: the
    log-partition by logsumexp over the fp32 logits, the gold logit by an
    indicator reduce over the vocabulary, as the reference computes both.
    ``loss = nll + 0.01 * lb``, where lb sums the MoE layers' load-balance
    losses (0 for the other families).

    With ``cfg.remat`` each layer runs under non-reentrant activation
    checkpointing: the backward keeps one residual per layer and runs the
    layer's forward again. The reference checkpoints in two levels (an
    outer checkpoint over about sqrt(n) layers); one level keeps 28 rather
    than 7 + 4 residuals of (B, S, d_model) at full width and does not run
    every layer's forward a third time.
    """
    dev = model.embed.tok.device
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    x = _inputs_to_x(cfg, model, batch)
    b, s, _ = x.shape
    cos, sin = _angles(cfg, _positions(cfg, batch, b, s, dev))
    lb = torch.zeros((), device=dev)
    for kind, blk in model.blocks():
        if cfg.remat:
            x, lb_i = checkpoint(_train_block, cfg, kind, blk, x, cos, sin, use_reentrant=False)
        else:
            x, lb_i = _train_block(cfg, kind, blk, x, cos, sin)
        lb = lb + lb_i
    x = L.rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = L.lm_logits(cfg, model.head, model.embed, x)
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=dev)
    gold = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    mask = (labels >= 0).float()
    nll = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
    return nll + 0.01 * lb, {"nll": nll, "lb_loss": lb}
