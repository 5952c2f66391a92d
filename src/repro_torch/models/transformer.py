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
  prefill(cfg, model, batch, max_len=, replica=)
                                  -> ((B, V) last-token logits, caches)
  decode_step(cfg, model, caches, tokens, pos, replica=)
                                                   -> ((B, V) logits, caches)
                                     (model an LM, a ShardedLM or a MeshState)
  init_mesh_cache(cfg, state, batch, max_len, replica=)
                                                   -> caches a replica
  shard_model(cfg, mesh, state_dict)               -> ShardedLM (tp shards)
  build_shards(cfg, devices, parts, trainable=)    -> ShardedLM of given slices
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
  forward_train(cfg, model, batch, count=)  -> (loss, {"nll", "lb_loss"})
                                     (model an LM or a ShardedLM)
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

Tensor-parallel serving: ``prefill_paged`` and ``decode_step_paged`` take
a ``ShardedLM`` (``shard_model``: the state dict cut by
``distributed.sharding``, shard r on device r of a ``(1, tp)`` mesh) and
one list of pools a shard, each with its kv heads (``serving.kv_cache``).
One process drives every shard, layer by layer: each shard runs its heads
and its slice of the MLP (its block rows of each pixelfly linear, or its
output columns of every block where tp does not divide the block rows),
or, in an MoE layer, its experts and router columns (``moe.apply_moe_tp``)
and its slice of the shared experts, or, in an SSM layer, its SSM heads
(``ssm.apply_ssm_tp``); ``layers.tp_project``, the MoE joins
and the vocab-sharded embedding and logits join them
(``distributed.collectives``); the residual stream and the norms are
replicated. Where tp does not divide the kv heads, serving runs attention
in the JAX "seq" mode instead of by heads (``layers.attention_seq``: the
whole q, k and v on every shard, each shard's query rows in prefill, the
pools and contiguous caches cut on head_dim, the decode scores summed over
the shards), and ``o`` takes the whole rows. The logits are gathered
onto the first shard's device, where the fused sampler runs once.
``forward_train`` takes a ``ShardedLM`` too (``build_shards(...,
trainable=True)``, the mesh trainer's, ``training.loop``): the same layers
in training mode, and a vocab-sharded cross-entropy. So do the
contiguous ``prefill`` and ``decode_step`` (one contiguous cache a shard,
with its kv heads and its SSM heads' state), and both take a
``training.loop.MeshState`` too: the
JAX ``prefill``/``decode_step`` on a mesh under fsdp or tp, each data
replica gathering its parameters and running its rows (the dry-run's
prefill and decode cells, ``launch.dryrun``, and the fixed-batch
``launch.serve.Server`` on a mesh).
"""

from __future__ import annotations

import re

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.guards import hot_path
from repro_torch.analysis.roofline import uncounted
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pixelfly import Linear
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.serving import sampling as sampling_lib

__all__ = [
    "resolve_device",
    "Block",
    "LM",
    "init_model",
    "ShardedLM",
    "shard_model",
    "build_shards",
    "mark_linear_slices",
    "check_tp_layout",
    "skeleton",
    "assign",
    "init_cache",
    "init_mesh_cache",
    "check_mesh_cache",
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


class ShardedLM(nn.Module):
    """``tp`` shards of an ``LM``, built by ``shard_model`` or
    ``build_shards``. ``shards[r]`` is an ``LM`` whose tensors are shard r's
    slices, on ``devices[r]``; ``vocab_first[r]`` is the first token id of
    its rows of the token table."""

    def __init__(self, cfg: ModelConfig, devices: list[torch.device], shards: list[LM]):
        super().__init__()
        self.cfg = cfg
        self.shards = nn.ModuleList(shards)
        self.devices = list(devices)
        rows = shards[0].embed.tok.shape[0]
        self.vocab_first = [r * rows for r in range(len(shards))]


# the dimensions of the full tensor that the JAX rules may put on the model
# axis for each kind of tensor, in the layouts the shard-local forms
# compute (pixelfly and dense linears on their natural axis; a pixelfly
# gate, up, o or down (dense or shared experts') on its blocks' output
# columns where tp does not divide its block rows; the MoE experts on their
# expert axis and the router on its columns; a vocab-sharded table; the SSM
# mixer's ``in_proj`` on its output features, ``out_proj`` as ``o`` and
# ``down``, ``conv_w`` on its channels, its per-head and per-channel
# vectors whole); None = replicated. The first pattern that matches
# decides; a spec that differs is a layout this port does not have. A q,
# k or v projection cut on its blocks' output columns is joined whole on
# every shard: in the sequence-parallel mode (``layers.attention_seq``) and
# in the heads mode alike, where each shard then takes its heads' features
# (``layers.tp_heads_qkv``).
_TP_LAYOUT = (
    (r"embed\.tok$", {0}),
    (r"head\.w$", {1}),
    (r"\.moe\.router$", {1}),
    (r"\.moe\.w[gud](\.(blocks|U|V|gamma))?$", {0}),
    (r"\.(wq|wk|wv|wg|wu|wo|wd|out_proj)\.blocks$", {0, 3}),
    (r"\.(blocks|V|b)$", {0}),
    (r"\.(wq|wk|wv|wg|wu|in_proj)\.w$", {1}),
    (r"\.(wo|wd|out_proj)\.w$", {0}),
    (r"\.ssm\.conv_w$", {1}),
    (r"\.ssm\.(A_log|D|dt_bias|norm|conv_b)$", {None}),
    (r"\.(U|gamma|scale|q_norm|k_norm)$", {None}),
)


def check_tp_layout(cfg: ModelConfig, st: sharding.Strategy, shapes: dict) -> dict:
    """Refuse (``ValueError``) any configuration ``sharding.check_tp``
    refuses in serving and any tensor whose tensor-parallel spec is not
    the layout the shard-local forms compute (``_TP_LAYOUT``).
    ``shapes``: a state dict (or anything with shapes). Returns the
    specs."""
    tp = st.tp_size
    sharding.check_tp(cfg, tp)
    specs = sharding.param_specs(st, shapes)
    for name, spec in specs.items():
        want = next((d for pat, d in _TP_LAYOUT if re.search(pat, name)), set())
        got = sharding.model_dim(st, spec)
        if got not in want:
            item = sharding.REFUSED["ssm_heads"] if ".ssm." in name else "ROADMAP Queue 1 item 16"
            raise ValueError(
                f"{cfg.name} at tp={tp}: {name} {tuple(shapes[name].shape)} has spec {spec}, not a layout "
                f"the port's tensor-parallel forms take; {item}"
            )
    return specs


@uncounted
def skeleton(cfg: ModelConfig) -> LM:
    """An ``LM`` on the meta device (no random draw), to take tensors by
    ``assign``. Its placeholders hold no memory, so a counted step does
    not count them (``analysis.roofline.uncounted``)."""
    meta = torch.device("meta")
    with meta:
        return LM(cfg, gen=torch.Generator(), device=meta)


def assign(model: nn.Module, tensors: dict[str, torch.Tensor], *, trainable: bool = False) -> None:
    """Make each ``tensors[name]`` the parameter ``name`` of ``model`` (a new
    ``nn.Parameter`` on the same storage, cast to the parameter's dtype):
    every wrapper is a leaf of its own, so two modules assigned one tensor
    get their gradients apart."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        setattr(mod, leaf, nn.Parameter(t.to(dtype=getattr(mod, leaf).dtype), requires_grad=trainable))


def build_shards(
    cfg: ModelConfig, devices: list[torch.device], parts: list[dict[str, torch.Tensor]], *, trainable: bool = False
) -> ShardedLM:
    """A ``ShardedLM`` whose shard r takes the tensors ``parts[r]`` (its
    model-axis slices) on ``devices[r]``; its pixelfly linears learn their
    block rows of the global pattern (``Linear.rows``), or their output
    columns of every block where the blocks are cut on those
    (``Linear.cols``). ``trainable``: the parameters require grad (the mesh
    trainer's tensor-parallel forward)."""
    shards = []
    for r, (part, dev) in enumerate(zip(parts, devices)):
        shard = skeleton(cfg)
        assign(shard, {name: t.to(dev) for name, t in part.items()}, trainable=trainable)
        mark_linear_slices(shard, r)
        shards.append(shard)
    return ShardedLM(cfg, devices, shards)


def mark_linear_slices(module: nn.Module, r: int) -> None:
    """Tell each pixelfly ``Linear`` of ``module``, model shard ``r``'s
    slices, what it holds: its block rows of the global pattern
    (``Linear.rows``), or its output columns of every block where the
    blocks are cut on those (``Linear.cols``)."""
    for mod in module.modules():
        if isinstance(mod, Linear) and mod.spec.sparse:
            n, bc = mod.blocks.shape[0], mod.blocks.shape[-1]
            if bc < mod.spec.block:
                mod.cols = (r * bc, (r + 1) * bc)
            else:
                mod.rows = (r * n, (r + 1) * n)


def shard_model(cfg: ModelConfig, mesh: Mesh, state_dict: dict[str, torch.Tensor]) -> ShardedLM:
    """Cut ``state_dict`` (an ``LM``'s, full) into the shards of a ``(1,
    tp)`` mesh by ``distributed.sharding``'s tensor-parallel specs; shard r
    goes to the mesh's device r (a slice of dim 0 stays a view where the
    device and dtype already match, so shards on the state dict's own
    device share its memory). Refuses what ``check_tp_layout`` refuses in
    serving. The mesh trainer builds its trainable shards with
    ``build_shards`` from tensors it gathers over the data axes."""
    st = sharding.Strategy(mesh, "tp")
    check_tp_layout(cfg, st, state_dict)
    parts = sharding.shard_state_dict(st, mesh, state_dict)
    return build_shards(cfg, mesh.model_devices(), parts)


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


def init_mesh_cache(cfg: ModelConfig, state, batch: int, max_len: int, *, replica: int | None = None) -> list:
    """Zero contiguous caches for ``decode_step`` on ``state`` (a
    ``training.loop.MeshState``): one entry a data replica (every replica,
    or replica ``replica`` alone), ``init_cache`` of its rows on its first
    position's device; under tp one cache a model shard, each with its kv
    heads (the heads mode) or, where tp does not divide the kv heads (the
    sequence-parallel mode), its slice of ``head_dim``. The JAX decode
    layout (``sharding.cache_specs(layout="decode")``) puts the model axis
    on ``head_dim`` in both: in the heads mode, where the port cuts the kv
    heads, a position holds the same bytes. A layout that cuts the
    sequence (a batch of one row on a mesh with data axes) needs
    sequence-parallel decode attention and is refused (ROADMAP Queue 1
    item 16); so is anything ``sharding.check_tp`` refuses, by the
    ``MeshState``. An SSM group's caches are ``ssm.init_ssm_cache``'s: under
    tp each shard's heads' state and the conv window of its channels and of
    B and C (``ssm.apply_ssm_tp``), where the JAX layout cuts conv_dim
    evenly and the state on N; the state stays whole in each replica where
    the JAX layout cuts its longest dimension over the data axes (ROADMAP
    Queue 3)."""
    check_mesh_cache(cfg, state.st, batch, max_len)
    reps = state.replicas(batch)
    out = []
    for r, ps in reps if replica is None else [reps[replica]]:
        rows = r[1] - r[0]
        if state.tp == 1:
            out.append(init_cache(cfg, rows, max_len, device=state.devices[ps[0]]))
            continue
        if L.seq_mode(cfg, state.tp):
            shape = (rows, max_len, cfg.num_kv_heads, cfg.head_dim // state.tp)
        else:
            shape = (rows, max_len, cfg.num_kv_heads // state.tp, cfg.head_dim)
        out.append([[ssm_lib.init_ssm_cache(cfg, rows, device=state.devices[p], count=g.count, tp=state.tp)
                      if g.kind == "ssm" else
                      {name: torch.zeros((g.count, *shape), dtype=cfg.torch_dtype, device=state.devices[p])
                       for name in ("k", "v")} for g in cfg.layer_groups()] for p in ps])
    return out


def check_mesh_cache(cfg: ModelConfig, st: sharding.Strategy, batch: int, max_len: int) -> None:
    """Refuse (``ValueError`` naming ROADMAP Queue 1 item 16) a decode cache
    of ``batch`` rows x ``max_len`` that the JAX decode layout cuts along
    the sequence on ``st``'s mesh (``init_mesh_cache``)."""
    whole = init_cache(cfg, batch, max_len, device="meta")
    for g, spec in zip(cfg.layer_groups(), sharding.cache_specs(st, whole)):
        if g.kind != "ssm" and sharding.axes_size(st.mesh, spec["k"][2]) > 1:
            raise ValueError(
                f"{cfg.name}: a decode cache of {batch} row(s) x {max_len} on mesh {st.mesh.shape} is cut along "
                f"the sequence ({spec['k']}), which needs decode attention over a sequence-cut cache; "
                f"{sharding.REFUSED['attention']}"
            )


def _mesh_runs(cfg: ModelConfig, state, n_rows: int, replica: int | None, run) -> list:
    """``run(j, model, rows, device)`` for each data replica of ``state``
    (or replica ``replica`` alone, j = 0): its gathered model (an ``LM``, a
    ``ShardedLM`` under tp), its (first, end) rows and its first
    position's device; the gathered copy is released after each."""
    reps = state.replicas(n_rows)
    out = []
    for j, i in enumerate(range(len(reps)) if replica is None else [replica]):
        r, ps = reps[i]
        model, _ = state.model_for(cfg, i, ps, trainable=False)
        out.append(run(j, model, r, state.devices[ps[0]]))
        del model
        state.release(cfg, i)
    return out


def _join_rows(logits: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    return logits[0] if len(logits) == 1 else C.gather(logits, 0, device)


def _prefill_tp(cfg: ModelConfig, model: ShardedLM, batch: dict, max_len: int | None) -> tuple[torch.Tensor, list]:
    """``prefill`` on a ``ShardedLM``: each shard's heads and caches (an
    SSM layer's its heads' state and its channels' conv window)."""
    dev = model.devices[0]
    tokens = embeds = None
    if "embeds" in batch:
        embeds = torch.as_tensor(batch["embeds"], device=dev).to(cfg.torch_dtype)
        b, s = embeds.shape[:2]
    else:
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        b, s = tokens.shape
    cos, sin = _angles(cfg, _positions(cfg, batch, b, s, dev))
    fresh: list = []
    last = _layers_tp(cfg, model, tokens, None, cos, sin, {"mode": "prefill"}, embeds=embeds, fresh=fresh)
    logits = C.gather([L.lm_logits(cfg, sh.head, sh.embed, h[:, -1]) for sh, h in zip(model.shards, last)], -1, dev)
    caches = []
    for r in range(len(model.shards)):
        per_layer = []
        for layer in fresh:
            if isinstance(layer[r], dict):  # an SSM layer's {"conv", "state"}
                per_layer.append(layer[r])
                continue
            k, v = layer[r]
            if max_len is not None:
                k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, max_len - s)) for t in (k, v))
            per_layer.append({"k": k, "v": v})
        caches.append(_stack_groups(cfg, per_layer))
    return logits, caches


@torch.no_grad()
def prefill(
    cfg: ModelConfig, model, batch: dict, *, max_len: int | None = None, replica: int | None = None
) -> tuple[torch.Tensor, list]:
    """Full-sequence inference pass, the JAX package's ``prefill``: batch
    {"tokens": (B, S)} or {"embeds", "positions"} (tensors or numpy, moved
    to the model's device) -> (logits of the last token (B, V), caches per
    layer group: attention groups' {"k", "v"} (count, B, S, Hk, D), SSM
    groups' {"conv", "state"} (the state after the last token)). With
    ``max_len`` the K/V caches are ``init_cache``'s (count, B, max_len,
    Hk, D), the prompt's K/V in the first S rows and zeros after, so
    ``decode_step`` continues from position S.

    ``model`` may also be a ``ShardedLM`` (each shard's heads, or its query
    rows in the sequence-parallel mode, and its SwiGLU slice, joined as in
    ``prefill_paged``; the caches one list a shard, each with its kv heads
    or its head_dim slice) or a ``training.loop.MeshState``
    (the JAX ``prefill`` on a mesh under fsdp or tp): each data replica
    (``sharding.batch_specs``'s distinct rows) gathers its parameters
    (``MeshState.model_for``) and runs its rows; the caches are one entry a
    replica and the logits are gathered onto the first position's device.
    ``replica=i`` runs replica i alone (the dry-run's count of one
    position, ``launch.dryrun``)."""
    if isinstance(model, ShardedLM):
        return _prefill_tp(cfg, model, batch, max_len)
    if not isinstance(model, LM):
        n = len(next(iter(batch.values())))

        def run(j, m, r, dev):
            return prefill(cfg, m, {k: torch.as_tensor(v)[r[0]:r[1]].to(dev) for k, v in batch.items()},
                           max_len=max_len)

        out = _mesh_runs(cfg, model, n, replica, run)
        return _join_rows([lg for lg, _ in out], model.devices[0]), [c for _, c in out]
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
    cfg: ModelConfig, model, caches: list, tokens: torch.Tensor, pos: int, *, replica: int | None = None
) -> tuple[torch.Tensor, list]:
    """One decode step over contiguous caches, the JAX package's
    ``decode_step``: tokens (B,), every row at position ``pos`` (an int).
    Each attention layer writes its K/V at ``pos`` in place, each SSM
    layer its new conv window and state (the JAX package returns new
    caches). Returns (logits (B, V), caches).

    As ``prefill``, ``model`` may be a ``ShardedLM`` (``caches`` one list a
    shard) or a ``training.loop.MeshState`` (``caches`` one entry a data
    replica run, as ``prefill`` or ``init_mesh_cache`` give them;
    ``replica=i`` runs replica i alone, with its caches)."""
    if isinstance(model, ShardedLM):
        dev = model.devices[0]
        positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.long, device=dev)
        cos, sin = _angles(cfg, _streams(cfg, positions))
        last = _layers_tp(cfg, model, tokens[:, None], caches, cos, sin, {"mode": "decode", "pos": pos})
        logits = C.gather([L.lm_logits(cfg, sh.head, sh.embed, h[:, 0]) for sh, h in zip(model.shards, last)], -1, dev)
        return logits, caches
    if not isinstance(model, LM):
        out = _mesh_runs(cfg, model, len(tokens), replica,
                         lambda j, m, r, dev: decode_step(cfg, m, caches[j], tokens[r[0]:r[1]].to(dev), pos)[0])
        return _join_rows(out, model.devices[0]), caches
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


def _scatter_pages(pool: dict[str, torch.Tensor], fresh: tuple, rows: torch.Tensor) -> None:
    """Write a prefill's fresh (k, v), each (N, S, Hk, D), into the pool
    pages of ``rows`` (N, S // page), in place."""
    n, s = fresh[0].shape[:2]
    for buf, t in ((pool["k"], fresh[0]), (pool["v"], fresh[1])):
        page = buf.shape[1]
        buf[rows] = t.reshape(n, s // page, page, *t.shape[2:]).to(buf.dtype)


def _to_shards(value, devices: list):
    """A step input on every shard's device: a tensor by
    ``collectives.broadcast``, a ``DecodeIndex`` field by field, None and
    Python numbers as they are."""
    if isinstance(value, torch.Tensor):
        return C.broadcast(value, devices)
    if isinstance(value, L.DecodeIndex):
        fields = {f: C.broadcast(getattr(value, f), devices) for f in L.DecodeIndex.__dataclass_fields__}
        return [L.DecodeIndex(**{f: v[r] for f, v in fields.items()}) for r in range(len(devices))]
    return [value] * len(devices)


def _layers_tp(
    cfg: ModelConfig,
    model: ShardedLM,
    tokens: torch.Tensor,
    caches: list,
    cos: torch.Tensor,
    sin: torch.Tensor,
    attn_kw: dict,
    *,
    rows: torch.Tensor | None = None,
    plens: torch.Tensor | None = None,
    embeds: torch.Tensor | None = None,
    fresh: list | None = None,
) -> list[torch.Tensor]:
    """The layers of the inference entry points on a ``ShardedLM``: the
    vocab-sharded embedding of ``tokens`` (or ``embeds`` on every shard),
    then for each layer ``_tp_block``: every shard's SSM heads in an SSM
    layer, else every shard's heads (``attention_heads``, on its
    pools or contiguous caches when ``caches`` is given, its fresh K/V
    scattered into the pools when ``rows`` is given and appended to
    ``fresh``, one list of the shards' (k, v) a layer, when that is a
    list), ``tp_project`` of ``o``, every shard's SwiGLU slice and
    ``tp_project`` of ``down`` (``layers.tp_mlp``) or its experts
    (``moe.apply_moe_tp``); then the final norm. Returns each shard's
    (N, S, d) rows at ``plens - 1`` (the whole rows when ``plens`` is
    None), on its device."""
    devs = model.devices
    if embeds is not None:
        x = C.broadcast(embeds, devs)
    else:
        x = L.embed_tokens_tp([sh.embed for sh in model.shards], C.broadcast(tokens.long(), devs), model.vocab_first)
    cos, sin, rows = C.broadcast(cos, devs), C.broadcast(sin, devs), _to_shards(rows, devs)
    kws = [dict(zip(attn_kw, vals)) for vals in zip(*(_to_shards(v, devs) for v in attn_kw.values()))]
    kinds = [kind for kind, _ in model.shards[0].blocks()]
    layers = [[blk for _, blk in sh.blocks()] for sh in model.shards]
    pools = None if caches is None else [_layer_pools(cfg, c) for c in caches]
    for i in range(len(layers[0])):
        per_layer = [] if fresh is not None else None
        x, _ = _tp_block(cfg, kinds[i], [ls[i] for ls in layers], x, cos, sin, kws,
                         None if pools is None else [p[i] for p in pools], rows, per_layer)
        if fresh is not None:
            fresh.append(per_layer)
    out = [L.rmsnorm(sh.final_norm.scale, a, cfg.norm_eps) for sh, a in zip(model.shards, x)]
    if plens is None:
        return out
    return [a[torch.arange(a.shape[0], device=a.device), p.long() - 1] for a, p in zip(out, C.broadcast(plens, devs))]


def _tp_block(
    cfg: ModelConfig, kind: str, blks: list[Block], x: list, cos: list, sin: list, kws: list,
    pools: list | None = None, rows: list | None = None, fresh: list | None = None,
) -> tuple[list[torch.Tensor], torch.Tensor | None]:
    """One block on every shard. An ``ssm`` block: the pre-norm and
    ``ssm.apply_ssm_tp`` in the mode of ``kws`` ("train", "prefill" with
    each shard's cache appended to ``fresh``, or "decode" on ``pools``,
    each shard's SSM cache row, written in place). A ``dense``,
    ``shared_attn`` or ``moe`` block: its heads
    (``attention_heads`` with its ``kws``, on its ``pools`` with the fresh
    K/V scattered into them at ``rows`` when given, and appended to
    ``fresh`` when it is a list) and ``tp_project`` of ``o``, or, where tp
    does not divide the kv heads, the sequence-parallel attention
    (``layers.attention_seq``: the same pools and fresh K/V, each a
    head_dim slice) and ``o`` on its whole rows; then its SwiGLU slice
    (``layers.tp_mlp``) or its experts (``moe.apply_moe_tp``). Returns each
    shard's residual stream and the block's load-balance loss (None for a
    dense block)."""
    if kind == "ssm":
        hs = [L.rmsnorm(blk.norm.scale, a, cfg.norm_eps) for blk, a in zip(blks, x)]
        y, new = ssm_lib.apply_ssm_tp([blk.ssm for blk in blks], hs, mode=kws[0]["mode"], caches=pools)
        if kws[0]["mode"] == "decode":
            for pool, cache in zip(pools, new):
                for name, t in cache.items():
                    pool[name].copy_(t)
        elif fresh is not None:
            fresh.extend(new)
        return [a + b for a, b in zip(x, y)], None
    hs = [L.rmsnorm(blk.attn_norm.scale, a, cfg.norm_eps) for blk, a in zip(blks, x)]
    seq = L.seq_mode(cfg, len(blks))
    if seq:
        heads, kvs = L.attention_seq(cfg, [blk.attn for blk in blks], hs, cos, sin, kws, pools)
    else:
        heads, kvs = [], []
        proj = L.tp_heads_qkv([blk.attn for blk in blks], hs)
        for r, blk in enumerate(blks):
            o, kv = L.attention_heads(cfg, blk.attn, hs[r], cos[r], sin[r],
                                      cache=None if pools is None else pools[r], proj=proj[r], **kws[r])
            heads.append(o)
            kvs.append(kv)
    for r, kv in enumerate(kvs):
        if rows is not None and rows[r] is not None:
            _scatter_pages(pools[r], kv, rows[r])
        if fresh is not None:
            fresh.append(kv)
    y = L.tp_project([blk.attn.wo for blk in blks], heads, whole=seq)
    x = [a + b for a, b in zip(x, y)]
    h = [L.rmsnorm(blk.mlp_norm.scale, a, cfg.norm_eps) for blk, a in zip(blks, x)]
    lb = None
    if kind == "moe":
        y, lb = moe_lib.apply_moe_tp([blk.moe for blk in blks], h)
    else:
        y = L.tp_mlp([blk.mlp for blk in blks], h)
    return [a + b for a, b in zip(x, y)], lb


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

    With a ``ShardedLM``, ``caches`` holds one list of pools a shard and
    the inputs lie on the first shard's device (module docstring).
    """
    n, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(n, s)
    mode = "prefill"
    if prefix_lens is not None:
        mode = "prefill_prefix"
        positions = prefix_lens.long()[:, None] + positions
    cos, sin = _angles(cfg, _streams(cfg, positions))
    rows = page_rows.long()
    attn_kw = {"mode": mode, "pos": prefix_lens, "prefix_rows": prefix_rows}
    if isinstance(model, ShardedLM):
        last = _layers_tp(cfg, model, tokens, caches, cos, sin, attn_kw, rows=rows, plens=plens)
        logits = C.gather(
            [L.lm_logits(cfg, sh.head, sh.embed, h) for sh, h in zip(model.shards, last)], -1, tokens.device
        )
    else:
        x = L.embed_tokens(model.embed, tokens.long())
        for (kind, blk), pool in zip(model.blocks(), _layer_pools(cfg, caches)):
            x, fresh, _ = _attn_block(cfg, kind, blk, x, cos, sin, cache=pool, **attn_kw)
            _scatter_pages(pool, fresh, rows)
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
    sample_decode``): (token ids (B,), caches, presence). With a
    ``ShardedLM``, ``caches`` holds one list of pools a shard (module
    docstring)."""
    pos = positions.to(torch.int32).contiguous()
    sharded = isinstance(model, ShardedLM)
    page = (caches[0][0] if sharded else caches[0])["k"].shape[2]
    index = L.decode_index(cfg, page_table, pos, page)
    cos, sin = _angles(cfg, _streams(cfg, pos.long()[:, None]))
    attn_kw = {"mode": "decode_paged", "index": index, "pos": pos}
    if sharded:
        last = _layers_tp(cfg, model, tokens[:, None], caches, cos, sin, attn_kw)
        logits = C.gather(
            [L.lm_logits(cfg, sh.head, sh.embed, h[:, 0]) for sh, h in zip(model.shards, last)], -1, pos.device
        )
    else:
        x = L.embed_tokens(model.embed, tokens.long()[:, None])
        for (kind, blk), pool in zip(model.blocks(), _layer_pools(cfg, caches)):
            x, _, _ = _attn_block(cfg, kind, blk, x, cos, sin, cache=pool, **attn_kw)
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
    cfg: ModelConfig, model: LM | ShardedLM, batch: dict, *, count: torch.Tensor | float | None = None
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
    losses (0 for the other families). ``count``: the mean's denominator
    in place of this batch's count of ``labels >= 0`` (a mesh position's
    rows are a part of the global batch, whose count divides each part's
    sum, so the parts' losses add up to the global mean).

    With ``cfg.remat`` each layer runs under non-reentrant activation
    checkpointing: the backward keeps one residual per layer and runs the
    layer's forward again. The reference checkpoints in two levels (an
    outer checkpoint over about sqrt(n) layers); one level keeps 28 rather
    than 7 + 4 residuals of (B, S, d_model) at full width and does not run
    every layer's forward a third time.

    A ``ShardedLM`` (``build_shards(..., trainable=True)``: attention in the
    heads mode, or in the sequence-parallel mode where tp does not divide
    the kv heads; the MoE family's experts on the model axis) runs the
    tensor-parallel forward: the vocab-sharded embedding (or the embeds on
    every shard), each layer's ``_tp_block`` (the MoE layers' load-balance
    losses summed, each taken once), then a vocab-sharded cross-entropy. Each
    shard takes its rows' fp32 logits over its vocabulary slice, their
    logsumexp and the gold logit (zero outside its slice); ``logz`` is the
    log-sum-exp of the shards' values and ``gold`` their sum, taken in rank
    order on the first shard's device, so no device holds the whole (B, S, V)
    logits.
    """
    if isinstance(model, ShardedLM):
        return _forward_train_tp(cfg, model, batch, count)
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
    denom = mask.sum().clamp(min=1.0) if count is None else torch.as_tensor(count, device=dev)
    nll = ((logz - gold) * mask).sum() / denom
    return nll + 0.01 * lb, {"nll": nll, "lb_loss": lb}


def _tp_train_layer(
    cfg: ModelConfig, kind: str, blks: list[Block], x: list, cos: list, sin: list
) -> tuple[list[torch.Tensor], torch.Tensor]:
    x, lb = _tp_block(cfg, kind, blks, x, cos, sin, [{"mode": "train"}] * len(blks))
    return x, torch.zeros((), device=x[0].device) if lb is None else lb


def _forward_train_tp(
    cfg: ModelConfig, model: ShardedLM, batch: dict, count
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``forward_train`` on a ``ShardedLM`` (its docstring)."""
    devs = model.devices
    dev = devs[0]
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    if "embeds" in batch:
        x = C.broadcast(torch.as_tensor(batch["embeds"], device=dev).to(cfg.torch_dtype), devs)
    else:
        toks = C.broadcast(torch.as_tensor(batch["tokens"], device=dev).long(), devs)
        x = L.embed_tokens_tp([sh.embed for sh in model.shards], toks, model.vocab_first)
    b, s = labels.shape
    cos, sin = _angles(cfg, _positions(cfg, batch, b, s, dev))
    cos, sin = C.broadcast(cos, devs), C.broadcast(sin, devs)
    kinds = [kind for kind, _ in model.shards[0].blocks()]
    layers = [[blk for _, blk in sh.blocks()] for sh in model.shards]
    lb = torch.zeros((), device=dev)
    for i in range(len(layers[0])):
        blks = [ls[i] for ls in layers]
        if cfg.remat:
            x, lb_i = checkpoint(_tp_train_layer, cfg, kinds[i], blks, x, cos, sin, use_reentrant=False)
        else:
            x, lb_i = _tp_train_layer(cfg, kinds[i], blks, x, cos, sin)
        lb = lb + lb_i.to(dev)
    logz, gold = [], []
    for sh, h, lab, lo in zip(model.shards, x, C.broadcast(labels, devs), model.vocab_first):
        logits = L.lm_logits(cfg, sh.head, sh.embed, L.rmsnorm(sh.final_norm.scale, h, cfg.norm_eps))
        vocab = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
        logz.append(torch.logsumexp(logits, dim=-1).to(dev))
        gold.append(torch.where(vocab == lab[..., None], logits, 0.0).sum(dim=-1).to(dev))
    top = logz[0].detach()
    for z in logz[1:]:
        top = torch.maximum(top, z.detach())
    total, g = torch.exp(logz[0] - top), gold[0]
    for z, gg in zip(logz[1:], gold[1:]):
        total, g = total + torch.exp(z - top), g + gg
    mask = (labels >= 0).float()
    denom = mask.sum().clamp(min=1.0) if count is None else torch.as_tensor(count, device=dev)
    nll = ((top + torch.log(total) - g) * mask).sum() / denom
    return nll + 0.01 * lb, {"nll": nll, "lb_loss": lb}
