"""ViT and MLP-Mixer, the paper's own base models (§5.1), with pixelfly
linears: the port of the JAX package's ``models/vision.py``.

The input is a batch of flattened patches (B, num_patches, patch_dim), as
in the JAX package (no patchifier). Parameters carry the JAX tree's names
(``patch``, ``pos``, ``cls``, ``head``, ``final_norm``,
``layers.{i}.{n1,qkv,proj,n2,mlp.w1,mlp.w2}``; the Mixer's
``layers.{i}.{n1,token_mlp,n2,chan_mlp}``), so
``bridge.vision_params_from_jax`` loads a JAX tree as it is. A linear is
pixelfly only where both its features divide ``sparse_block``
(``VisionConfig.lin``), so the Mixer's 196-token MLP stays dense; every
sparse linear's ``B`` term is ``kernels.autograd.BsrMatmul`` (the
``bsr_matmul`` kernel on the card). Attention is plain ``einsum`` with an
fp32 softmax, as the JAX package computes it outside any Pallas kernel.
The rounding points follow the JAX package: the GELU (tanh form, JAX's
default) runs in fp32 and is cast back, the logits are cast to fp32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.pixelfly import Linear, LinearSpec
from repro_torch.models.layers import RMSNorm, rmsnorm
from repro_torch.models.transformer import resolve_device

__all__ = ["VisionConfig", "Mlp", "ViT", "Mixer", "init_vision", "param_count"]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    kind: str  # "vit" | "mixer"
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    num_patches: int
    num_classes: int
    patch_dim: int  # flattened patch pixels
    token_ff: int = 0  # the Mixer's token-mixing hidden width (0: d_ff // 2)
    sparse: bool = False
    sparse_density: float = 0.25
    sparse_block: int = 32
    lowrank_frac: float = 0.25
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def token_hidden(self) -> int:
        return self.token_ff or self.d_ff // 2

    def lin(self, din: int, dout: int) -> LinearSpec:
        """Pixelfly when sparse and both features divide ``sparse_block``
        (never a halved block, unlike ``LinearSpec.pixelfly`` alone), else
        dense."""
        if self.sparse and din % self.sparse_block == 0 and dout % self.sparse_block == 0:
            return LinearSpec.pixelfly(
                din, dout, self.sparse_density, block=self.sparse_block,
                lowrank_frac=self.lowrank_frac, dtype=self.torch_dtype,
            )
        return LinearSpec.dense(din, dout, dtype=self.torch_dtype)


class Mlp(nn.Module):
    """w2(gelu(w1 x)), the GELU in fp32 (tanh form) and cast back."""

    def __init__(self, cfg: VisionConfig, din: int, dff: int, dout: int, *,
                 gen: torch.Generator, device: torch.device):
        super().__init__()
        self.w1 = Linear(cfg.lin(din, dff), gen=gen, device=device)
        self.w2 = Linear(cfg.lin(dff, dout), gen=gen, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.w1(x)
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return self.w2(h)


def _dense(din: int, dout: int, cfg: VisionConfig, gen, device) -> Linear:
    return Linear(LinearSpec.dense(din, dout, dtype=cfg.torch_dtype), gen=gen, device=device)


class ViTLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        d = cfg.d_model
        self.n1 = RMSNorm(d, device=device)
        self.qkv = Linear(cfg.lin(d, 3 * d), gen=gen, device=device)
        self.proj = Linear(cfg.lin(d, d), gen=gen, device=device)
        self.n2 = RMSNorm(d, device=device)
        self.mlp = Mlp(cfg, d, cfg.d_ff, d, gen=gen, device=device)


class ViT(nn.Module):
    """patches (B, num_patches, patch_dim) -> logits (B, num_classes) fp32,
    from the cls token."""

    def __init__(self, cfg: VisionConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.torch_dtype
        self.patch = _dense(cfg.patch_dim, d, cfg, gen, device)
        self.pos = nn.Parameter(
            (torch.randn((cfg.num_patches + 1, d), generator=gen) * 0.02).to(device, dt))
        self.cls = nn.Parameter(torch.zeros((d,), dtype=dt, device=device))
        self.layers = nn.ModuleList(ViTLayer(cfg, gen=gen, device=device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(d, device=device)
        # a zero head (ViT practice): the logits start at 0
        self.head = _dense(d, cfg.num_classes, cfg, gen, device)
        with torch.no_grad():
            self.head.w.zero_()

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, d, h = patches.shape[0], cfg.d_model, cfg.num_heads
        hd = d // h
        x = self.patch(patches.to(cfg.torch_dtype))
        x = torch.cat([self.cls.expand(b, 1, d), x], dim=1) + self.pos[None]
        s = x.shape[1]
        for p in self.layers:
            q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2)
                       for t in p.qkv(rmsnorm(p.n1.scale, x)).split(d, dim=-1))
            att = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5
            att = torch.softmax(att.float(), dim=-1).to(x.dtype)
            o = torch.einsum("bhqk,bhkd->bhqd", att, v).transpose(1, 2).reshape(b, s, d)
            x = x + p.proj(o)
            x = x + p.mlp(rmsnorm(p.n2.scale, x))
        x = rmsnorm(self.final_norm.scale, x)
        return self.head(x[:, 0]).float()


class MixerLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        d, s = cfg.d_model, cfg.num_patches
        self.n1 = RMSNorm(d, device=device)
        self.token_mlp = Mlp(cfg, s, cfg.token_hidden, s, gen=gen, device=device)
        self.n2 = RMSNorm(d, device=device)
        self.chan_mlp = Mlp(cfg, d, cfg.d_ff, d, gen=gen, device=device)


class Mixer(nn.Module):
    """patches (B, num_patches, patch_dim) -> logits (B, num_classes) fp32,
    from the mean over the patches."""

    def __init__(self, cfg: VisionConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.patch = _dense(cfg.patch_dim, d, cfg, gen, device)
        self.layers = nn.ModuleList(MixerLayer(cfg, gen=gen, device=device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(d, device=device)
        self.head = _dense(d, cfg.num_classes, cfg, gen, device)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = self.patch(patches.to(self.cfg.torch_dtype))
        for p in self.layers:
            # token mixing on (B, D, S), made contiguous for the BSR kernel
            y = p.token_mlp(rmsnorm(p.n1.scale, x).transpose(1, 2).contiguous())
            x = x + y.transpose(1, 2)
            x = x + p.chan_mlp(rmsnorm(p.n2.scale, x))
        x = rmsnorm(self.final_norm.scale, x)
        return self.head(x.mean(dim=1)).float()


def init_vision(
    cfg: VisionConfig,
    *,
    seed: int = 0,
    device: str | torch.device | None = None,
    params: dict[str, torch.Tensor] | None = None,
) -> ViT | Mixer:
    """The ViT or Mixer of ``cfg``: random weights from a CPU generator
    seeded with ``seed`` (the same on every device), or ``params`` (a state
    dict, e.g. from ``bridge.vision_params_from_jax``), on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    cls = {"vit": ViT, "mixer": Mixer}[cfg.kind]
    model = cls(cfg, gen=torch.Generator().manual_seed(seed), device=dev)
    if params is not None:
        like = model.state_dict()
        model.load_state_dict({k: v.to(dev, like[k].dtype) for k, v in params.items()}, strict=True)
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
