"""Mamba2 (SSD, state-space duality) block of the port, the counterpart of
the JAX package's ``models/ssm.py``.

The chunked SSD for training and prefill (quadratic within a chunk, a
recurrence across chunks, here a Python loop over the chunks) and the
one-token recurrent step for decode. ``in_proj`` and ``out_proj`` are the
block's GEMMs: pixelfly when the model is sparse and both widths are
multiples of the config's block (so ``in_proj``, 3352 or 10448 wide, stays
dense), through ``core.pixelfly.Linear`` and its kernel. The scan itself is
plain torch, as in the reference, which has no kernel for it; it runs
inside the profiler range ``ssd_scan``.

Every three-operand product of the reference is two explicit steps here,
in a fixed order, and the causal mask is applied before the ``exp`` (a
mask after it would put ``inf * 0`` into the backward).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pixelfly import Linear, LinearSpec

__all__ = [
    "SsmSpec", "Ssm", "segsum", "ssd_chunked", "causal_conv", "gated_norm",
    "apply_ssm_train", "init_ssm_cache", "apply_ssm_decode",
]


@dataclasses.dataclass(frozen=True)
class SsmSpec:
    cfg: ModelConfig

    @property
    def d_inner(self) -> int:
        return self.cfg.d_inner

    @property
    def heads(self) -> int:
        return self.cfg.ssm_heads

    @property
    def conv_dim(self) -> int:
        c = self.cfg
        return self.d_inner + 2 * c.ssm_groups * c.ssm_state

    @property
    def in_dim(self) -> int:
        # z, xBC, dt
        return 2 * self.d_inner + 2 * self.cfg.ssm_groups * self.cfg.ssm_state + self.heads

    def _lin(self, din: int, dout: int) -> LinearSpec:
        c = self.cfg
        if c.sparse and din % c.sparse_block == 0 and dout % c.sparse_block == 0:
            return LinearSpec.pixelfly(
                din, dout, c.sparse_density, block=c.sparse_block,
                lowrank_frac=c.lowrank_frac, dtype=c.torch_dtype,
            )
        return LinearSpec.dense(din, dout, dtype=c.torch_dtype)

    @property
    def in_proj(self) -> LinearSpec:
        return self._lin(self.cfg.d_model, self.in_dim)

    @property
    def out_proj(self) -> LinearSpec:
        return self._lin(self.d_inner, self.cfg.d_model)


class Ssm(nn.Module):
    """The Mamba2 mixer's parameters under the reference's names:
    ``in_proj``/``out_proj`` linears, the depthwise ``conv_w`` (K, C) and
    ``conv_b``, and the fp32 ``A_log``, ``D``, ``dt_bias`` (one a head) and
    the gated norm's ``norm`` (d_inner)."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator, device: torch.device):
        super().__init__()
        self.spec = spec = SsmSpec(cfg)
        h = spec.heads
        self.in_proj = Linear(spec.in_proj, gen=gen, device=device)
        self.out_proj = Linear(spec.out_proj, gen=gen, device=device)
        conv = torch.randn((cfg.ssm_conv, spec.conv_dim), generator=gen) / math.sqrt(cfg.ssm_conv)
        self.conv_w = nn.Parameter(conv.to(cfg.torch_dtype).to(device))
        self.conv_b = nn.Parameter(torch.zeros((spec.conv_dim,), dtype=cfg.torch_dtype, device=device))
        self.A_log = nn.Parameter(torch.log(torch.arange(1, h + 1, dtype=torch.float32)).to(device))
        self.D = nn.Parameter(torch.ones((h,), dtype=torch.float32, device=device))
        u = torch.rand((h,), generator=gen)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        self.dt_bias = nn.Parameter((dt + torch.log(-torch.expm1(-dt))).to(device))  # inverse softplus
        self.norm = nn.Parameter(torch.ones((spec.d_inner,), dtype=torch.float32, device=device))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L): out[i, j] = sum_{j<k<=i} x[k], -inf above
    the diagonal (masked before any exp)."""
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD: y_t = C_t . (sum_{s<=t} prod(decay) dt_s B_s x_s), the
    reference's ``_ssd_chunked``. x (B, S, H, P); dt (B, S, H) fp32 after
    softplus; A (H,) fp32, negative; Bm, Cm (B, S, N). S is padded with
    dt = 0 to a whole chunk (exact: the decay is 1 and the input 0).
    Returns (y (B, S, H, P) fp32, final state (B, H, P, N) fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    c = (s + pad) // chunk
    xc = (x * dt[..., None]).reshape(b, c, chunk, h, p).float()
    dA = (dt * A[None, None, :]).reshape(b, c, chunk, h)
    Bc = Bm.reshape(b, c, chunk, n).float()
    Cc = Cm.reshape(b, c, chunk, n).float()
    dA_cs = torch.cumsum(dA, dim=2)  # (b, c, l, h)

    # intra-chunk (block-diagonal) term
    Lm = torch.exp(segsum(dA.transpose(2, 3)))  # (b, c, h, l, l)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", Lm * scores[:, :, None], xc)

    # chunk-final states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b, c, l, h)
    states = torch.einsum("bclhp,bcln->bchpn", xc * decay_states[..., None], Bc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (b, c, h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(c):
        prev.append(state)
        state = state * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (b, c, h, p, n)

    # inter-chunk output term
    state_decay = torch.exp(dA_cs)  # (b, c, l, h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, c * chunk, h, p)
    return y[:, :s], state


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B, S, C), w (K, C), taps summed in order."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i : i + s] * w[i]
    return y + bias


def gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor, eps: float) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _split(spec: SsmSpec, zxbcdt: torch.Tensor):
    di = spec.d_inner
    return zxbcdt[..., :di], zxbcdt[..., di : di + spec.conv_dim], zxbcdt[..., di + spec.conv_dim :]


def apply_ssm_train(
    ssm: Ssm, x: torch.Tensor, *, return_state: bool = False
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Full-sequence forward, x (B, S, D) -> (y, cache or None); the cache
    ``{"conv": the last K-1 pre-conv rows, "state": the final SSD state}``
    continues the sequence in ``apply_ssm_decode``."""
    spec = ssm.spec
    c = spec.cfg
    b, s, _ = x.shape
    h, p, n, di = spec.heads, c.ssm_head_dim, c.ssm_state, spec.d_inner
    z, xbc_pre, dt = _split(spec, ssm.in_proj(x))
    xbc = causal_conv(xbc_pre, ssm.conv_w, ssm.conv_b)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs = xbc[..., :di].reshape(b, s, h, p)
    Bm = xbc[..., di : di + n]
    Cm = xbc[..., di + n :]
    dtf = F.softplus(dt.float() + ssm.dt_bias)
    A = -torch.exp(ssm.A_log)
    with torch.profiler.record_function("ssd_scan"):
        y, final = ssd_chunked(xs, dtf, A, Bm, Cm, c.ssm_chunk)
    y = y + ssm.D[None, None, :, None] * xs.float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = gated_norm(ssm.norm, y, z, c.norm_eps)
    out = ssm.out_proj(y)
    cache = None
    if return_state:
        cache = {"conv": xbc_pre[:, -(c.ssm_conv - 1) :], "state": final}
    return out, cache


def init_ssm_cache(
    cfg: ModelConfig, batch: int, *, device: torch.device, count: int | None = None
) -> dict[str, torch.Tensor]:
    """Zero ``conv`` (B, K-1, conv_dim) in the model dtype and fp32
    ``state`` (B, H, P, N), with a leading ``count`` axis if given."""
    spec = SsmSpec(cfg)
    lead = () if count is None else (count,)
    return {
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, spec.conv_dim), dtype=cfg.torch_dtype, device=device),
        "state": torch.zeros((*lead, batch, spec.heads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }


def apply_ssm_decode(
    ssm: Ssm, x: torch.Tensor, cache: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token per row, x (B, 1, D) -> (y (B, 1, D), the new cache)."""
    spec = ssm.spec
    c = spec.cfg
    b = x.shape[0]
    h, p, n, di = spec.heads, c.ssm_head_dim, c.ssm_state, spec.d_inner
    z, xbc, dt = _split(spec, ssm.in_proj(x))
    window = torch.cat([cache["conv"], xbc], dim=1)  # (B, K, C)
    # the taps summed in fp32 and rounded once, as an einsum over them
    y = (window.float() * ssm.conv_w.float()).sum(dim=1).to(x.dtype) + ssm.conv_b
    xbc1 = F.silu(y.float()).to(x.dtype)
    xs = xbc1[:, :di].reshape(b, h, p).float()
    Bm = xbc1[:, di : di + n].float()
    Cm = xbc1[:, di + n :].float()
    dtf = F.softplus(dt[:, 0].float() + ssm.dt_bias)  # (B, H)
    A = -torch.exp(ssm.A_log)
    dA = torch.exp(dtf * A)
    dBx = (dtf[:, :, None] * xs)[..., None] * Bm[:, None, None, :]  # (B, H, P, N)
    state = cache["state"] * dA[..., None, None] + dBx
    yh = torch.einsum("bhpn,bn->bhp", state, Cm)
    yh = yh + ssm.D[None, :, None] * xs
    yh = yh.reshape(b, 1, di).to(x.dtype)
    yh = gated_norm(ssm.norm, yh, z, c.norm_eps)
    return ssm.out_proj(yh), {"conv": window[:, 1:], "state": state}
