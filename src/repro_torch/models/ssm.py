"""Mamba2 (SSD, state-space duality) block of the port, the counterpart of
the JAX package's ``models/ssm.py``.

The chunked SSD for training and prefill (quadratic within a chunk, a
recurrence across chunks, here a Python loop over the chunks) and the
one-token recurrent step for decode. ``in_proj`` and ``out_proj`` are the
block's GEMMs: pixelfly when the model is sparse and both widths are
multiples of the config's block (so ``in_proj``, 3352 or 10448 wide, stays
dense), through ``core.pixelfly.Linear`` and its kernel. The scan itself is
plain torch, as in the reference, which has no kernel for it; it runs
inside the profiler range ``ssd_scan``. ``apply_ssm_tp`` runs the mixer on
tensor-parallel shards by heads, each shard's decode cache its heads'
state and its channels' conv window.

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
from repro_torch.distributed import collectives
from repro_torch.models import layers as L

__all__ = [
    "SsmSpec", "Ssm", "segsum", "ssd_chunked", "causal_conv", "gated_norm",
    "apply_ssm_train", "init_ssm_cache", "apply_ssm_decode", "apply_ssm_tp",
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


def _gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return y.float() * F.silu(z.float())


def gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor, eps: float) -> torch.Tensor:
    yf = _gate(y, z)
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _split(spec: SsmSpec, zxbcdt: torch.Tensor):
    di = spec.d_inner
    return zxbcdt[..., :di], zxbcdt[..., di : di + spec.conv_dim], zxbcdt[..., di + spec.conv_dim :]


def _scan(
    c: ModelConfig, xbc_pre: torch.Tensor, dt: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    A_log: torch.Tensor, D: torch.Tensor, dt_bias: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixer between ``in_proj`` and the gated norm over a whole
    sequence, on the heads that ``A_log``, ``D`` and ``dt_bias`` hold:
    ``xbc_pre`` (B, S, their x channels + B and C), ``dt`` (B, S, their
    heads), the conv taps and bias of those channels. Returns (y (B, S,
    x channels) in the input dtype, the final state (B, heads, P, N))."""
    b, s, _ = xbc_pre.shape
    h, p, n = A_log.shape[0], c.ssm_head_dim, c.ssm_state
    xbc = causal_conv(xbc_pre, w, bias)
    xbc = F.silu(xbc.float()).to(xbc_pre.dtype)
    xs = xbc[..., : h * p].reshape(b, s, h, p)
    Bm = xbc[..., h * p : h * p + n]
    Cm = xbc[..., h * p + n :]
    dtf = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    with torch.profiler.record_function("ssd_scan"):
        y, final = ssd_chunked(xs, dtf, A, Bm, Cm, c.ssm_chunk)
    y = y + D[None, None, :, None] * xs.float()
    return y.reshape(b, s, h * p).to(xbc_pre.dtype), final


def _step(
    c: ModelConfig, xbc: torch.Tensor, dt: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    A_log: torch.Tensor, D: torch.Tensor, dt_bias: torch.Tensor, cache: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``_scan``'s one-token recurrent step: ``xbc`` (B, 1, channels) and
    ``dt`` (B, 1, heads) against ``cache`` ({"conv": the last K-1 pre-conv
    rows of those channels, "state": (B, heads, P, N)}). Returns (y (B, 1,
    x channels), the new cache)."""
    b = xbc.shape[0]
    h, p, n = A_log.shape[0], c.ssm_head_dim, c.ssm_state
    window = torch.cat([cache["conv"], xbc], dim=1)  # (B, K, C)
    # the taps summed in fp32 and rounded once, as an einsum over them
    y = (window.float() * w.float()).sum(dim=1).to(xbc.dtype) + bias
    xbc1 = F.silu(y.float()).to(xbc.dtype)
    xs = xbc1[:, : h * p].reshape(b, h, p).float()
    Bm = xbc1[:, h * p : h * p + n].float()
    Cm = xbc1[:, h * p + n :].float()
    dtf = F.softplus(dt[:, 0].float() + dt_bias)  # (B, H)
    A = -torch.exp(A_log)
    dA = torch.exp(dtf * A)
    dBx = (dtf[:, :, None] * xs)[..., None] * Bm[:, None, None, :]  # (B, H, P, N)
    state = cache["state"] * dA[..., None, None] + dBx
    yh = torch.einsum("bhpn,bn->bhp", state, Cm)
    yh = yh + D[None, :, None] * xs
    return yh.reshape(b, 1, h * p).to(xbc.dtype), {"conv": window[:, 1:], "state": state}


def apply_ssm_train(
    ssm: Ssm, x: torch.Tensor, *, return_state: bool = False
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Full-sequence forward, x (B, S, D) -> (y, cache or None); the cache
    ``{"conv": the last K-1 pre-conv rows, "state": the final SSD state}``
    continues the sequence in ``apply_ssm_decode``."""
    c = ssm.spec.cfg
    z, xbc_pre, dt = _split(ssm.spec, ssm.in_proj(x))
    y, final = _scan(c, xbc_pre, dt, ssm.conv_w, ssm.conv_b, ssm.A_log, ssm.D, ssm.dt_bias)
    out = ssm.out_proj(gated_norm(ssm.norm, y, z, c.norm_eps))
    cache = None
    if return_state:
        cache = {"conv": xbc_pre[:, -(c.ssm_conv - 1) :], "state": final}
    return out, cache


def init_ssm_cache(
    cfg: ModelConfig, batch: int, *, device: torch.device, count: int | None = None, tp: int = 1
) -> dict[str, torch.Tensor]:
    """Zero ``conv`` (B, K-1, conv_dim) in the model dtype and fp32
    ``state`` (B, H, P, N), with a leading ``count`` axis if given. With
    ``tp`` > 1, one shard's of ``apply_ssm_tp``: the conv window of its
    d_inner/tp x channels and of B and C, and the state of its H/tp heads."""
    spec = SsmSpec(cfg)
    lead = () if count is None else (count,)
    width = spec.conv_dim - spec.d_inner + spec.d_inner // tp
    return {
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, width), dtype=cfg.torch_dtype, device=device),
        "state": torch.zeros((*lead, batch, spec.heads // tp, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }


def apply_ssm_decode(
    ssm: Ssm, x: torch.Tensor, cache: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token per row, x (B, 1, D) -> (y (B, 1, D), the new cache)."""
    c = ssm.spec.cfg
    z, xbc, dt = _split(ssm.spec, ssm.in_proj(x))
    y, new = _step(c, xbc, dt, ssm.conv_w, ssm.conv_b, ssm.A_log, ssm.D, ssm.dt_bias, cache)
    return ssm.out_proj(gated_norm(ssm.norm, y, z, c.norm_eps)), new


def _whole(parts: list[torch.Tensor], dim: int, size: int) -> list[torch.Tensor]:
    """Each shard's slice of a tensor joined whole on every shard (an
    all-gather along ``dim``), or the shards' own where they hold it
    whole."""
    if parts[0].shape[dim] == size:
        return parts
    return collectives.all_gather(parts, dim=dim)


def _head_params(ssm: Ssm, r: int, hl: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shard r's slices of the per-head ``A_log``, ``D`` and ``dt_bias``:
    heads [r·hl, (r+1)·hl)."""
    hs = slice(r * hl, (r + 1) * hl)
    return ssm.A_log[hs], ssm.D[hs], ssm.dt_bias[hs]


def _mean_squares(yfs: list[torch.Tensor], width: int) -> list[torch.Tensor]:
    """The gated norm's mean square of each row over all ``width`` channels
    of d_inner, on every shard: each shard's sum of squares over its
    channels, all-reduced in rank order (fp32)."""
    sums = collectives.all_reduce([(yf * yf).sum(dim=-1, keepdim=True) for yf in yfs])
    return [t / width for t in sums]


def apply_ssm_tp(
    ssms: list[Ssm], xs: list[torch.Tensor], *, mode: str, caches: list | None = None
) -> tuple[list[torch.Tensor], list | None]:
    """The Mamba2 mixer on ``tp`` shards, by heads (``sharding.check_tp``:
    tp divides the heads, one group of B and C), in the style of
    ``layers.attention_seq``. Returns (each shard's whole output (B, S,
    d_model), each shard's cache or None).

    Every shard joins the whole z, xBC and dt from the shards' columns of
    ``in_proj`` (``layers.tp_whole``; a dense ``in_proj`` is cut evenly on
    its output features, across the z | xBC | dt boundaries), and
    ``conv_w`` (cut on its channels) and ``conv_b`` whole. Shard r takes its
    H/tp heads [r·H/tp, (r+1)·H/tp): its z, x and dt channels, its slices
    of ``A_log``, ``D``, ``dt_bias`` (``_head_params``) and ``norm``, and
    the whole B and C; it runs the causal conv on its x channels and on B
    and C, then the SSD on its heads. The gated norm's mean square is over
    the whole d_inner (``_mean_squares``), and ``out_proj`` is
    ``layers.tp_project`` of the shards' channels, as ``o`` and ``down``.
    Every join is differentiable, so a replicated per-head tensor gets from
    each shard the gradient of its slice alone (zero elsewhere), and their
    sum over the shards is the whole gradient.

    Modes: ``train``; ``prefill``, which also returns each shard's cache
    (its channels' last K-1 pre-conv rows, its heads' final state);
    ``decode``, one token a row against ``caches``, each shard's
    ``init_ssm_cache(..., tp=tp)`` row, returning the new caches for the
    caller to write in place. Any other mode raises ``ValueError``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown SSM mode {mode!r}")
    spec = ssms[0].spec
    c = spec.cfg
    tp = len(ssms)
    di, cd = spec.d_inner, spec.conv_dim
    hl, dl = spec.heads // tp, di // tp
    zxbcdts = L.tp_whole([m.in_proj for m in ssms], xs)
    ws = _whole([m.conv_w for m in ssms], 1, cd)
    bs = _whole([m.conv_b for m in ssms], 0, cd)
    yfs, new = [], []
    for r, (ssm, zxbcdt, w, bias) in enumerate(zip(ssms, zxbcdts, ws, bs)):
        xr = slice(di + r * dl, di + (r + 1) * dl)
        xbc = torch.cat([zxbcdt[..., xr], zxbcdt[..., 2 * di : di + cd]], dim=-1)
        wr = torch.cat([w[:, r * dl : (r + 1) * dl], w[:, di:]], dim=1)
        br = torch.cat([bias[r * dl : (r + 1) * dl], bias[di:]])
        dt = zxbcdt[..., di + cd + r * hl : di + cd + (r + 1) * hl]
        heads = _head_params(ssm, r, hl)
        if mode == "decode":
            y, cache = _step(c, xbc, dt, wr, br, *heads, caches[r])
        else:
            y, final = _scan(c, xbc, dt, wr, br, *heads)
            cache = {"conv": xbc[:, -(c.ssm_conv - 1) :], "state": final} if mode == "prefill" else None
        new.append(cache)
        yfs.append(_gate(y, zxbcdt[..., r * dl : (r + 1) * dl]))
    eps = c.norm_eps
    normed = [(yf * torch.rsqrt(ms + eps) * m.norm[r * dl : (r + 1) * dl]).to(x.dtype)
              for r, (yf, ms, m, x) in enumerate(zip(yfs, _mean_squares(yfs, di), ssms, xs))]
    out = L.tp_project([m.out_proj for m in ssms], normed)
    return out, None if mode == "train" else new
