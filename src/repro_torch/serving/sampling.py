"""Per-request batched sampling on the device, the port of the JAX
package's ``serving/sampling.py``.

``SamplingParams`` rides on each ``Request``; the engine packs the active
slots' params into ``(slots,)``-shaped device tensors and the sampler runs
on the device inside ``prefill_paged`` / ``decode_step_paged``
(``sample_prefill`` / ``sample_decode`` below), so a sampled step costs the
same single host fetch as the greedy one: the step returns the chosen
token ids, never the ``(slots, V)`` logits. Nothing here reads a device
value on the host.

Determinism: every request's noise stream is derived from its own seed,
``fold_in(key(seed), sample_idx)``, where ``sample_idx`` counts the tokens
the request has emitted (0 = the prefill-emitted first token). Neither the
slot, the step nor the batch enters the derivation, so the same seed gives
the same tokens under any admission order, slot reuse or bucket
composition.

The noise is bit for bit the JAX package's: ``threefry2x32``,
``fold_in`` and the 32-bit random bits of jax 0.9.0's partitionable
threefry mode (``jax_threefry_partitionable = True``), mapped to uniforms
and to Gumbel noise in its "low" mode (``-log(-log(u))``,
``jax_high_dynamic_range_gumbel = False``). The 32-bit arithmetic is done
in int64 masked to 32 bits after every add and rotate, because torch's
``uint32`` has partial operator support and ``>>`` on int32 is
arithmetic.

Filtering follows the standard serving convention (temperature, then
top-k, then top-p on the renormalised mass), with an HF-style repetition
penalty over the tokens the sequence has already seen (prompt +
generated, tracked in a device-resident ``(slots, V+1)`` presence buffer
whose last column absorbs padding scatters). Candidates are ordered by
value descending and, among equal values, by token id ascending, the
order of ``lax.top_k``: a stable descending sort gives it on every device.
``temperature == 0`` takes the exact argmax of the (penalised) logits.

``reference_sample`` is the host-side numpy oracle for one row: the same
key derivation and noise (from this module's threefry), independent
filtering and argmax code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "SamplingParams",
    "GREEDY",
    "base_key_data",
    "threefry2x32",
    "fold_in",
    "random_bits",
    "gumbel",
    "sample_logits",
    "sample_decode",
    "sample_prefill",
    "reference_sample",
]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs. Defaults are exact greedy.

    temperature: 0 -> greedy argmax; > 0 -> softmax sampling.
    top_k: keep only the k highest logits (0 -> disabled).
    top_p: keep the smallest prefix of the sorted distribution whose
        mass reaches p (1.0 -> disabled).
    repetition_penalty: HF-style penalty (> 1 discourages) applied to
        every token already in the sequence (prompt + generated).
    seed: PRNG seed for this request's noise stream; two requests with
        the same seed draw identical noise.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not 0 < self.top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        if not 0 <= self.seed < 2**63:
            raise ValueError("seed must be a non-negative 63-bit int")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0

    @property
    def is_plain(self) -> bool:
        """True when decoding needs no sampler state at all: plain argmax
        with no noise and no presence tracking. (Greedy with a repetition
        penalty still needs the presence buffer.)"""
        return self.is_greedy and self.repetition_penalty == 1.0

    @property
    def kind(self) -> str:
        """Stats bucket: which filters are live for this request."""
        if self.is_greedy:
            return "greedy" if self.is_plain else "greedy+rep_pen"
        parts = ["temperature"]
        if self.top_k > 0:
            parts.append("top_k")
        if self.top_p < 1:
            parts.append("top_p")
        if self.repetition_penalty != 1.0:
            parts.append("rep_pen")
        return "+".join(parts)


GREEDY = SamplingParams()


def base_key_data(seed: int) -> np.ndarray:
    """The request's base PRNG key as raw ``(2,)`` uint32 threefry data
    (the hi/lo split ``jax.random.PRNGKey`` uses). Derived from the seed
    alone, so it is identical across processes, slots and batches."""
    return np.array(
        [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32
    )


# ----------------------------------------------------------------------
# Threefry-2x32 noise (int64 tensors holding uint32 values)
# ----------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), on broadcastable int64
    tensors holding uint32 values; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: keys (B, 2) uint32 values (any
    integer dtype), data (B,) non-negative -> new keys (B, 2) int64."""
    k = keys.long()
    y0, y1 = threefry2x32(
        k[:, 0], k[:, 1], torch.zeros_like(k[:, 0]), data.long() & _M32
    )
    return torch.stack([y0, y1], dim=1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per row in the partitionable
    threefry mode: counter (hi, lo) = (0, i), output hi ^ lo. keys (B, 2)
    -> (B, n) int64 holding uint32 values."""
    k = keys.long()
    lo = torch.arange(n, dtype=torch.int64, device=k.device)[None, :]
    b0, b1 = threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(lo), lo)
    return b0 ^ b1


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per row, low mode: the 23
    mantissa bits OR'd into 1.0, minus 1, scaled into [tiny, 1), clamped,
    then ``-log(-log(u))``. keys (B, 2) -> (B, n) float32. The uniforms
    are JAX's bit for bit; each log differs from XLA's float32 log by at
    most its rounding (1 ulp), and near g = 0 the outer log turns one ulp
    of its argument (~1) into up to 2^-23 of g."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=keys.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=keys.device) - tiny
    u = torch.maximum(tiny, floats * span + tiny)
    # each log in float64, rounded to float32 where the float32 program
    # rounds: the card and the CPU then give the same float32 noise
    w = (-torch.log(u.double())).float()
    return (-torch.log(w.double())).float()


# ----------------------------------------------------------------------
# The sampler (device tensors in, device tensors out)
# ----------------------------------------------------------------------


def _penalize(logits: torch.Tensor, rep: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """HF repetition penalty on already-seen tokens: positive logits are
    divided by the penalty, negative multiplied. ``rep == 1`` is exact
    identity."""
    r = rep[:, None]
    pen = torch.where(logits > 0, logits / r, logits * r)
    return torch.where(seen, pen, logits)


def sample_logits(
    logits: torch.Tensor,
    temp: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    rep: torch.Tensor,
    keys: torch.Tensor,
    idx: torch.Tensor,
    seen: torch.Tensor,
    valid_vocab: int | None = None,
    candidates: int | None = None,
) -> torch.Tensor:
    """Batched per-row sampling: logits (B, V) -> token ids (B,) int64.

    Every knob is a per-row ``(B,)`` tensor (``keys`` (B, 2) base key
    data, ``idx`` the per-row sample index, ``seen`` a (B, V) bool
    presence mask). Rows are independent of each other. Rows with
    ``temp <= 0`` take the exact argmax (ties to the lowest id).

    ``candidates``: a static cap C; the sampled branch draws from the
    top-C candidates only (``None``: the whole vocabulary). top-k ranks
    and top-p mass are taken over the candidates. ``valid_vocab``:
    columns past it (embedding padding) are excluded from the sampled
    branch. The candidates come from one stable descending sort of the
    scaled logits: value descending, token id ascending among ties.
    """
    v = logits.shape[-1]
    logits = _penalize(logits.float(), rep, seen)
    greedy_tok = torch.argmax(logits, dim=-1)

    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    if valid_vocab is not None and valid_vocab < v:
        col = torch.arange(v, device=logits.device)[None, :]
        scaled = torch.where(col < valid_vocab, scaled, float("-inf"))
    c = v if candidates is None else min(int(candidates), v)
    sx, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    sx, order = sx[:, :c], order[:, :c]
    rank = torch.arange(c, device=logits.device)[None, :]
    # top-k by rank: keep exactly k (0 or >= C disables)
    k = torch.where((top_k <= 0) | (top_k >= c), c, top_k)
    keep = rank < k[:, None]
    sx = torch.where(keep, sx, float("-inf"))
    # top-p over the renormalised post-top-k mass: the smallest sorted
    # prefix whose mass reaches p
    sp = torch.softmax(sx, dim=-1)
    mass_before = torch.cumsum(sp, dim=-1) - sp
    keep = keep & ((mass_before < top_p[:, None]) | (top_p >= 1.0)[:, None])
    sx = torch.where(keep, sx, float("-inf"))
    # Gumbel-max draw from each row's own (seed, sample index) stream
    noise = gumbel(fold_in(keys, idx), c)
    j = torch.argmax(sx + noise, dim=-1)
    sampled_tok = torch.gather(order, 1, j[:, None])[:, 0]
    return torch.where(temp <= 0.0, greedy_tok, sampled_tok)


def _core(logits, samp, seen, valid_vocab, candidates):
    return sample_logits(
        logits,
        samp["temp"],
        samp["top_k"],
        samp["top_p"],
        samp["rep"],
        samp["key"],
        samp["idx"],
        seen,
        valid_vocab,
        candidates,
    )


def sample_decode(
    logits: torch.Tensor,
    samp: dict,
    *,
    valid_vocab: int | None = None,
    candidates: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-step sampling over every slot. ``logits`` (slots, V);
    ``samp`` holds the slot-indexed param tensors plus the ``(slots,
    V+1)`` bool presence buffer, updated in place. Idle slots sample too
    (their tokens are ignored on the host, their presence rows reset at
    the next admission). Returns (tokens (slots,) int64, presence)."""
    v = logits.shape[-1]
    presence = samp["presence"]
    toks = _core(logits, samp, presence[:, :v], valid_vocab, candidates)
    presence[torch.arange(toks.shape[0], device=toks.device), toks] = True
    return toks, presence


def sample_prefill(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    plens: torch.Tensor,
    samp: dict,
    *,
    valid_vocab: int | None = None,
    candidates: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """First-token sampling for one admission group. ``logits`` (N, V) at
    each request's last real token; ``tokens`` (N, S) the padded prompts
    and ``plens`` (N,) their lengths; ``samp`` carries per-request (N,)
    params, ``slots`` (N,) and the full ``(max_slots, V+1)`` presence
    buffer, whose rows for ``slots`` are rebuilt from the prompts in place
    (padding goes to the trash column V). Returns (tokens (N,) int64,
    presence)."""
    v = logits.shape[-1]
    s = tokens.shape[1]
    presence = samp["presence"]
    slots = samp["slots"].long()
    presence[slots] = False
    col = torch.arange(s, device=tokens.device)[None, :]
    tok_or_trash = torch.where(col < plens[:, None], tokens.long(), v)
    presence[slots[:, None], tok_or_trash] = True
    toks = _core(logits, samp, presence[slots][:, :v], valid_vocab, candidates)
    presence[slots, toks] = True
    return toks, presence


# ----------------------------------------------------------------------
# Host-side reference oracle
# ----------------------------------------------------------------------


def reference_sample(
    logits: np.ndarray,
    params: SamplingParams,
    *,
    sample_idx: int,
    seen: np.ndarray | None = None,
    valid_vocab: int | None = None,
    candidates: int | None = None,
) -> int:
    """Numpy oracle for one row of the sampler: the same key derivation
    and Gumbel noise (this module's threefry, on the CPU), independent
    numpy filtering and argmax. ``seen``: optional (V,) bool presence row;
    ``candidates`` must match the sampler's cap."""
    x = np.asarray(logits, np.float32).copy()
    v = x.shape[-1]
    if seen is not None:
        r = np.float32(params.repetition_penalty)
        pen = np.where(x > 0, x / r, x * r)
        x = np.where(np.asarray(seen, bool), pen, x)
    if params.is_greedy:
        return int(np.argmax(x))
    x = x / np.float32(max(params.temperature, 1e-6))
    if valid_vocab is not None and valid_vocab < v:
        x[valid_vocab:] = -np.inf
    c = v if candidates is None else min(int(candidates), v)
    order = np.argsort(-x, kind="stable")[:c]
    sx = x[order]
    keep = np.ones(c, bool)
    if 0 < params.top_k < c:
        keep[params.top_k:] = False
        sx = np.where(keep, sx, -np.inf)
    if params.top_p < 1.0:
        # sx[0] is the finite max, so e[0] == 1 and the sum is >= 1
        e = np.exp(sx - sx[0])
        sp = (e / e.sum()).astype(np.float32)
        mass_before = np.cumsum(sp, dtype=np.float32) - sp
        keep &= mass_before < np.float32(params.top_p)
    sx = np.where(keep, sx, -np.inf)
    key = torch.from_numpy(base_key_data(params.seed).astype(np.int64))[None]
    g = gumbel(fold_in(key, torch.tensor([sample_idx])), c)[0].numpy()
    return int(order[np.argmax(sx + g)])
