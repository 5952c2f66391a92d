"""Pixelfly block-sparse attention patterns (paper §3.3, App. I.2/I.3).

A numpy copy of the JAX package's ``core.attn_pattern``: local window +
butterfly XOR strides + global cross, as a boolean block mask, and the
padded per-q-block KV schedule the prefill attention kernel walks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import butterfly

__all__ = [
    "AttentionPatternConfig",
    "pixelfly_attention_block_mask",
    "block_schedule",
    "BlockSchedule",
    "keys_per_query",
]


@dataclasses.dataclass(frozen=True)
class AttentionPatternConfig:
    block: int = 128            # hardware block (query & key granularity)
    local_blocks: int = 1       # width of the block-diagonal window
    max_stride: int = 0         # 0 -> full flat butterfly on the block grid
    global_blocks: int = 1      # width of the global cross (low-rank part)


def pixelfly_attention_block_mask(
    seq_q: int,
    seq_k: int,
    cfg: AttentionPatternConfig,
    *,
    causal: bool = False,
) -> np.ndarray:
    """Boolean (nqb, nkb) block mask: local + butterfly + global."""
    b = cfg.block
    nqb = -(-seq_q // b)
    nkb = -(-seq_k // b)
    g = butterfly.next_pow2(max(nqb, nkb))
    max_stride = cfg.max_stride or g
    max_stride = min(butterfly.next_pow2(max_stride), g)
    strides = butterfly.flat_butterfly_strides(max_stride)

    mask = np.zeros((nqb, nkb), dtype=bool)
    qi = np.arange(nqb)
    for i in range(nqb):
        gi = i * g // nqb  # local window in stretched grid space
        lo = max(0, (gi - (cfg.local_blocks - 1)) * nkb // g)
        hi = min(nkb, (gi + cfg.local_blocks) * nkb // g + 1)
        mask[i, lo:hi] = True
        for s in strides:
            j = (gi ^ s) * nkb // g
            if j < nkb:
                mask[i, j] = True
    if cfg.global_blocks > 0:
        mask[: cfg.global_blocks, :] = True
        mask[:, : cfg.global_blocks] = True
    if causal:
        # drop blocks entirely above the diagonal; element causality inside
        # boundary blocks is the kernel's job
        ji = np.arange(nkb)
        keep = ji[None, :] * b <= qi[:, None] * b + (b - 1)
        mask &= keep
    return mask


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    """Per-q-block KV visit list (padded, static)."""

    kv_index: np.ndarray  # (nqb, max_nkv) int32, padded with 0
    valid: np.ndarray     # (nqb, max_nkv) int32 {0,1}
    block_q: int
    block_k: int

    @property
    def nqb(self) -> int:
        return self.kv_index.shape[0]

    @property
    def max_nkv(self) -> int:
        return self.kv_index.shape[1]


def block_schedule(
    block_mask: np.ndarray, block_q: int, block_k: int
) -> BlockSchedule:
    """Turn a boolean block mask into a padded per-row KV schedule."""
    nqb, _ = block_mask.shape
    rows = [np.nonzero(block_mask[i])[0] for i in range(nqb)]
    width = max(1, max(len(r) for r in rows))
    kv = np.zeros((nqb, width), dtype=np.int32)
    valid = np.zeros((nqb, width), dtype=np.int32)
    for i, r in enumerate(rows):
        kv[i, : len(r)] = r
        valid[i, : len(r)] = 1
    return BlockSchedule(kv_index=kv, valid=valid, block_q=block_q, block_k=block_k)


def keys_per_query(block_mask: np.ndarray, block_k: int, seq_k: int) -> float:
    """Mean number of keys a query attends to (the O(n b log n) claim)."""
    return float(block_mask.sum(axis=1).mean() * block_k)
