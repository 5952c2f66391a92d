"""Data pipeline: deterministic, resumable token streams (numpy).

A copy of the JAX package's ``training/data.py`` sources, which use numpy
only: the same seed and step give the same batches in both packages.

- ``SyntheticLM``: a seeded Markov-ish token generator, cheap, infinite
  and *step-addressable* (``batch(step)`` is a pure function of (seed,
  step)), which makes checkpoint-resume exact.
- ``TextFileLM``: byte-level tokenization of a local file with the same
  step-addressable contract.
- ``EmbedsWrapper``: the stub modality frontend of the vlm and audio
  backbones, mapping a source's token batches to pseudo-embeddings.

Batches are {"tokens", "labels"} (B, S) int32 numpy arrays, with labels
the next-token shift; ``EmbedsWrapper`` gives {"embeds", "labels"} and,
for M-RoPE, "positions".
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "TextFileLM", "EmbedsWrapper"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        # structured stream: a noisy cyclic pattern, so a real model can
        # actually reduce the loss
        base = rng.integers(0, v, size=(b, 1))
        steps = rng.integers(1, 7, size=(b, 1))
        seq = (base + steps * np.arange(s + 1)[None, :]) % v
        noise = rng.random((b, s + 1)) < 0.05
        seq = np.where(noise, rng.integers(0, v, size=(b, s + 1)), seq)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }

    def state(self) -> dict:
        return {"seed": self.seed}


@dataclasses.dataclass
class TextFileLM:
    path: str
    seq_len: int
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        with open(self.path, "rb") as f:
            self._data = np.frombuffer(f.read(), dtype=np.uint8)
        if len(self._data) < self.seq_len + 2:
            raise ValueError("file too small for seq_len")

    @property
    def vocab_size(self) -> int:
        return 256

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        n = len(self._data) - self.seq_len - 1
        starts = rng.integers(0, n, size=self.batch_size)
        toks = np.stack([self._data[s : s + self.seq_len + 1] for s in starts]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self) -> dict:
        return {"seed": self.seed, "path": self.path}


@dataclasses.dataclass
class EmbedsWrapper:
    """Stub modality frontend: maps ``inner``'s token batches to
    deterministic pseudo-embeddings (B, S, d_model) fp32, the [vlm]/[audio]
    contract, with (B, S, n_pos_streams) int32 positions 0..S-1 on every
    stream when ``n_pos_streams`` is set (3 for M-RoPE).

    The JAX package's wrapper draws its (V, d_model) table from
    ``default_rng(0)`` on every batch; this one draws the same table once,
    at the first batch, and keeps it (2.2 GB at qwen2-vl-7b's width), so
    the batches are equal bit for bit and a step pays no table draw."""

    inner: object
    d_model: int
    n_pos_streams: int = 0
    _table: np.ndarray | None = dataclasses.field(default=None, init=False, repr=False)

    def table(self) -> np.ndarray:
        if self._table is None:
            rng = np.random.default_rng(0)
            shape = (self.inner.vocab_size, self.d_model)
            self._table = rng.standard_normal(shape).astype(np.float32) * 0.02
        return self._table

    def batch(self, step: int) -> dict:
        b = self.inner.batch(step)
        toks = b["tokens"]
        bsz, s = toks.shape
        out = {"embeds": self.table()[toks], "labels": b["labels"]}
        if self.n_pos_streams:
            pos = np.broadcast_to(
                np.arange(s, dtype=np.int32)[None, :, None], (bsz, s, self.n_pos_streams)
            )
            out["positions"] = np.ascontiguousarray(pos)
        return out

    def state(self) -> dict:
        return self.inner.state()
