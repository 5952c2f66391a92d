"""Per-request decoding knobs.

Only ``SamplingParams`` is ported so far (a copy of the JAX package's);
the port's engine serves exact greedy requests and raises on any other
(ROADMAP Queue 1 item 1: the sampler with threefry Gumbel noise).
"""

from __future__ import annotations

import dataclasses

__all__ = ["SamplingParams"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs. Defaults are exact greedy.

    temperature: 0 -> greedy argmax; > 0 -> softmax sampling.
    top_k: keep only the k highest logits (0 -> disabled).
    top_p: keep the smallest prefix of the sorted distribution whose
        mass reaches p (1.0 -> disabled).
    repetition_penalty: HF-style penalty (> 1 discourages) applied to
        every token already in the sequence (prompt + generated).
    seed: PRNG seed for this request's noise stream.
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
        with no noise and no repetition penalty."""
        return self.is_greedy and self.repetition_penalty == 1.0

