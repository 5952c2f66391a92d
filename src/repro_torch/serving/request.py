"""Request / sequence lifecycle types for the serving engine.

A ``Request`` is what a client submits; a ``SequenceState`` is a request
bound to a cache slot while it is in flight; a ``FinishedRequest`` is the
terminal record handed back by ``Engine.step``/``drain``.

``ScheduleParams`` is the scheduling sibling of ``SamplingParams``: where
sampling knobs shape *what* a request decodes, scheduling knobs shape
*when* — its priority class, its soft latency deadline, and how long it
is willing to wait in the queue before giving up. The engine's admission
loop orders the waiting queue by (priority desc, deadline asc, FCFS).

It may *preempt* (swap out) a running lower-priority sequence to make
room for a higher-priority one (``repro_torch.serving.swap``). A
host-only copy of the JAX package's ``serving/request.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.sampling import SamplingParams

__all__ = [
    "Request",
    "ScheduleParams",
    "SequenceState",
    "FinishedRequest",
    "REJECT_TOO_LARGE",
    "REJECT_TIMEOUT",
    "REJECT_SHED",
]

# ``FinishedRequest.reject_reason`` values (``finish_reason ==
# "rejected"``): the request could *never* fit the engine's geometry,
# it waited longer than its ``ScheduleParams.max_queue_wait_s`` allowed,
# or the SLO burn-rate monitor shed it from the queue under overload
# (``EngineConfig(slo=SloConfig(shed=True))``).
REJECT_TOO_LARGE = "too_large"
REJECT_TIMEOUT = "timeout"
REJECT_SHED = "shed"


@dataclasses.dataclass(frozen=True)
class ScheduleParams:
    """Per-request scheduling knobs. Defaults are best-effort FCFS.

    priority: higher admits (and decodes) first; a waiting request may
        preempt a running sequence of *strictly lower* priority when the
        pool is full (``EngineConfig(preemption=...)``).
    deadline_s: soft end-to-end latency target in seconds from submit.
        Orders the queue (earliest-deadline-first within a priority
        class) and defines SLO attainment in the stats/benchmarks; the
        engine never kills a request for missing it.
    max_queue_wait_s: give up if not admitted within this many seconds
        of submission — the request finishes with ``finish_reason
        "rejected"`` / ``reject_reason REJECT_TIMEOUT`` instead of
        waiting forever.
    """

    priority: int = 0
    deadline_s: float | None = None
    max_queue_wait_s: float | None = None

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (None disables)")
        if self.max_queue_wait_s is not None and self.max_queue_wait_s < 0:
            raise ValueError(
                "max_queue_wait_s must be >= 0 (None disables)"
            )


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (plen,) int32, plen >= 1
    max_new_tokens: int
    eos_id: int | None = None
    # per-request decoding knobs; the default is exact greedy
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams
    )
    # per-request scheduling knobs; the default is best-effort FCFS
    schedule: ScheduleParams = dataclasses.field(
        default_factory=ScheduleParams
    )
    # wall-clock submission time (time.perf_counter), stamped by
    # Engine.submit: the anchor for queue-wait timeouts, TTFT and
    # deadline attainment
    submit_s: float = 0.0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.sampling is None:
            self.sampling = SamplingParams()
        if not isinstance(self.sampling, SamplingParams):
            raise TypeError("sampling must be a SamplingParams")
        if self.schedule is None:
            self.schedule = ScheduleParams()
        if not isinstance(self.schedule, ScheduleParams):
            raise TypeError("schedule must be a ScheduleParams")


@dataclasses.dataclass
class SequenceState:
    """An admitted request occupying one cache slot."""

    request: Request
    slot: int
    pos: int = 0  # write position of the *next* decode token
    generated: list[int] = dataclasses.field(default_factory=list)
    admit_step: int = 0
    # prompt tokens served from the prefix cache (0 = full prefill)
    prefix_hit_tokens: int = 0
    # times this sequence was swapped out to host memory and resumed
    preemptions: int = 0
    # step of the last admit/resume: preemption hysteresis — a sequence
    # must run ``EngineConfig(preempt_min_steps=)`` steps before it can
    # be victimized (again), so a burst can't thrash swap
    resume_step: int = 0
    # wall-clock time the first token was emitted (TTFT anchor)
    first_token_s: float | None = None

    @property
    def plen(self) -> int:
        return int(self.request.prompt.size)

    @property
    def remaining(self) -> int:
        """Decode tokens this sequence may still emit (victim-selection
        key: preempt the longest-remaining first)."""
        return max(0, self.request.max_new_tokens - len(self.generated))

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_id
        return eos is not None and bool(self.generated) and (
            self.generated[-1] == eos
        )


@dataclasses.dataclass
class FinishedRequest:
    uid: int
    prompt: np.ndarray
    tokens: np.ndarray  # (n_generated,) int32
    finish_reason: str  # "length" | "eos" | "capacity" | "rejected"
    admit_step: int
    finish_step: int
    # prompt tokens the admission served straight from the prefix cache
    # instead of prefilling (mapped shared pages)
    prefix_hit_tokens: int = 0
    # why a "rejected" request never ran (REJECT_* above); None otherwise
    reject_reason: str | None = None
    # times the sequence was swapped out to host memory and resumed
    preemptions: int = 0
    # wall-clock seconds from submit to first token / to completion
    # (None for rejected requests)
    ttft_s: float | None = None
    e2e_s: float | None = None
    # the request's scheduling knobs, echoed so callers can score SLO
    # attainment (e2e_s <= schedule.deadline_s) without a side table
    schedule: ScheduleParams = dataclasses.field(
        default_factory=ScheduleParams
    )

    @property
    def rejected(self) -> bool:
        return self.finish_reason == "rejected"

    @property
    def slo_met(self) -> bool | None:
        """Did this request meet its soft deadline? None when it had no
        deadline; False for rejected deadline'd requests."""
        if self.schedule.deadline_s is None:
            return None
        if self.rejected or self.e2e_s is None:
            return False
        return self.e2e_s <= self.schedule.deadline_s
