"""Seeded serving-workload generators and a step-driven replay driver, a
copy of the JAX package's ``serving/workloads.py`` on the port's request
and sampling types (same seed, same trace as the JAX package's).

The serving benchmarks (and any soak test) need *reproducible* traffic
that actually stresses the scheduler: bursts that oversubscribe the
slots, heavy-tailed decode lengths that pin slots for hundreds of steps,
and multi-turn chat where each turn's prompt extends the last turn's
output. Every generator takes a ``numpy`` Generator — same seed, same
trace, bit-for-bit.

Time is measured in *engine steps*, not seconds: a ``WorkItem`` arrives
at ``arrival_step`` and its soft deadline / queue-wait limit are step
counts. ``replay`` converts them to wall-clock seconds with a measured
``step_s`` (seconds per engine step, calibrated on a warm run) when
attaching ``ScheduleParams`` — so the same trace is meaningful on any
machine, and a calibration pass can run with ``step_s=None`` to warm
every program (including the preemption/swap path) without arming any
deadline.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.request import FinishedRequest, ScheduleParams
from repro_torch.serving.sampling import SamplingParams

__all__ = [
    "WorkItem",
    "poisson_burst",
    "long_tail",
    "chat_turns",
    "replay",
    "replay_chat",
    "goodput",
]


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One request of a generated trace (times in engine steps)."""

    arrival_step: int
    prompt: np.ndarray
    max_new_tokens: int
    priority: int = 0
    deadline_steps: int | None = None
    max_queue_wait_steps: int | None = None
    sampling: SamplingParams | None = None


# ---- generators ------------------------------------------------------
def poisson_burst(
    rng: np.random.Generator,
    *,
    vocab: int,
    page: int,
    n_background: int,
    n_burst: int,
    burst_step: int,
    background_gen: int,
    burst_gen: int,
    deadline_steps: int,
    burst_priority: int = 5,
) -> list[WorkItem]:
    """Steady background load hit by a latency-critical burst.

    ``n_background`` long-decode, no-deadline requests arrive at step 0
    (Poisson-thinned arrival jitter of a step or two) and occupy every
    slot; at ``burst_step`` a burst of ``n_burst`` short, high-priority,
    deadline'd requests lands on the full pool. With preemption the
    burst swaps the background out and meets its deadlines; without it
    the burst queues behind ``background_gen`` decode steps and misses
    them — the benchmark's headline SLO-attainment comparison."""
    items = [
        WorkItem(
            arrival_step=int(rng.poisson(0.5)),
            prompt=rng.integers(
                1, vocab, page + int(rng.integers(4, page // 2))
            ).astype(np.int32),
            max_new_tokens=background_gen,
        )
        for _ in range(n_background)
    ]
    items += [
        WorkItem(
            arrival_step=burst_step + int(rng.poisson(0.5)),
            prompt=rng.integers(
                1, vocab, int(rng.integers(8, page // 2))
            ).astype(np.int32),
            max_new_tokens=burst_gen,
            priority=burst_priority,
            deadline_steps=deadline_steps,
        )
        for _ in range(n_burst)
    ]
    return sorted(items, key=lambda w: w.arrival_step)


def long_tail(
    rng: np.random.Generator,
    *,
    vocab: int,
    page: int,
    n: int,
    mean_gap_steps: float,
    short_gen: tuple[int, int],
    heavy_gen: int,
    heavy_frac: float = 0.2,
    deadline_steps: int | None = None,
) -> list[WorkItem]:
    """Heavy-tailed open-loop traffic: exponential arrival gaps, mostly
    short interactive requests (priority 1, deadline'd) with a
    ``heavy_frac`` tail of long-decode batch requests (priority 0, no
    deadline) that pin slots for ``heavy_gen`` steps each. Preemption
    lets the interactive tier cut through the batch tier."""
    items, t = [], 0.0
    for _ in range(n):
        t += rng.exponential(mean_gap_steps)
        heavy = rng.random() < heavy_frac
        items.append(
            WorkItem(
                arrival_step=int(t),
                prompt=rng.integers(
                    1, vocab, int(rng.integers(page // 4, page))
                ).astype(np.int32),
                max_new_tokens=heavy_gen
                if heavy
                else int(rng.integers(*short_gen)),
                priority=0 if heavy else 1,
                deadline_steps=None if heavy else deadline_steps,
            )
        )
    return items


def chat_turns(
    rng: np.random.Generator,
    *,
    vocab: int,
    n_users: int,
    n_turns: int,
    user_tokens: int,
    gen: int,
) -> list[list[tuple[np.ndarray, int]]]:
    """Multi-turn chat: each conversation is ``n_turns`` of
    ``user_tokens`` new user input answered by ``gen`` tokens. Turn
    ``t``'s prompt is the whole history (previous prompt + previous
    answer + new user text), so with the prefix cache on, turn 2+
    admissions should hit the turn-1 pages — *including the
    decode-written answer pages* the engine indexes at finish."""
    return [
        [
            (
                rng.integers(1, vocab, user_tokens).astype(np.int32),
                gen,
            )
            for _ in range(n_turns)
        ]
        for _ in range(n_users)
    ]


# ---- replay ----------------------------------------------------------
def _schedule(item: WorkItem, step_s: float | None) -> ScheduleParams:
    if step_s is None:  # calibration: priorities live, deadlines unarmed
        return ScheduleParams(priority=item.priority)
    return ScheduleParams(
        priority=item.priority,
        deadline_s=(
            item.deadline_steps * step_s
            if item.deadline_steps is not None
            else None
        ),
        max_queue_wait_s=(
            item.max_queue_wait_steps * step_s
            if item.max_queue_wait_steps is not None
            else None
        ),
    )


def replay(
    engine, items: list[WorkItem], *, step_s: float | None
) -> tuple[list[FinishedRequest], float, int]:
    """Drive one trace through the engine: submit each item the step it
    arrives, stepping until everything finishes. Returns (finished,
    wall seconds, steps). ``step_s`` converts step-denominated deadlines
    to wall-clock ``ScheduleParams``; ``None`` leaves deadlines unarmed
    (calibration/warm runs — preemption still fires on priority)."""
    items = sorted(items, key=lambda w: w.arrival_step)
    fins: list[FinishedRequest] = []
    i, step = 0, 0
    t0 = time.perf_counter()
    while i < len(items) or not engine.scheduler.idle or engine._rejected:
        while i < len(items) and items[i].arrival_step <= step:
            engine.submit(
                items[i].prompt,
                items[i].max_new_tokens,
                sampling=items[i].sampling,
                schedule=_schedule(items[i], step_s),
            )
            i += 1
        fins.extend(engine.step())
        step += 1
    return fins, time.perf_counter() - t0, step


def replay_chat(
    engine, convs: list[list[tuple[np.ndarray, int]]]
) -> tuple[dict[int, list[FinishedRequest]], float, int]:
    """Drive multi-turn conversations: every conversation's next turn is
    submitted the step its previous turn finishes, with the full history
    as the prompt. Returns (finished by turn index, wall s, steps)."""
    active: dict[int, tuple[int, int, np.ndarray]] = {}
    by_turn: dict[int, list[FinishedRequest]] = {}
    for ci, conv in enumerate(convs):
        user, gen = conv[0]
        uid = engine.submit(user, gen)
        active[uid] = (ci, 0, user)
    step = 0
    t0 = time.perf_counter()
    while active or not engine.scheduler.idle:
        for f in engine.step():
            ci, ti, prompt = active.pop(f.uid)
            by_turn.setdefault(ti, []).append(f)
            if ti + 1 < len(convs[ci]):
                user, gen = convs[ci][ti + 1]
                nxt = np.concatenate([prompt, f.tokens, user])
                uid = engine.submit(nxt, gen)
                active[uid] = (ci, ti + 1, nxt)
        step += 1
    return by_turn, time.perf_counter() - t0, step


# ---- folding ---------------------------------------------------------
def _pct(vals: list[float], q: float) -> float:
    return (
        round(float(np.percentile(np.asarray(vals), q)) * 1e3, 3)
        if vals
        else 0.0
    )


def goodput(fins: list[FinishedRequest], stats: dict) -> dict:
    """Fold one replay into the benchmark's goodput row: SLO attainment
    over deadline'd requests, TTFT percentiles, preemption/swap volume,
    and rejections. ``stats`` is the engine's ``stats_summary()`` for
    the same run (per-token latency + swap byte counters)."""
    dl = [f for f in fins if f.schedule.deadline_s is not None]
    met = sum(1 for f in dl if f.slo_met)
    ttft = [f.ttft_s for f in fins if f.ttft_s is not None]
    pre = stats["preemption"]
    return {
        "requests": len(fins),
        "with_deadline": len(dl),
        "slo_met": met,
        "slo_attainment": round(met / len(dl), 4) if dl else 1.0,
        "ttft_p50_ms": _pct(ttft, 50),
        "ttft_p95_ms": _pct(ttft, 95),
        "ttft_p99_ms": _pct(ttft, 99),
        "p50_token_latency_ms": stats["p50_token_latency_ms"],
        "p99_token_latency_ms": stats["p99_token_latency_ms"],
        "preemptions": pre["preemptions"],
        "resumes": pre["resumes"],
        "swap_out_bytes": pre.get("out_bytes", 0),
        "swap_in_bytes": pre.get("in_bytes", 0),
        "rejected": stats["rejected"]["total"],
    }
