"""Slot-based continuous-batching scheduler with priority admission.

Admission into a fixed set of cache slots: sequences are admitted the
moment a slot (and its KV pages) frees up and evicted the step they
finish — no full-batch barrier, no recompilation (the decode step is
always shaped (max_slots,), idle slots ride along masked).

The waiting queue is a *priority* queue ordered by ``(priority desc,
absolute deadline asc, uid asc)``: higher-priority requests admit first,
earliest-deadline-first breaks ties within a priority class, and FCFS
(monotone uids) breaks the rest — all-default ``ScheduleParams`` traffic
degenerates to the exact FCFS order the engine always had. A preempted
sequence's request re-enters the same queue (its old uid puts it at the
*front* of its class, so a resumed victim never queue-jumps itself).

``peek_admissible(k)`` exposes a bounded lookahead window so the engine
can batch same-bucket prefills and admit around an oversized
head-of-queue request; ``resume`` re-binds a swapped-out sequence's
preserved ``SequenceState`` to a fresh slot.
"""

from __future__ import annotations

import bisect

from repro_torch.serving.request import Request, SequenceState

__all__ = ["Scheduler"]


def _order_key(req: Request) -> tuple:
    deadline = (
        req.submit_s + req.schedule.deadline_s
        if req.schedule.deadline_s is not None
        else float("inf")
    )
    return (-req.schedule.priority, deadline, req.uid)


class Scheduler:
    def __init__(self, max_slots: int, *, on_event=None):
        """``on_event(kind, request)``: optional queue-lifecycle hook
        (kinds: "submit", "admit", "resume", "remove") — the engine
        binds it to its tracer so queue churn shows up as timeline
        instants. None (the default) costs nothing."""
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self._on_event = on_event
        # kept sorted by _order_key (bisect.insort on submit): index 0 is
        # the highest-priority / most-urgent waiting request
        self.waiting: list[Request] = []
        self.slots: list[SequenceState | None] = [None] * max_slots
        # anti-starvation aging: admission passes that admitted *around*
        # each still-waiting request (keyed by uid; cleared on admit)
        self._skips: dict[int, int] = {}

    # ---- queue -------------------------------------------------------
    def submit(self, req: Request) -> None:
        bisect.insort(self.waiting, req, key=_order_key)
        if self._on_event is not None:
            self._on_event("submit", req)

    def peek_admissible(self, k: int) -> list[Request]:
        """Bounded-lookahead admission window: the first ``min(k,
        len(waiting))`` queued requests in priority order, not popped.
        The engine filters this window by slot/page budget and may admit
        later (smaller) requests past an oversized head-of-queue one.
        ``k`` bounds how many requests each admission pass may consider
        (and thus admit past the head). Starvation is bounded by aging:
        the engine reports each pass's skipped-over requests via
        ``note_skips`` and stops admitting around any request whose
        ``skip_count`` reaches ``EngineConfig(max_skips=)``."""
        if k < 1:
            raise ValueError("lookahead k must be >= 1")
        return self.waiting[: min(k, len(self.waiting))]

    def note_skips(self, reqs: list[Request]) -> None:
        """Record one admission pass that admitted *around* each of
        ``reqs`` (a later request got a slot while they waited)."""
        for req in reqs:
            self._skips[req.uid] = self._skips.get(req.uid, 0) + 1

    def skip_count(self, req: Request) -> int:
        return self._skips.get(req.uid, 0)

    def remove(self, request: Request) -> None:
        """Drop a waiting request (queue-wait timeout / structured
        rejection) without binding it to a slot."""
        self._pop_waiting(request)
        self._skips.pop(request.uid, None)
        if self._on_event is not None:
            self._on_event("remove", request)

    def _pop_waiting(self, request: Request) -> Request:
        # remove by identity: dataclass equality would compare numpy
        # prompt arrays (ambiguous-truth ValueError on lookalikes)
        for i, r in enumerate(self.waiting):
            if r is request:
                del self.waiting[i]
                return r
        raise ValueError("request is not in the waiting queue")

    # ---- slots -------------------------------------------------------
    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    @property
    def num_free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    def admit(
        self, step: int, *, request: Request | None = None
    ) -> SequenceState | None:
        """Bind a waiting request to a free slot (None if neither).

        ``request=None`` takes the head of the queue (highest priority,
        then FCFS); passing a specific request (one returned by
        ``peek_admissible``) removes it from wherever it sits in the
        queue — that's how the engine's lookahead admits around an
        oversized head-of-line request."""
        slot = self.free_slot()
        if slot is None or not self.waiting:
            return None
        if request is None:
            req = self.waiting.pop(0)
        else:
            req = self._pop_waiting(request)
        self._skips.pop(req.uid, None)
        state = SequenceState(request=req, slot=slot, admit_step=step)
        self.slots[slot] = state
        if self._on_event is not None:
            self._on_event("admit", req)
        return state

    def resume(
        self, state: SequenceState, *, request: Request
    ) -> SequenceState | None:
        """Re-bind a swapped-out sequence's preserved state to a free
        slot, removing its re-queued request from the waiting queue.
        The state keeps its progress (pos/generated/admit_step); only
        the slot binding changes. None if no slot is free."""
        slot = self.free_slot()
        if slot is None:
            return None
        self._pop_waiting(request)
        self._skips.pop(request.uid, None)
        state.slot = slot
        self.slots[slot] = state
        if self._on_event is not None:
            self._on_event("resume", request)
        return state

    def evict(self, slot: int) -> SequenceState:
        state = self.slots[slot]
        if state is None:
            raise ValueError(f"slot {slot} is empty")
        self.slots[slot] = None
        return state

    # ---- views -------------------------------------------------------
    def active(self) -> list[SequenceState]:
        return [s for s in self.slots if s is not None]

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def occupancy(self) -> float:
        return self.num_active / self.max_slots

    @property
    def idle(self) -> bool:
        return not self.waiting and self.num_active == 0
