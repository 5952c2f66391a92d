"""Ring-buffered span tracer for the serving hot path.

Design constraints, in order:

  1. **Cheap when on.**  One event = one write into preallocated numpy
     columns (ts/kind/name/track/a0/a1) at a wrapping cursor, stamped
     with ``perf_counter_ns``.  Track and name labels are interned to
     small ints up front (``Engine.__init__`` resolves every id it will
     ever use), so recording does no string work and no per-event
     allocation beyond the open-span stack push.
  2. **Free when off.**  :data:`NULL_TRACER` implements the same surface
     as pure no-ops, so engine code calls ``self.tracer.begin(...)``
     unconditionally — no ``if traced:`` branches on the hot path, and
     a disabled engine does zero obs work (tests assert this by
     patching :func:`perf_counter_ns` with a counting shim).
  3. **Consistent under reset and wrap.**  ``reset()`` closes all open
     spans (counted in ``truncated_spans``) *before* clearing the ring,
     so a mid-traffic ``Engine.reset_stats()`` never leaks a dangling
     ``B`` — subsequent ``end()`` calls for pre-reset spans are no-ops.
     Ring wrap drops the oldest events; the exporter re-pairs B/E per
     track and drops orphaned ``E``s whose ``B`` was overwritten.

Event model (mirrors the Chrome trace-event phases the exporter emits):
``B``/``E`` nested spans per track, ``I`` instants, ``X`` complete
events carrying an explicit (ts, dur) — used for queue-wait spans whose
start is the request's submit timestamp, recorded only at admission —
and ``C`` counter samples (a0 = the integer value; the exporter renders
them as Perfetto counter tracks under the spans, e.g. pool occupancy
and queue depth per step).
"""

from __future__ import annotations

from time import perf_counter_ns

import numpy as np

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "KIND_B", "KIND_E",
           "KIND_I", "KIND_X", "KIND_C"]

KIND_B, KIND_E, KIND_I, KIND_X, KIND_C = 0, 1, 2, 3, 4


class Tracer:
    enabled = True

    def __init__(self, capacity: int = 1 << 16):
        cap = 1
        while cap < max(2, int(capacity)):
            cap <<= 1  # power of two: wrap is a mask, not a modulo
        self._cap = cap
        self._mask = cap - 1
        self._ts = np.zeros(cap, np.int64)
        self._dur = np.zeros(cap, np.int64)
        self._kind = np.zeros(cap, np.int8)
        self._name = np.zeros(cap, np.int32)
        self._track = np.zeros(cap, np.int32)
        self._a0 = np.zeros(cap, np.int64)
        self._a1 = np.zeros(cap, np.int64)
        self._n = 0  # events ever recorded; ring holds the last `cap`
        self._track_labels: list[str] = []
        self._track_ids: dict[str, int] = {}
        self._name_labels: list[str] = []
        self._name_ids: dict[str, int] = {}
        # per-track stack of open span name-ids (B pushed, E pops)
        self._open: list[list[int]] = []
        self.truncated_spans = 0  # spans force-closed by reset()

    # -- interning -----------------------------------------------------

    def track(self, label: str) -> int:
        """Intern a track label -> id (one Perfetto thread per track)."""
        tid = self._track_ids.get(label)
        if tid is None:
            tid = len(self._track_labels)
            self._track_ids[label] = tid
            self._track_labels.append(label)
            self._open.append([])
        return tid

    def name(self, label: str) -> int:
        nid = self._name_ids.get(label)
        if nid is None:
            nid = len(self._name_labels)
            self._name_ids[label] = nid
            self._name_labels.append(label)
        return nid

    # -- recording (hot path) ------------------------------------------

    def _record(
        self, kind: int, track: int, name: int, ts: int, dur: int,
        a0: int, a1: int,
    ) -> None:
        i = self._n & self._mask
        self._ts[i] = ts
        self._dur[i] = dur
        self._kind[i] = kind
        self._name[i] = name
        self._track[i] = track
        self._a0[i] = a0
        self._a1[i] = a1
        self._n += 1

    def begin(self, track: int, name: int, a0: int = 0, a1: int = 0) -> int:
        """Open a span on ``track``; returns its start timestamp (ns)."""
        ts = perf_counter_ns()
        self._record(KIND_B, track, name, ts, 0, a0, a1)
        self._open[track].append(name)
        return ts

    def end(self, track: int, name: int, a0: int = 0, a1: int = 0) -> None:
        """Close the innermost open span on ``track``.  A no-op if the
        span was already force-closed by :meth:`reset` (so callers never
        need to remember whether a reset happened mid-span)."""
        stack = self._open[track]
        if not stack or stack[-1] != name:
            return
        stack.pop()
        self._record(KIND_E, track, name, perf_counter_ns(), 0, a0, a1)

    def instant(self, track: int, name: int, a0: int = 0, a1: int = 0) -> None:
        self._record(KIND_I, track, name, perf_counter_ns(), 0, a0, a1)

    def complete(
        self, track: int, name: int, ts_ns: int, dur_ns: int,
        a0: int = 0, a1: int = 0,
    ) -> None:
        """A span with explicit start/duration (Chrome ``X`` phase) —
        for intervals whose start predates the recording call, e.g.
        queue wait stamped once at admission."""
        self._record(KIND_X, track, name, ts_ns, max(0, dur_ns), a0, a1)

    def counter(self, track: int, name: int, value: int) -> None:
        """One counter sample (Chrome ``C`` phase): the series ``name``
        on ``track`` takes integer ``value`` as of now.  Counters never
        touch the open-span stacks."""
        self._record(KIND_C, track, name, perf_counter_ns(), 0, int(value), 0)

    # -- lifecycle -----------------------------------------------------

    def reset(self) -> None:
        """Clear the ring.  Open spans are closed (not leaked): each is
        counted in ``truncated_spans`` and its future ``end()`` becomes
        a no-op.  Interned track/name ids survive — engine code holds
        resolved ids."""
        for stack in self._open:
            self.truncated_spans += len(stack)
            stack.clear()
        self._n = 0

    @property
    def n_events(self) -> int:
        """Events currently held in the ring."""
        return min(self._n, self._cap)

    @property
    def n_recorded(self) -> int:
        """Events ever recorded (>= n_events once the ring wraps)."""
        return self._n

    def open_spans(self) -> dict[str, list[str]]:
        """Track label -> open span names, outermost first (debugging)."""
        return {
            self._track_labels[t]: [self._name_labels[n] for n in stack]
            for t, stack in enumerate(self._open)
            if stack
        }

    # -- export --------------------------------------------------------

    def events(self) -> list[dict]:
        """The retained ring contents, oldest first, as plain dicts with
        interned labels resolved.  The Perfetto exporter consumes this;
        tests can too."""
        start = max(0, self._n - self._cap)
        out = []
        for j in range(start, self._n):
            i = j & self._mask
            out.append(
                {
                    "kind": int(self._kind[i]),
                    "track": self._track_labels[int(self._track[i])],
                    "name": self._name_labels[int(self._name[i])],
                    "ts_ns": int(self._ts[i]),
                    "dur_ns": int(self._dur[i]),
                    "a0": int(self._a0[i]),
                    "a1": int(self._a1[i]),
                }
            )
        return out

    def export_perfetto(self, path: str, pid: int = 0) -> int:
        """Write a Chrome trace-event JSON file (openable in
        ui.perfetto.dev).  Returns the number of events written."""
        from .perfetto import export_perfetto

        return export_perfetto({pid: self}, path)


class NullTracer:
    """No-op tracer bound to disabled engines.  Same surface as
    :class:`Tracer`; every method returns immediately so hot-path call
    sites stay branch-free and cost one attribute lookup + call."""

    enabled = False
    truncated_spans = 0
    n_events = 0
    n_recorded = 0
    _track_labels: tuple = ()  # exporters see an empty process

    def track(self, label: str) -> int:
        return 0

    def name(self, label: str) -> int:
        return 0

    def begin(self, track: int, name: int, a0: int = 0, a1: int = 0) -> int:
        return 0

    def end(self, track: int, name: int, a0: int = 0, a1: int = 0) -> None:
        return None

    def instant(self, track: int, name: int, a0: int = 0, a1: int = 0) -> None:
        return None

    def complete(
        self, track: int, name: int, ts_ns: int, dur_ns: int,
        a0: int = 0, a1: int = 0,
    ) -> None:
        return None

    def counter(self, track: int, name: int, value: int) -> None:
        return None

    def reset(self) -> None:
        return None

    def open_spans(self) -> dict:
        return {}

    def events(self) -> list:
        return []

    def export_perfetto(self, path: str, pid: int = 0) -> int:
        raise RuntimeError(
            "tracing is disabled (EngineConfig(trace=False)); nothing to "
            "export"
        )


NULL_TRACER = NullTracer()
