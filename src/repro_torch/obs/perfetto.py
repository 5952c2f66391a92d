"""Chrome trace-event (Perfetto-compatible) JSON export + validation.

``export_perfetto({pid: tracer}, path)`` writes the classic JSON trace
format — ``{"traceEvents": [...]}`` with ``B``/``E``/``I``/``X`` span
phases plus ``C`` counter samples (pool occupancy, queue depth, running
slots render as counter lanes under the spans) — that ui.perfetto.dev
and ``chrome://tracing`` both load.  Each tracer
becomes one process (replica index as ``pid``); each tracer track (one
per slot, one per engine phase, one for the queue) becomes one thread
with a ``thread_name`` metadata record, so the timeline renders as
labeled lanes.

The exporter is also where ring-wrap damage is repaired: events are
emitted in timestamp order, orphaned ``E``s (their ``B`` overwritten by
wrap) are dropped, and spans still open at export time are closed with
a synthetic ``E`` carrying ``"truncated": true`` — the emitted file
always satisfies :func:`validate_trace_file`, which the tests and
``chip_smoke.py`` run against ``launch/serve.py --trace-out`` output.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Mapping

from .trace import KIND_B, KIND_C, KIND_E, KIND_I, KIND_X

if TYPE_CHECKING:  # pragma: no cover
    from .trace import Tracer

__all__ = ["export_perfetto", "validate_trace", "validate_trace_file"]


class TraceValidationError(ValueError):
    pass


def _tracer_events(pid: int, tracer: "Tracer") -> list[dict]:
    """One tracer -> trace-event dicts (ts in µs, per Chrome schema)."""
    raw = sorted(tracer.events(), key=lambda e: e["ts_ns"])
    out: list[dict] = []
    tids: dict[str, int] = {}
    # Stable, human-meaningful lane order: the tracer interned engine
    # phases first, then slots, then the queue (Engine.__init__ order).
    for label in tracer._track_labels:
        tids[label] = len(tids)
    open_spans: dict[int, list[dict]] = {t: [] for t in tids.values()}
    max_ts = 0
    for ev in raw:
        tid = tids[ev["track"]]
        ts_us = ev["ts_ns"] / 1e3
        max_ts = max(max_ts, ev["ts_ns"] + ev["dur_ns"])
        args = {"a0": ev["a0"], "a1": ev["a1"]}
        if ev["kind"] == KIND_B:
            rec = {
                "ph": "B", "pid": pid, "tid": tid, "ts": ts_us,
                "name": ev["name"], "args": args,
            }
            out.append(rec)
            open_spans[tid].append(rec)
        elif ev["kind"] == KIND_E:
            if not open_spans[tid]:
                continue  # B lost to ring wrap: drop the orphan E
            open_spans[tid].pop()
            out.append(
                {
                    "ph": "E", "pid": pid, "tid": tid, "ts": ts_us,
                    "name": ev["name"], "args": args,
                }
            )
        elif ev["kind"] == KIND_I:
            out.append(
                {
                    "ph": "I", "pid": pid, "tid": tid, "ts": ts_us,
                    "name": ev["name"], "s": "t", "args": args,
                }
            )
        elif ev["kind"] == KIND_X:
            out.append(
                {
                    "ph": "X", "pid": pid, "tid": tid, "ts": ts_us,
                    "dur": ev["dur_ns"] / 1e3, "name": ev["name"],
                    "args": args,
                }
            )
        elif ev["kind"] == KIND_C:
            # counter sample: args carries the series value (Perfetto
            # renders each C name as its own counter lane)
            out.append(
                {
                    "ph": "C", "pid": pid, "tid": tid, "ts": ts_us,
                    "name": ev["name"], "args": {"value": ev["a0"]},
                }
            )
    # Close spans still open at export with a truncated-flagged E so
    # every B in the file pairs (live decode spans mid-traffic, or spans
    # force-closed conceptually by reset before their end() ran).
    end_us = max(max_ts, 1) / 1e3
    for tid in sorted(open_spans):
        for rec in reversed(open_spans[tid]):
            out.append(
                {
                    "ph": "E", "pid": pid, "tid": tid, "ts": end_us,
                    "name": rec["name"], "args": {"truncated": True},
                }
            )
    meta = []
    for label, tid in tids.items():
        meta.append(
            {
                "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": label},
            }
        )
    meta.append(
        {
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": f"replica{pid}"},
        }
    )
    return meta + out


def export_perfetto(tracers: "Mapping[int, Tracer]", path: str) -> int:
    """Write tracers (pid -> tracer, one per replica) to ``path`` as
    Chrome trace-event JSON.  Returns the number of non-metadata events
    written."""
    events: list[dict] = []
    for pid in sorted(tracers):
        events.extend(_tracer_events(pid, tracers[pid]))
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
    return sum(e["ph"] != "M" for e in events)


# ---------------------------------------------------------------------------
# Validation — run by the tests and by ``chip_smoke.py``.
# ---------------------------------------------------------------------------


def validate_trace(payload: dict) -> dict:
    """Validate a trace-event payload; returns summary stats.

    Checks (each failure raises :class:`TraceValidationError`):
      * top level is ``{"traceEvents": [...]}`` with dict events;
      * per (pid, tid) track, non-metadata event ``ts`` are monotonic
        non-decreasing in file order;
      * per track, ``B``/``E`` pairs match by name, properly nested,
        with no unmatched event left at end of file;
      * ``C`` counter samples carry a numeric args value and, per
        (pid, tid, name) counter series, non-decreasing timestamps
        (the per-track check would let two interleaved series hide a
        regression; the per-series check would not);
      * every track with events has a ``thread_name`` metadata record;
      * at least one slot track (thread name ``slot*``) has events.
    """
    if not isinstance(payload, dict) or not isinstance(
        payload.get("traceEvents"), list
    ):
        raise TraceValidationError("missing traceEvents list")
    events = payload["traceEvents"]
    track_names: dict[tuple, str] = {}
    last_ts: dict[tuple, float] = {}
    stacks: dict[tuple, list[str]] = {}
    counts: dict[tuple, int] = {}
    counter_ts: dict[tuple, float] = {}
    n_spans = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise TraceValidationError(f"event {i} is not a trace event")
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ev["ph"] == "M":
            if ev.get("name") == "thread_name":
                track_names[key] = ev["args"]["name"]
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise TraceValidationError(f"event {i}: bad ts {ts!r}")
        if ts < last_ts.get(key, 0.0):
            raise TraceValidationError(
                f"event {i}: ts not monotonic on track {key} "
                f"({ts} < {last_ts[key]})"
            )
        last_ts[key] = ts
        counts[key] = counts.get(key, 0) + 1
        stack = stacks.setdefault(key, [])
        if ev["ph"] == "B":
            stack.append(ev["name"])
        elif ev["ph"] == "E":
            if not stack:
                raise TraceValidationError(
                    f"event {i}: E {ev.get('name')!r} with no open B on "
                    f"track {key}"
                )
            top = stack.pop()
            if top != ev["name"]:
                raise TraceValidationError(
                    f"event {i}: E {ev['name']!r} closes B {top!r} on "
                    f"track {key}"
                )
            n_spans += 1
        elif ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise TraceValidationError(f"event {i}: X without dur")
            n_spans += 1
        elif ev["ph"] == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in args.values()
            ):
                raise TraceValidationError(
                    f"event {i}: C without numeric args values"
                )
            series = (*key, ev.get("name"))
            if ts < counter_ts.get(series, 0.0):
                raise TraceValidationError(
                    f"event {i}: counter ts not monotonic on series "
                    f"{series} ({ts} < {counter_ts[series]})"
                )
            counter_ts[series] = ts
        elif ev["ph"] not in ("I", "i"):
            raise TraceValidationError(f"event {i}: unknown phase {ev['ph']!r}")
    for key, stack in stacks.items():
        if stack:
            raise TraceValidationError(
                f"unclosed span(s) {stack!r} on track {key}"
            )
    for key in counts:
        if key not in track_names:
            raise TraceValidationError(f"track {key} has no thread_name")
    slot_tracks = [
        k for k, n in track_names.items()
        if n.startswith("slot") and counts.get(k, 0)
    ]
    if counts and not slot_tracks:
        raise TraceValidationError("no nonempty slot track")
    return {
        "events": sum(counts.values()),
        "tracks": len(counts),
        "spans": n_spans,
        "slot_tracks": len(slot_tracks),
        "counter_series": len(counter_ts),
    }


def validate_trace_file(path: str) -> dict:
    with open(path) as f:
        payload = json.load(f)
    return validate_trace(payload)
