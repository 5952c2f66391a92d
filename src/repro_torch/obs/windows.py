"""Rolling-window views over a :class:`MetricsRegistry`.

The hot path records into plain counters and raw-sample histograms
(`repro_torch.serving.stats`); nothing there knows about time windows.  This
module adds the *live* view on top without touching a single record
call: a :class:`WindowedView` periodically ``tick()``s, diffs the
registry against per-metric cursors (counter values, histogram sample
counts — histogram appends are the only hot-path writes, and a list
slice of the new tail is cheap), and files the deltas into a
time-bucketed ring.  Queries then answer "over the last N seconds":
rates from counter deltas, exact percentiles from the retained raw
sub-samples (never bucket interpolation — a window covering the whole
run reproduces ``stats_summary()``'s percentiles exactly).

Registry identity is part of the protocol: ``Engine.reset_stats()``
swaps in a *fresh* registry object, which semantically restarts the
measurement window — ``tick()`` detects the identity change, drops the
retained buckets and re-seeds the cursors, so a pre-reset sample can
never leak into a post-reset percentile.

Everything here runs on the caller's thread (the engine ticks once per
step, after its host fetch); with monitoring off the engine never
constructs a view, so the off path does zero window work.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Hashable

import numpy as np

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Ewma", "WindowedView", "merged_percentile"]


class Ewma:
    """Exponentially-weighted moving average (fixed ``alpha`` per
    update, no wall-clock dependence — callers update at their own
    cadence).  ``value`` is 0.0 until the first update; ``n`` counts
    updates so consumers can require a warmup."""

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self._v: float | None = None
        self.n = 0

    def update(self, v: float) -> float:
        self._v = (
            float(v)
            if self._v is None
            else self.alpha * float(v) + (1.0 - self.alpha) * self._v
        )
        self.n += 1
        return self._v

    @property
    def value(self) -> float:
        return 0.0 if self._v is None else self._v


class _Bucket:
    __slots__ = ("start", "counts", "samples")

    def __init__(self, start: float):
        self.start = start
        # key: metric name, or (name, str(label)) for labeled counters
        self.counts: dict[Hashable, int | float] = {}
        self.samples: dict[str, list[float]] = {}


class WindowedView:
    """Time-bucketed ring of registry deltas.

    ``registry_fn`` is re-evaluated every tick (the engine passes
    ``lambda: self.metrics``) so the view follows ``reset_stats()``'s
    registry swap.  ``window_s`` is the retention horizon, divided into
    ``n_buckets`` sub-buckets — the resolution of any span-limited
    query (a "last 5 s" rate actually covers the buckets overlapping
    the last 5 s, i.e. up to one bucket width more).
    """

    def __init__(
        self,
        registry_fn: Callable[[], MetricsRegistry],
        *,
        window_s: float = 30.0,
        n_buckets: int = 15,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        if window_s <= 0 or n_buckets < 1:
            raise ValueError("window_s must be > 0 and n_buckets >= 1")
        self._registry_fn = registry_fn
        self._now = now_fn
        self.window_s = float(window_s)
        self.n_buckets = int(n_buckets)
        self.bucket_s = self.window_s / self.n_buckets
        self._buckets: deque[_Bucket] = deque()
        self._cursors: dict[Hashable, int | float] = {}
        self._gauges: dict[str, int | float] = {}
        self._reg: MetricsRegistry | None = None
        self._last_now = 0.0

    # ---- recording (one call per engine step) ------------------------
    def tick(self, now: float | None = None) -> None:
        reg = self._registry_fn()
        if reg is not self._reg:
            # reset_stats() swapped the registry: the measurement window
            # restarted from zero — retained history is for dead metrics
            self._reg = reg
            self._cursors.clear()
            self._buckets.clear()
            self._gauges.clear()
        now = self._now() if now is None else float(now)
        self._last_now = now
        self._roll(now)
        cur = self._buckets[-1]
        for m in reg.collect():
            if isinstance(m, Counter):
                self._take(cur, m.name, m.value)
                for lab, v in m.items():
                    self._take(cur, (m.name, str(lab)), v)
            elif isinstance(m, Histogram):
                c = int(self._cursors.get(m.name, 0))
                n = len(m.samples)
                if n > c:
                    cur.samples.setdefault(m.name, []).extend(
                        m.samples[c:n]
                    )
                    self._cursors[m.name] = n
                elif n < c:  # histogram shrank (shouldn't happen): resync
                    self._cursors[m.name] = n
            elif isinstance(m, Gauge):
                self._gauges[m.name] = m.value

    def _take(self, bucket: _Bucket, key: Hashable, total) -> None:
        prev = self._cursors.get(key, 0)
        if total != prev:
            delta = total - prev
            if delta > 0:  # counters are monotonic; guard anyway
                bucket.counts[key] = bucket.counts.get(key, 0) + delta
            self._cursors[key] = total

    def _roll(self, now: float) -> None:
        if not self._buckets:
            self._buckets.append(_Bucket(now))
            return
        last = self._buckets[-1]
        if now - last.start >= self.window_s + self.bucket_s:
            # ticks stalled for longer than the whole window: everything
            # retained has aged out — restart rather than spinning
            # through hundreds of empty buckets
            self._buckets.clear()
            self._buckets.append(_Bucket(now))
            return
        while now - self._buckets[-1].start >= self.bucket_s:
            self._buckets.append(
                _Bucket(self._buckets[-1].start + self.bucket_s)
            )
        cutoff = now - self.window_s
        while len(self._buckets) > 1 and (
            self._buckets[0].start + self.bucket_s <= cutoff
        ):
            self._buckets.popleft()

    # ---- queries -----------------------------------------------------
    def _included(self, span_s: float | None) -> list[_Bucket]:
        if span_s is None:
            return list(self._buckets)
        cutoff = self._last_now - float(span_s)
        return [
            b for b in self._buckets if b.start + self.bucket_s > cutoff
        ]

    @property
    def covered_s(self) -> float:
        """Wall seconds the retained buckets actually span."""
        if not self._buckets:
            return 0.0
        return max(0.0, self._last_now - self._buckets[0].start)

    def delta(
        self,
        name: str,
        span_s: float | None = None,
        *,
        label: str | None = None,
    ) -> int | float:
        """Counter increase over the window (per-label with ``label``)."""
        key: Hashable = name if label is None else (name, label)
        return sum(b.counts.get(key, 0) for b in self._included(span_s))

    def rate(self, name: str, span_s: float | None = None) -> float:
        """Counter increase per second over the (covered part of the)
        window; 0.0 before the first tick."""
        bs = self._included(span_s)
        if not bs:
            return 0.0
        covered = self._last_now - bs[0].start
        if covered <= 0.0:
            return 0.0
        return float(sum(b.counts.get(name, 0) for b in bs)) / covered

    def samples(
        self, name: str, span_s: float | None = None
    ) -> list[float]:
        out: list[float] = []
        for b in self._included(span_s):
            s = b.samples.get(name)
            if s:
                out.extend(s)
        return out

    def percentile(
        self, name: str, q: float, span_s: float | None = None
    ) -> float:
        """Exact percentile over the window's raw samples (0.0 when the
        window holds none — same empty convention as ``Histogram``)."""
        s = self.samples(name, span_s)
        if not s:
            return 0.0
        return float(np.percentile(np.asarray(s, np.float64), q))

    def gauge(self, name: str, default: int | float = 0) -> int | float:
        """Last value a tick saw for a gauge."""
        return self._gauges.get(name, default)


def merged_percentile(
    views: list[WindowedView], name: str, q: float,
    span_s: float | None = None,
) -> float:
    """Fleet percentile over several views' raw window samples (true
    percentile over the concatenation, not an average of averages —
    the same policy as ``MetricsRegistry.merged``)."""
    s: list[float] = []
    for v in views:
        s.extend(v.samples(name, span_s))
    if not s:
        return 0.0
    return float(np.percentile(np.asarray(s, np.float64), q))
