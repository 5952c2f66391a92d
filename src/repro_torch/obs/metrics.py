"""Typed metrics registry: counters, gauges, log-bucketed histograms.

The serving stats objects (`ServeStats` / `SwapStats` / `PrefixStats`)
are views over one shared :class:`MetricsRegistry` per engine.  Two
consumers read the same registry:

  * ``stats_summary()`` — the benchmark-facing dict, which needs *exact*
    values (integer counters stay ints, percentiles come from the raw
    samples, never from bucket interpolation, so BENCH trajectories
    don't move under the refactor);
  * ``repro_torch.obs.prom`` — the Prometheus text exposition, which needs
    the conventional ``_total`` counters and cumulative ``le`` buckets.

Histograms therefore keep **both** the raw sample list (bounded only by
traffic; the engine resets per measurement window) and log-spaced
cumulative buckets.  Registries merge (`MetricsRegistry.merged`) for
replica aggregation: counters add, gauges add, histogram samples
concatenate — so a merged percentile is the true percentile over all
replicas' samples, not an average of averages.

Metric names follow Prometheus conventions (``snake_case``, counters
end in ``_total``, unit suffixes like ``_seconds``).  Label *keys* may
be arbitrary hashables host-side (the prefill bucket label is an
``(N, S)`` tuple so summaries can sort numerically); the prom exporter
stringifies them.
"""

from __future__ import annotations

import math
from typing import Hashable, Iterable

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_buckets",
]


def default_buckets(
    lo: float = 1e-4, hi: float = 64.0, factor: float = 4.0
) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds: lo, lo*factor, ... >= hi.

    The default spans 100 µs .. 64 s in decade-ish steps — wide enough
    for TTFT and queue wait, cheap enough (10 buckets) that ``observe``
    stays a bisect plus one increment.
    """
    bounds = []
    b = lo
    while b < hi:
        bounds.append(b)
        b *= factor
    bounds.append(hi)
    return tuple(bounds)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help


class Counter(_Metric):
    """Monotonic counter, optionally labeled.

    Unlabeled use: ``c.inc()`` / ``c.value``.  Labeled use:
    ``c.inc(3, label=key)`` / ``c.get(key)`` / ``c.items()``.
    Increments preserve Python numeric types (int stays int) so the
    summary dicts keep their exact pre-refactor JSON shapes.
    """

    def __init__(self, name: str, help: str, labelname: str | None = None):
        super().__init__(name, help)
        self.labelname = labelname
        self._value = 0
        self._by_label: dict[Hashable, int | float] = {}

    def inc(self, n: int | float = 1, label: Hashable = None) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc({n}))"
            )
        if label is None:
            self._value += n
        else:
            self._by_label[label] = self._by_label.get(label, 0) + n

    @property
    def value(self) -> int | float:
        # base + labeled: a counter inc'd both ways (or merged from a
        # mixed pair of registries) must not silently drop the unlabeled
        # part. sum() of an empty dict is int 0, preserving int-ness.
        return self._value + sum(self._by_label.values())

    def get(self, label: Hashable) -> int | float:
        return self._by_label.get(label, 0)

    def items(self) -> list[tuple[Hashable, int | float]]:
        return list(self._by_label.items())

    def _merge_from(self, other: "Counter") -> None:
        self._value += other._value
        for k, v in other._by_label.items():
            self._by_label[k] = self._by_label.get(k, 0) + v


class Gauge(_Metric):
    """Last-set value; merge sums (occupancy-style gauges are per-replica
    resource counts, and the merged registry reports fleet totals)."""

    def __init__(self, name: str, help: str):
        super().__init__(name, help)
        self._value: int | float = 0

    def set(self, v: int | float) -> None:
        self._value = v

    def inc(self, n: int | float = 1) -> None:
        self._value += n

    @property
    def value(self) -> int | float:
        return self._value

    def _merge_from(self, other: "Gauge") -> None:
        self._value += other._value


class Histogram(_Metric):
    """Raw-sample histogram with parallel log buckets.

    ``observe`` appends the raw value (exact percentiles for the
    summary) and bumps the first bucket whose bound >= v (cumulative
    counts for the prom exposition).

    Zero-sample contract: the live ``/metrics`` endpoint scrapes
    registries *before* the first request lands, so every statistic is
    well-defined on an empty histogram — ``percentile``/``mean``/
    ``min``/``max`` return 0.0 (never NaN, never raise) and the prom
    exposition renders all-zero bucket/sum/count series.
    """

    def __init__(
        self,
        name: str,
        help: str,
        buckets: Iterable[float] | None = None,
    ):
        super().__init__(name, help)
        self.bounds = tuple(buckets) if buckets is not None else default_buckets()
        self._bucket_counts = [0] * (len(self.bounds) + 1)  # +Inf tail
        self.samples: list[float] = []
        self._sum = 0.0

    def observe(self, v: float) -> None:
        self.samples.append(v)
        self._sum += v
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # bisect_left over bounds
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self._bucket_counts[lo] += 1

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples, np.float64), q))

    def mean(self) -> float:
        return self._sum / len(self.samples) if self.samples else 0.0

    def min(self) -> float:
        return min(self.samples) if self.samples else 0.0

    def max(self) -> float:
        return max(self.samples) if self.samples else 0.0

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, +Inf last."""
        out, acc = [], 0
        for bound, n in zip(self.bounds, self._bucket_counts):
            acc += n
            out.append((bound, acc))
        out.append((math.inf, acc + self._bucket_counts[-1]))
        return out

    def _merge_from(self, other: "Histogram") -> None:
        self.samples.extend(other.samples)
        self._sum += other._sum
        if other.bounds == self.bounds:
            for i, n in enumerate(other._bucket_counts):
                self._bucket_counts[i] += n
        else:  # rebucket through observe-equivalent path
            for v in other.samples:
                lo, hi = 0, len(self.bounds)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if self.bounds[mid] < v:
                        lo = mid + 1
                    else:
                        hi = mid
                self._bucket_counts[lo] += 1


class MetricsRegistry:
    """Ordered name -> metric map with get-or-create registration.

    ``counter``/``gauge``/``histogram`` return the existing metric when
    the name is already registered (with a kind check), so stats *views*
    can bind to a merged registry without re-creating anything.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, *args, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m
        m = cls(name, *args, **kw)
        self._metrics[name] = m
        return m

    def counter(
        self, name: str, help: str = "", labelname: str | None = None
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelname)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Iterable[float] | None = None,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def collect(self) -> list[_Metric]:
        return list(self._metrics.values())

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> _Metric:
        return self._metrics[name]

    def merge_from(self, other: "MetricsRegistry") -> None:
        """Fold ``other``'s metrics into this registry (sum counters and
        gauges, concatenate histogram samples)."""
        for m in other.collect():
            mine = self._metrics.get(m.name)
            if mine is None:
                if isinstance(m, Counter):
                    mine = self.counter(m.name, m.help, m.labelname)
                elif isinstance(m, Gauge):
                    mine = self.gauge(m.name, m.help)
                else:
                    mine = self.histogram(m.name, m.help, buckets=m.bounds)
            mine._merge_from(m)

    @classmethod
    def merged(cls, registries: Iterable["MetricsRegistry"]) -> "MetricsRegistry":
        out = cls()
        for reg in registries:
            out.merge_from(reg)
        return out
