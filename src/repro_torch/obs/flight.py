"""Flight recorder: anomaly-triggered incident bundles.

The tracer ring already holds "what the engine just did" and the
metrics registry holds "what it added up to" — but both are gone by the
time someone asks what happened before a latency spike.  The flight
recorder snapshots them *at the anomaly*: one timestamped directory per
incident containing

    manifest.json   kind, step, wall time, engine config, free context
                    (SLO state, the spike's measurements, ...)
    metrics.prom    Prometheus text snapshot (``obs/prom.render``)
    trace.json      the tracer ring as Chrome trace-event JSON — only
                    when tracing is on; always passes
                    ``validate_trace_file`` (open spans are closed as
                    truncated by the exporter, counter tracks ride
                    along)

Trigger policy lives with the caller (the engine fires on step-time
spikes vs a warm EWMA, on post-warmup step compiles — the DispatchGuard
invariant tripping — and on SLO CRITICAL transitions);
:class:`SpikeDetector` is the reusable spike half.  The recorder itself
only enforces *debounce*: per-kind ``min_interval_s`` plus the
detector's cooldown mean one sustained anomaly produces one bundle, not
one per step.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from .prom import render
from .windows import Ewma

__all__ = ["SpikeDetector", "FlightRecorder"]


class SpikeDetector:
    """EWMA-baseline spike detection for a scalar step signal.

    ``observe(v)`` returns True when ``v`` exceeds ``factor`` times the
    warm EWMA baseline (at least ``min_samples`` prior observations and
    ``v >= min_value`` — an absolute floor so microsecond-noise on tiny
    models can't trip it).  A firing arms a ``cooldown``-observation
    refractory period, and the spike itself is folded into the EWMA
    (a *sustained* regression raises the baseline and becomes the new
    normal instead of firing forever)."""

    def __init__(
        self,
        *,
        factor: float = 8.0,
        alpha: float = 0.2,
        min_samples: int = 16,
        cooldown: int = 32,
        min_value: float = 0.0,
    ):
        if factor <= 1.0:
            raise ValueError("factor must be > 1")
        if min_samples < 1 or cooldown < 0:
            raise ValueError("min_samples >= 1, cooldown >= 0")
        self.factor = factor
        self.min_samples = min_samples
        self.cooldown = cooldown
        self.min_value = min_value
        self.ewma = Ewma(alpha)
        self._cool = 0
        self.fired = 0

    @property
    def baseline(self) -> float:
        return self.ewma.value

    def observe(self, v: float) -> bool:
        fire = (
            self._cool == 0
            and self.ewma.n >= self.min_samples
            and v >= self.min_value
            and v > self.factor * self.ewma.value
        )
        if fire:
            self.fired += 1
            self._cool = self.cooldown
        elif self._cool:
            self._cool -= 1
        self.ewma.update(v)
        return fire


class FlightRecorder:
    """Writes incident bundles under ``out_dir``.

    ``capture()`` returns the bundle path, or None when the per-kind
    debounce (``min_interval_s``) or the global ``max_bundles`` cap
    suppressed it — a flood of anomalies degrades to a bounded set of
    bundles, never unbounded disk growth."""

    def __init__(
        self,
        out_dir: str,
        *,
        min_interval_s: float = 1.0,
        max_bundles: int = 64,
        clock=time.monotonic,
    ):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.min_interval_s = float(min_interval_s)
        self.max_bundles = int(max_bundles)
        self._clock = clock
        self._last: dict[str, float] = {}
        self._seq = 0
        self.incidents: list[str] = []

    def capture(
        self,
        kind: str,
        *,
        tracer=None,
        metrics=None,
        config: dict | None = None,
        context: dict | None = None,
    ) -> str | None:
        now = self._clock()
        last = self._last.get(kind)
        if last is not None and now - last < self.min_interval_s:
            return None
        if len(self.incidents) >= self.max_bundles:
            return None
        self._last[kind] = now
        self._seq += 1
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        bundle = self.out_dir / f"incident-{stamp}-{self._seq:03d}-{kind}"
        bundle.mkdir(parents=True, exist_ok=True)
        manifest = {
            "kind": kind,
            "seq": self._seq,
            "captured_unix_s": time.time(),
            "config": config or {},
            "context": context or {},
            "files": ["manifest.json"],
        }
        if metrics is not None:
            (bundle / "metrics.prom").write_text(render(metrics))
            manifest["files"].append("metrics.prom")
        if tracer is not None and getattr(tracer, "enabled", False):
            # local import: flight must stay importable without the
            # exporter having been touched (and avoids a cycle)
            from .perfetto import export_perfetto

            export_perfetto({0: tracer}, str(bundle / "trace.json"))
            manifest["files"].append("trace.json")
        with open(bundle / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.write("\n")
        path = str(bundle)
        self.incidents.append(path)
        return path
