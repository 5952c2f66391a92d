"""Observability for the serving stack: tracing spans + typed metrics.
A copy of the JAX package's ``obs`` (numpy and the standard library
only), so the port reads and writes the same traces and metric names.

Three pieces, deliberately dependency-free (numpy only):

  * :mod:`repro_torch.obs.trace` — ring-buffered, ``perf_counter_ns``-stamped
    span tracer (``Tracer`` / ``NULL_TRACER``); the engine records
    per-request lifecycle spans and per-step phase spans through it.
  * :mod:`repro_torch.obs.metrics` — ``MetricsRegistry`` of counters, gauges
    and raw-sample histograms; ``ServeStats`` / ``SwapStats`` /
    ``PrefixStats`` are views over one engine-owned registry.
  * Exporters: :mod:`repro_torch.obs.perfetto` (Chrome trace-event JSON for
    ui.perfetto.dev) and :mod:`repro_torch.obs.prom` (Prometheus text
    exposition).
  * The live plane: :mod:`repro_torch.obs.windows` (rolling-window views
    over a registry), :mod:`repro_torch.obs.slo` (multi-window burn-rate
    monitor), :mod:`repro_torch.obs.flight` (anomaly-triggered incident
    bundles) and :mod:`repro_torch.obs.http` (the ``/metrics`` / ``/healthz``
    / ``/slo`` / ``/vars`` scrape endpoint).

Everything here is host-side and touches no device tensor: the scrape
thread reads host objects only, so it never synchronises the card.
"""

from .flight import FlightRecorder, SpikeDetector
from .http import MetricsServer, attach
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .perfetto import (
    export_perfetto,
    validate_trace,
    validate_trace_file,
)
from .slo import CRITICAL, OK, WARN, BurnRateMonitor, SloConfig
from .trace import NULL_TRACER, NullTracer, Tracer
from .windows import Ewma, WindowedView

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "export_perfetto",
    "validate_trace",
    "validate_trace_file",
    "Ewma",
    "WindowedView",
    "SloConfig",
    "BurnRateMonitor",
    "OK",
    "WARN",
    "CRITICAL",
    "SpikeDetector",
    "FlightRecorder",
    "MetricsServer",
    "attach",
]
