"""Prometheus text-exposition rendering for a MetricsRegistry.

Render-on-demand snapshot (no HTTP server — `launch/serve.py` writes
the snapshot to ``--metrics-out`` after draining, and a real deployment
would serve :func:`render` from its scrape endpoint).  Output follows
the text exposition format version 0.0.4: ``# HELP`` / ``# TYPE``
headers, counters suffixed ``_total`` by naming convention, histograms
as cumulative ``_bucket{le=...}`` series plus ``_sum`` / ``_count``.

:func:`parse` is the inverse for sample lines only — enough for tests
and ``chip_smoke.py``'s round-trip to assert the exposition agrees with
``stats_summary()`` on shared counters.
"""

from __future__ import annotations

import math
import re
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .metrics import MetricsRegistry

__all__ = ["render", "write_snapshot", "parse"]

_LABEL_SANITIZE = re.compile(r"([\\\"\n])")


def _fmt_value(v: int | float) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    if math.isnan(v):
        return "NaN"  # canonical exposition spelling (repr gives 'nan')
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _fmt_label(labelname: str, key: object) -> str:
    if isinstance(key, tuple):  # e.g. prefill bucket (N, S) -> "2x64"
        val = "x".join(str(k) for k in key)
    else:
        val = str(key)
    val = _LABEL_SANITIZE.sub(r"\\\1", val).replace("\n", "\\n")
    return f'{labelname}="{val}"'


def render(registry: "MetricsRegistry") -> str:
    from .metrics import Counter, Gauge, Histogram

    lines: list[str] = []
    for m in registry.collect():
        if isinstance(m, Counter):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} counter")
            if m.labelname:
                for key, v in sorted(m.items(), key=lambda kv: str(kv[0])):
                    lines.append(
                        f"{m.name}{{{_fmt_label(m.labelname, key)}}} "
                        f"{_fmt_value(v)}"
                    )
                if not m.items():
                    # expose the zero series so the metric is scrapeable
                    lines.append(f"{m.name} 0")
            else:
                lines.append(f"{m.name} {_fmt_value(m.value)}")
        elif isinstance(m, Gauge):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} gauge")
            lines.append(f"{m.name} {_fmt_value(m.value)}")
        elif isinstance(m, Histogram):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} histogram")
            for bound, cum in m.cumulative_buckets():
                lines.append(
                    f'{m.name}_bucket{{le="{_fmt_value(bound)}"}} {cum}'
                )
            lines.append(f"{m.name}_sum {_fmt_value(m.sum)}")
            lines.append(f"{m.name}_count {m.count}")
    return "\n".join(lines) + "\n"


def write_snapshot(path: str, registry: "MetricsRegistry") -> None:
    with open(path, "w") as f:
        f.write(render(registry))


_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$"
)


def parse(text: str) -> dict[str, float]:
    """Sample lines -> {'name' or 'name{labels}': value}.  Raises
    ValueError on a malformed sample line (comment lines are skipped),
    so a round-trip actually validates the exposition."""
    out: dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"prom parse: bad sample line {lineno}: {line!r}")
        raw = m.group("value")
        if raw == "+Inf":
            val = math.inf
        elif raw == "-Inf":
            val = -math.inf
        else:
            val = float(raw)
        key = m.group("name")
        if m.group("labels"):
            key += "{" + m.group("labels") + "}"
        out[key] = val
    return out
