"""Multi-window SLO burn-rate monitoring (Google-SRE style).

The serving stats already count the ground truth: every deadline'd
request increments ``repro_serve_slo_requests_total`` and, on success,
``repro_serve_slo_met_total`` (a rejected deadline'd request counts as
a miss); structured rejections land in ``repro_serve_rejected_total``
by reason.  The monitor reads those through a :class:`WindowedView` and
computes the classic *burn rate*: the window's error fraction divided
by the error budget ``1 - target``.  Burn 1.0 means "missing exactly as
fast as the SLO allows"; burn 10 on a 99% target means 10% of requests
are missing their deadlines.

Multi-window rule: an alert state requires the burn to exceed its
threshold over **both** the fast and the slow window — the fast window
gives low detection latency, the slow window keeps a two-second blip
from paging (the AND of the two is the standard SRE construction).  The
timescales are configuration (``SloConfig``): production-ish defaults
here, scaled down to sub-second windows by the ``--smoke`` benchmark.

Error events are deadline misses.  When a window holds *no* deadline'd
traffic, the monitor falls back to the rejection fraction over all
terminal outcomes (finished + rejected), so a rejection storm on a
deadline-free deployment still burns.  ``shed`` rejections are excluded
from the error count either way: shedding is the monitor's own
*response* to a burn, and counting it as error would latch CRITICAL
forever.

The optional load-shed feedback (``SloConfig(shed=True)``) is wired by
the engine: while the state is CRITICAL it rejects up to
``shed_max_per_tick`` lowest-priority queued requests per step
(structured ``REJECT_SHED`` results, never silent drops).  Off by
default — monitoring alone must never change a token stream.
"""

from __future__ import annotations

import dataclasses

from .windows import WindowedView

__all__ = ["SloConfig", "BurnRateMonitor", "OK", "WARN", "CRITICAL"]

OK = "OK"
WARN = "WARN"
CRITICAL = "CRITICAL"
_STATE_CODE = {OK: 0, WARN: 1, CRITICAL: 2}

# metric names the monitor reads (defined by repro_torch.serving.stats)
_SLO_TOTAL = "repro_serve_slo_requests_total"
_SLO_MET = "repro_serve_slo_met_total"
_FINISHED = "repro_serve_requests_finished_total"
_REJECTED = "repro_serve_rejected_total"
_SHED_REASON = "shed"


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Burn-rate monitor knobs.

    ``target`` is the SLO attainment objective (0.99 = 99% of
    deadline'd requests meet their deadline).  ``warn_burn`` /
    ``critical_burn`` are burn-rate thresholds that must hold over both
    windows.  ``shed`` arms the CRITICAL feedback: the engine sheds up
    to ``shed_max_per_tick`` lowest-priority queued requests per step
    while CRITICAL (graceful degradation; off by default)."""

    target: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    warn_burn: float = 2.0
    critical_burn: float = 6.0
    shed: bool = False
    shed_max_per_tick: int = 2

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError("windows must be > 0 seconds")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast_window_s must be <= slow_window_s")
        if self.warn_burn <= 0 or self.critical_burn < self.warn_burn:
            raise ValueError(
                "need 0 < warn_burn <= critical_burn"
            )
        if self.shed_max_per_tick < 1:
            raise ValueError("shed_max_per_tick must be >= 1")


class BurnRateMonitor:
    """Evaluates burn over a shared :class:`WindowedView` (whose
    ``window_s`` must cover ``slow_window_s`` — the engine sizes it).

    ``evaluate()`` recomputes the state and returns the full status
    dict; ``last`` keeps the most recent result so read-only consumers
    (the ``/slo`` endpoint, running on the HTTP thread) never race the
    engine's evaluation."""

    def __init__(self, window: WindowedView, cfg: SloConfig):
        if window.window_s + 1e-9 < cfg.slow_window_s:
            raise ValueError(
                f"window retention {window.window_s}s shorter than the "
                f"slow SLO window {cfg.slow_window_s}s"
            )
        self.window = window
        self.cfg = cfg
        self.state = OK
        self.transitions: dict[str, int] = {WARN: 0, CRITICAL: 0}
        self.last: dict = self._status(0.0, 0.0, {}, {})

    # ---- burn math ---------------------------------------------------
    def _window_errors(self, span_s: float) -> dict:
        w = self.window
        total = w.delta(_SLO_TOTAL, span_s)
        met = w.delta(_SLO_MET, span_s)
        rejected = w.delta(_REJECTED, span_s)
        shed = w.delta(_REJECTED, span_s, label=_SHED_REASON)
        if total > 0:
            errors, base = total - met, total
        else:
            # no deadline'd traffic in the window: burn over the
            # non-shed rejection fraction of terminal outcomes
            errors = rejected - shed
            base = w.delta(_FINISHED, span_s) + errors
        rate = errors / base if base > 0 else 0.0
        return {
            "errors": errors,
            "base": base,
            "error_rate": rate,
            "burn": rate / (1.0 - self.cfg.target),
        }

    def _status(self, fast_burn, slow_burn, fast, slow) -> dict:
        return {
            "state": self.state,
            "state_code": _STATE_CODE[self.state],
            "target": self.cfg.target,
            "fast_window_s": self.cfg.fast_window_s,
            "slow_window_s": self.cfg.slow_window_s,
            "fast_burn": round(float(fast_burn), 4),
            "slow_burn": round(float(slow_burn), 4),
            "warn_burn": self.cfg.warn_burn,
            "critical_burn": self.cfg.critical_burn,
            "shed_enabled": self.cfg.shed,
            "windows": {"fast": fast, "slow": slow},
            "transitions": dict(self.transitions),
        }

    def evaluate(self) -> dict:
        """Recompute burn over both windows; returns (and retains as
        ``last``) the status dict.  ``transitioned_to`` is the state
        just entered, or None — the engine's shed/flight hooks fire on
        transitions, not on every CRITICAL tick."""
        fast = self._window_errors(self.cfg.fast_window_s)
        slow = self._window_errors(self.cfg.slow_window_s)
        burn = min(fast["burn"], slow["burn"])  # multi-window AND
        if burn >= self.cfg.critical_burn:
            new = CRITICAL
        elif burn >= self.cfg.warn_burn:
            new = WARN
        else:
            new = OK
        transitioned = new if new != self.state else None
        if transitioned in self.transitions:
            self.transitions[transitioned] += 1
        self.state = new
        out = self._status(fast["burn"], slow["burn"], fast, slow)
        out["transitioned_to"] = transitioned
        self.last = out
        return out
