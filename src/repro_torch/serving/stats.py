"""Latency / throughput / occupancy tracking for the serving engine, the
port of the JAX package's ``serving/stats.py`` with the same metric names.

Everything is recorded host-side per engine step into a typed
:class:`repro_torch.obs.MetricsRegistry` — ``ServeStats`` is a *view*
over the registry, not a bag of ad-hoc ints.  The same registry therefore
feeds two consumers that must never disagree:

  * ``summary()`` — the benchmark-facing dict, with the JAX package's
    schema (integer counters stay ints, percentiles are computed from
    the raw histogram samples with ``np.percentile``).
  * ``repro_torch.obs.prom.render`` — the Prometheus text exposition of
    the same counters/gauges/histograms.

Passing an existing registry binds to its metrics (get-or-create), so a
``ServeStats`` view over ``MetricsRegistry.merged(registries)`` sums
several engines.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs import MetricsRegistry

__all__ = ["ServeStats"]


class ServeStats:
    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        c, g, h = reg.counter, reg.gauge, reg.histogram
        self._prefills = c(
            "repro_serve_prefill_calls_total", "prefill calls"
        )
        self._prefill_requests = c(
            "repro_serve_prefill_requests_total",
            "requests admitted via prefill",
        )
        self._prefill_tokens = c(
            "repro_serve_prefill_tokens_total", "prompt tokens prefilled"
        )
        self._prefill_time = c(
            "repro_serve_prefill_seconds_total", "wall seconds in prefill"
        )
        # (N_bucket, S_bucket) label -> how well batched admission packs
        # each (N, S) prefill bucket
        self._bucket_calls = c(
            "repro_serve_prefill_bucket_calls_total",
            "prefill calls per (N, S) bucket",
            labelname="bucket",
        )
        self._bucket_requests = c(
            "repro_serve_prefill_bucket_requests_total",
            "requests admitted per (N, S) bucket",
            labelname="bucket",
        )
        self._decode_time = c(
            "repro_serve_decode_seconds_total", "wall seconds in decode"
        )
        self._decode_steps = c(
            "repro_serve_decode_steps_total", "decode steps"
        )
        self._decode_tokens = c(
            "repro_serve_decode_tokens_total",
            "tokens emitted by decode steps (excludes prefill-emitted)",
        )
        self._generated = c(
            "repro_serve_generated_tokens_total", "all emitted tokens"
        )
        self._step_latency = h(
            "repro_serve_step_latency_seconds", "decode step wall time"
        )
        self._occupancy = h(
            "repro_serve_occupancy_ratio",
            "active slots / max slots per decode step",
            buckets=tuple(2.0 ** -k for k in range(6, 0, -1)) + (1.0,),
        )
        self._finished = c(
            "repro_serve_requests_finished_total", "requests finished"
        )
        # sampler kind (SamplingParams.kind, e.g. "greedy",
        # "temperature+top_k") -> finished requests / emitted tokens
        self._finished_by_sampler = c(
            "repro_serve_finished_by_sampler_total",
            "finished requests per sampler kind",
            labelname="sampler",
        )
        self._tokens_by_sampler = c(
            "repro_serve_tokens_by_sampler_total",
            "emitted tokens per sampler kind",
            labelname="sampler",
        )
        # lifetime-budgeted pages handed back unused because a sequence
        # finished (EOS) before its reservation ran out
        self._pages_reclaimed = c(
            "repro_serve_pages_reclaimed_early_total",
            "reservation pages returned early at finish",
        )
        # prefix cache: prompt tokens served from cached pages vs
        # submitted, shared-page hits, and copy-on-write page splits
        self._prefix_lookups = c(
            "repro_serve_prefix_lookups_total", "radix-tree lookups"
        )
        self._prefix_hit_tokens = c(
            "repro_serve_prefix_hit_tokens_total",
            "prompt tokens served from cached pages",
        )
        self._prefix_prompt_tokens = c(
            "repro_serve_prefix_prompt_tokens_total",
            "prompt tokens submitted through prefix lookup",
        )
        self._prefix_hit_pages = c(
            "repro_serve_prefix_hit_pages_total", "shared pages adopted"
        )
        # the port's one metric beyond the JAX package's: admissions that
        # adopted at least one cached page
        self._prefix_hits = c(
            "repro_serve_prefix_hits_total", "admissions that hit cached pages"
        )
        self._cow_copies = c(
            "repro_serve_cow_copies_total", "copy-on-write page splits"
        )
        # decode-written pages indexed into the radix tree at finish
        # (multi-turn reuse: turn 2's prompt hits turn 1's answer)
        self._decode_indexed = c(
            "repro_serve_decode_indexed_pages_total",
            "decode-written pages indexed at finish",
        )
        # scheduling: preemptions (swap-outs), resumes (swap-ins),
        # structured rejections by reason, SLO attainment for
        # deadline'd requests, and wall-clock TTFT samples
        self._preemptions = c(
            "repro_serve_preemptions_total", "sequences swapped out"
        )
        self._resumes = c(
            "repro_serve_resumes_total", "sequences swapped back in"
        )
        self._rejected = c(
            "repro_serve_rejected_total",
            "structured rejections",
            labelname="reason",
        )
        self._slo_total = c(
            "repro_serve_slo_requests_total", "requests with a deadline"
        )
        self._slo_met = c(
            "repro_serve_slo_met_total", "deadline'd requests that met it"
        )
        self._ttft = h(
            "repro_serve_ttft_seconds", "submit -> first-token wall time"
        )
        self._queue_wait = h(
            "repro_serve_queue_wait_seconds", "submit -> admission wall time"
        )
        # kernel-library builds and loads observed during engine steps
        # (0 after warm-up; analysis.guards.compile_events_total), and
        # the engine's explicit device-to-host fetches
        self._step_compiles = c(
            "repro_serve_step_compiles_total",
            "kernel library builds and loads observed during engine steps",
        )
        self._host_syncs = c(
            "repro_serve_host_syncs_total",
            "explicit device->host fetches (one per prefill call and decode step)",
        )
        # device-memory telemetry, sampled host-side at end of step
        # after the step's host fetch: paged-pool occupancy and
        # fragmentation, COW reserve, host-swap residency, and the
        # backend allocator's view when the platform exposes one
        self._mem_pool_pages = g(
            "repro_mem_pool_pages", "paged-pool capacity in pages"
        )
        self._mem_live_pages = g(
            "repro_mem_pool_live_pages", "pages mapped to live sequences"
        )
        self._mem_cached_pages = g(
            "repro_mem_pool_cached_pages",
            "pages held by the radix prefix cache (reclaimable)",
        )
        self._mem_reserved_pages = g(
            "repro_mem_pool_reserved_pages",
            "pages reserved for admitted sequences' lifetime budgets",
        )
        self._mem_cow_reserve_pages = g(
            "repro_mem_cow_reserve_pages",
            "pages reserved against pending copy-on-write splits",
        )
        self._mem_fragmentation = g(
            "repro_mem_pool_fragmentation_ratio",
            "1 - free/(free+reclaimable) headroom actually admittable",
        )
        self._mem_host_swap_bytes = g(
            "repro_mem_host_swap_bytes",
            "bytes of swapped-out sequences resident in host memory",
        )
        self._mem_device_bytes_in_use = g(
            "repro_mem_device_bytes_in_use",
            "backend allocator bytes in use (0 when unavailable)",
        )
        # live SLO burn-rate monitor state (0=OK 1=WARN 2=CRITICAL) and
        # the burn rates it derived them from; flight-recorder bundles
        self._slo_state = g(
            "repro_slo_state", "burn-rate monitor state (0/1/2)"
        )
        self._slo_burn_fast = g(
            "repro_slo_burn_rate_fast", "fast-window burn rate"
        )
        self._slo_burn_slow = g(
            "repro_slo_burn_rate_slow", "slow-window burn rate"
        )
        self._flight_incidents = c(
            "repro_flight_incidents_total",
            "flight-recorder incident bundles written",
            labelname="kind",
        )

    # ---- attribute views (external readers + tests) -------------------
    @property
    def prefills(self) -> int:
        return self._prefills.value

    @property
    def prefill_requests(self) -> int:
        return self._prefill_requests.value

    @property
    def prefill_tokens(self) -> int:
        return self._prefill_tokens.value

    @property
    def prefill_time(self) -> float:
        return self._prefill_time.value

    @property
    def prefill_buckets(self) -> dict[tuple[int, int], list[int]]:
        return {
            key: [calls, self._bucket_requests.get(key)]
            for key, calls in self._bucket_calls.items()
        }

    @property
    def decode_time(self) -> float:
        return self._decode_time.value

    @property
    def decode_steps(self) -> int:
        return self._decode_steps.value

    @property
    def generated(self) -> int:
        return self._generated.value

    @property
    def finished(self) -> int:
        return self._finished.value

    @property
    def by_sampler(self) -> dict[str, list[int]]:
        return {
            kind: [n, self._tokens_by_sampler.get(kind)]
            for kind, n in self._finished_by_sampler.items()
        }

    @property
    def pages_reclaimed_early(self) -> int:
        return self._pages_reclaimed.value

    @property
    def prefix_hit_tokens(self) -> int:
        return self._prefix_hit_tokens.value

    @property
    def prefix_prompt_tokens(self) -> int:
        return self._prefix_prompt_tokens.value

    @property
    def prefix_hit_pages(self) -> int:
        return self._prefix_hit_pages.value

    @property
    def prefix_lookups(self) -> int:
        return self._prefix_lookups.value

    @property
    def prefix_hits(self) -> int:
        return self._prefix_hits.value

    @property
    def cow_copies(self) -> int:
        return self._cow_copies.value

    @property
    def decode_indexed_pages(self) -> int:
        return self._decode_indexed.value

    @property
    def preemptions(self) -> int:
        return self._preemptions.value

    @property
    def resumes(self) -> int:
        return self._resumes.value

    @property
    def rejected(self) -> dict[str, int]:
        return dict(self._rejected.items())

    @property
    def slo_total(self) -> int:
        return self._slo_total.value

    @property
    def slo_met(self) -> int:
        return self._slo_met.value

    # ---- recording ---------------------------------------------------
    def record_prefill(
        self,
        n_tokens: int,
        dt: float,
        emitted: int = 0,
        *,
        batch: int = 1,
        bucket: tuple[int, int] | None = None,
    ) -> None:
        """One prefill *call* admitting ``batch`` requests at once.
        ``emitted``: tokens generated by this prefill (the argmax of each
        request's last-prompt-token logits is its first output);
        ``bucket``: the (N, S) bucket shape the call ran at.
        """
        self._prefills.inc()
        self._prefill_requests.inc(batch)
        self._prefill_tokens.inc(n_tokens)
        self._prefill_time.inc(dt)
        self._generated.inc(emitted)
        if bucket is not None:
            self._bucket_calls.inc(1, label=tuple(bucket))
            self._bucket_requests.inc(batch, label=tuple(bucket))

    def record_decode_step(
        self, n_active: int, max_slots: int, dt: float
    ) -> None:
        """A decode step emits one token per active slot."""
        self._decode_steps.inc()
        self._decode_time.inc(dt)
        self._generated.inc(n_active)
        self._decode_tokens.inc(n_active)
        self._step_latency.observe(dt)
        self._occupancy.observe(n_active / max_slots)

    def record_finish(
        self,
        n: int = 1,
        *,
        kind: str | None = None,
        tokens: int = 0,
        slo_met: bool | None = None,
    ) -> None:
        self._finished.inc(n)
        if kind is not None:
            self._finished_by_sampler.inc(n, label=kind)
            self._tokens_by_sampler.inc(tokens, label=kind)
        if slo_met is not None:  # the request carried a deadline
            self._slo_total.inc()
            self._slo_met.inc(int(bool(slo_met)))

    def record_reject(self, reason: str, *, had_deadline: bool = False) -> None:
        """A structured rejection (never admitted): too-large geometry
        or queue-wait timeout. A rejected deadline'd request counts as
        an SLO miss (it can never meet its deadline)."""
        self._rejected.inc(1, label=reason)
        if had_deadline:
            self._slo_total.inc()

    def record_preemption(self, n: int = 1) -> None:
        """A running sequence was swapped out to host memory."""
        self._preemptions.inc(n)

    def record_resume(self, n: int = 1) -> None:
        """A swapped-out sequence was swapped back in."""
        self._resumes.inc(n)

    def record_ttft(self, dt: float) -> None:
        """Wall-clock submit -> first-token time for one request."""
        self._ttft.observe(dt)

    def record_queue_wait(self, dt: float) -> None:
        """Wall-clock submit -> admission time for one request."""
        self._queue_wait.observe(dt)

    def record_step_compiles(self, n: int) -> None:
        """Kernel-library builds and loads observed while an engine step
        ran (should stay 0 after warm-up)."""
        self._step_compiles.inc(n)

    def record_host_sync(self, n: int = 1) -> None:
        """One explicit device->host fetch (the batched ``.cpu()`` of a
        prefill call's first tokens or a decode step's next tokens)."""
        self._host_syncs.inc(n)

    def record_memory(
        self,
        *,
        n_pages: int,
        live_pages: int,
        cached_pages: int,
        reserved_pages: int,
        cow_reserve_pages: int,
        host_swap_bytes: int,
        device_bytes_in_use: int = 0,
    ) -> None:
        """End-of-step device-memory snapshot (gauges, last value wins).

        Fragmentation is the share of nominally-usable headroom that is
        *not* immediately admittable: reclaimable prefix-cache pages and
        COW reserve sit between "free" and "live", so a pool can look
        half empty while admission stalls.
        """
        self._mem_pool_pages.set(n_pages)
        self._mem_live_pages.set(live_pages)
        self._mem_cached_pages.set(cached_pages)
        self._mem_reserved_pages.set(reserved_pages)
        self._mem_cow_reserve_pages.set(cow_reserve_pages)
        headroom = n_pages - live_pages
        frag = (
            (cached_pages + cow_reserve_pages) / headroom
            if headroom > 0
            else 0.0
        )
        self._mem_fragmentation.set(round(min(1.0, frag), 4))
        self._mem_host_swap_bytes.set(host_swap_bytes)
        self._mem_device_bytes_in_use.set(device_bytes_in_use)

    def record_slo_state(
        self, state_code: int, fast_burn: float, slow_burn: float
    ) -> None:
        """Latest burn-rate monitor evaluation (0=OK 1=WARN 2=CRITICAL)."""
        self._slo_state.set(state_code)
        self._slo_burn_fast.set(round(fast_burn, 6))
        self._slo_burn_slow.set(round(slow_burn, 6))

    def record_flight_incident(self, kind: str) -> None:
        """One flight-recorder bundle written (labeled by trigger kind)."""
        self._flight_incidents.inc(1, label=kind)

    def record_decode_indexed(self, n_pages: int) -> None:
        """Decode-written full pages indexed into the radix tree when
        their sequence finished."""
        self._decode_indexed.inc(n_pages)

    def record_prefix_lookup(
        self, hit_tokens: int, prompt_tokens: int, hit_pages: int
    ) -> None:
        """One admission's radix-tree walk: ``hit_tokens`` of the
        ``prompt_tokens``-token prompt came from ``hit_pages`` shared
        pages (0s for a miss)."""
        self._prefix_lookups.inc()
        self._prefix_hits.inc(int(hit_pages > 0))
        self._prefix_hit_tokens.inc(hit_tokens)
        self._prefix_prompt_tokens.inc(prompt_tokens)
        self._prefix_hit_pages.inc(hit_pages)

    def record_cow(self, n: int = 1) -> None:
        """Copy-on-write page splits (a slot writing into a shared or
        radix-indexed page got a private device-side copy)."""
        self._cow_copies.inc(n)

    def record_reclaimed(self, n_pages: int) -> None:
        """Reservation pages returned to the admission budget by a
        sequence that finished before exhausting its lifetime budget."""
        self._pages_reclaimed.inc(n_pages)

    # ---- folding -----------------------------------------------------
    @staticmethod
    def _pcts(samples: list[float]) -> dict:
        arr = np.asarray(samples, np.float64)
        if not arr.size:
            return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
        return {
            f"p{q}_ms": round(float(np.percentile(arr, q)) * 1e3, 3)
            for q in (50, 95, 99)
        }

    def summary(self) -> dict:
        lat = np.asarray(self._step_latency.samples, np.float64)
        occ = self._occupancy.samples
        total_time = self.prefill_time + self.decode_time
        # per-token latency: the wall time a decode step spent per emitted
        # token (steps emit one token per active slot)
        return {
            "requests_finished": self.finished,
            "generated_tokens": self.generated,
            # finished requests / emitted tokens per sampler kind
            "by_sampler": {
                kind: {"requests": r, "tokens": t}
                for kind, (r, t) in sorted(self.by_sampler.items())
            },
            "pages_reclaimed_early": self.pages_reclaimed_early,
            # the engine overlays enabled/inserted/evicted/cached gauges
            # when its prefix cache is on (Engine.stats_summary)
            "prefix_cache": {
                "enabled": False,
                "lookups": self.prefix_lookups,
                "hits": self.prefix_hits,
                "hit_tokens": self.prefix_hit_tokens,
                "prompt_tokens": self.prefix_prompt_tokens,
                "hit_pages": self.prefix_hit_pages,
                "hit_rate": round(
                    self.prefix_hit_tokens / self.prefix_prompt_tokens, 4
                )
                if self.prefix_prompt_tokens
                else 0.0,
                "cow_copies": self.cow_copies,
                "decode_indexed_pages": self.decode_indexed_pages,
            },
            # the engine overlays the swap manager's byte/page counters
            # (Engine.stats_summary)
            "preemption": {
                "preemptions": self.preemptions,
                "resumes": self.resumes,
            },
            "rejected": {
                "total": sum(self.rejected.values()),
                **{k: v for k, v in sorted(self.rejected.items())},
            },
            # SLO attainment over deadline'd requests (rejected
            # deadline'd requests count as missed)
            "slo": {
                "with_deadline": self.slo_total,
                "met": self.slo_met,
                "attainment": round(self.slo_met / self.slo_total, 4)
                if self.slo_total
                else 1.0,
            },
            "ttft_ms": self._pcts(self._ttft.samples),
            "queue_wait_ms": self._pcts(self._queue_wait.samples),
            # kernel-library builds/loads seen during steps (0 after
            # warm-up) and explicit host fetches
            "dispatch_guard": {
                "step_compiles": self._step_compiles.value,
                "host_syncs": self._host_syncs.value,
            },
            "prefill_calls": self.prefills,
            "prefill_requests": self.prefill_requests,
            # batched admission quality: requests admitted per prefill
            # call, overall and per (N, S) bucket
            "mean_prefill_batch": round(
                self.prefill_requests / self.prefills, 4
            )
            if self.prefills
            else 0.0,
            "prefill_by_bucket": {
                f"{n}x{s}": {"calls": c, "requests": r}
                for (n, s), (c, r) in sorted(self.prefill_buckets.items())
            },
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": round(self.prefill_time, 6),
            "decode_s": round(self.decode_time, 6),
            "total_s": round(total_time, 6),
            "decode_steps": self.decode_steps,
            "tok_s": round(self.generated / total_time, 2)
            if total_time > 0
            else 0.0,
            # decode throughput counts only decode-step tokens (generated
            # also includes each request's prefill-emitted first token)
            "decode_tok_s": round(
                self._decode_tokens.value / self.decode_time, 2
            )
            if self.decode_time > 0
            else 0.0,
            "prefill_tok_s": round(
                self.prefill_tokens / self.prefill_time, 2
            )
            if self.prefill_time > 0
            else 0.0,
            "p50_token_latency_ms": round(
                float(np.percentile(lat, 50)) * 1e3, 3
            )
            if lat.size
            else 0.0,
            "p95_token_latency_ms": round(
                float(np.percentile(lat, 95)) * 1e3, 3
            )
            if lat.size
            else 0.0,
            "p99_token_latency_ms": round(
                float(np.percentile(lat, 99)) * 1e3, 3
            )
            if lat.size
            else 0.0,
            "mean_occupancy": round(float(np.mean(occ)), 4)
            if occ
            else 0.0,
            "min_occupancy": round(float(np.min(occ)), 4)
            if occ
            else 0.0,
            "max_occupancy": round(float(np.max(occ)), 4)
            if occ
            else 0.0,
        }
