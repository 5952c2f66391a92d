"""Data-parallel replica routing: one logical engine over N replicas, the
port of the JAX package's ``serving/router.py`` at ``tp = 1``.

Serving requests are independent, so data parallelism is N complete
engines with a thin router in front, not a batch-sharded step: each
replica admits, preempts and finishes on its own clock. ``ReplicaRouter``
exposes the ``Engine`` surface (``submit`` / ``step`` / ``drain``) and
routes each request to the least-loaded replica (outstanding requests,
ties to the lowest index, so single-request traffic is deterministic).
Streams are bit-identical to one engine's: every replica holds the same
weights, and the sampler's noise is keyed on (request seed, sample index),
never on the slot, batch or replica that serves it.

Router uids are replica-independent: ``submit`` returns a router-level uid
and finished results are re-tagged with it.

Replicas may share one card (``devices`` defaults to it N times): then
they share the weights too, and each holds its own KV pools.
Tensor-parallel replicas (``tp > 1``) need distribution, which the port
does not have yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.obs import MetricsRegistry, export_perfetto
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.prefix import PrefixStats
from repro_torch.serving.request import FinishedRequest, ScheduleParams
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.stats import ServeStats
from repro_torch.serving.swap import SwapStats

__all__ = ["ReplicaRouter"]


class ReplicaRouter:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        replicas: int,
        tp: int = 1,
        engine_cfg: EngineConfig | None = None,
        seed: int = 0,
        params: dict[str, torch.Tensor] | None = None,
        devices: list | None = None,
    ):
        """One full engine on each of ``devices`` (torch devices, default
        the card ``replicas`` times; "cpu" entries run the plain
        versions). Replica 0 takes ``params`` (a state dict) or draws its
        weights from ``seed``; every other replica takes replica 0's state
        dict, shared where the device is the same."""
        if replicas < 1 or tp < 1:
            raise ValueError("replicas and tp must be >= 1")
        if tp > 1:
            raise ValueError(
                f"tp={tp}: tensor-parallel replicas need distribution, which the port "
                "does not have yet (ROADMAP Queue 1 item 9)"
            )
        if devices is None:
            devices = [T.resolve_device(None)] * replicas
        devices = list(devices)
        if len(devices) < replicas:
            raise ValueError(f"{replicas} replicas need {replicas} devices, have {len(devices)}")
        self.replicas = replicas
        self.tp = tp
        self.engines: list[Engine] = []
        for r in range(replicas):
            if r:
                params = self.engines[0].model.state_dict()
            self.engines.append(
                Engine(cfg, engine_cfg=engine_cfg, seed=seed, params=params, device=devices[r])
            )
        self._outstanding = [0] * replicas
        # router uid -> (replica, replica-local uid); local uid -> router
        self._placed: dict[int, tuple[int, int]] = {}
        self._router_uid: list[dict[int, int]] = [{} for _ in range(replicas)]
        self._uid = 0

    # ---- request intake ----------------------------------------------
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        *,
        eos_id: int | None = None,
        sampling: SamplingParams | None = None,
        schedule: ScheduleParams | None = None,
    ) -> int:
        """Enqueue on the least-loaded replica; returns a router uid."""
        r = min(range(self.replicas), key=lambda i: (self._outstanding[i], i))
        local = self.engines[r].submit(
            prompt, max_new_tokens, eos_id=eos_id, sampling=sampling, schedule=schedule
        )
        self._uid += 1
        self._outstanding[r] += 1
        self._placed[self._uid] = (r, local)
        self._router_uid[r][local] = self._uid
        return self._uid

    # ---- stepping ----------------------------------------------------
    def step(self) -> list[FinishedRequest]:
        """Step every replica once; finished results carry router uids."""
        out: list[FinishedRequest] = []
        for r, eng in enumerate(self.engines):
            for fin in eng.step():
                uid = self._router_uid[r].pop(fin.uid, fin.uid)
                self._placed.pop(uid, None)
                self._outstanding[r] -= 1
                out.append(dataclasses.replace(fin, uid=uid))
        return out

    @property
    def idle(self) -> bool:
        return all(n == 0 for n in self._outstanding)

    def drain(self, max_steps: int | None = None) -> list[FinishedRequest]:
        out: list[FinishedRequest] = []
        steps = 0
        while not self.idle:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps and not self.idle:
                raise RuntimeError(f"drain did not converge in {max_steps} steps")
        return out

    # ---- observability ------------------------------------------------
    def merged_metrics(self) -> MetricsRegistry:
        """One registry over every replica: counters and gauges sum,
        histogram samples concatenate, so merged percentiles are true
        fleet percentiles, not averages of averages."""
        for eng in self.engines:
            if eng._prefix is not None:
                eng._prefix.stats.set_cached_pages(eng.kv.cached_pages)
        return MetricsRegistry.merged([eng.metrics for eng in self.engines])

    def stats_summary(self) -> dict:
        """Fleet-level ``Engine.stats_summary()``: the same schema over the
        merged registry, plus ``per_replica`` (each replica's own
        summary). Every replica runs the same decode step, so replica 0's
        roofline stands for the fleet."""
        merged = self.merged_metrics()
        out = ServeStats(merged).summary()
        out["preemption"].update(SwapStats(merged).snapshot())
        if any(eng._prefix is not None for eng in self.engines):
            out["prefix_cache"].update(PrefixStats(merged).snapshot())
            out["prefix_cache"]["enabled"] = True
            out["prefix_cache"]["cached_pages"] = sum(
                eng.kv.cached_pages for eng in self.engines if eng._prefix is not None
            )
        out["roofline"] = self.engines[0].roofline()
        out["per_replica"] = [eng.stats_summary() for eng in self.engines]
        return out

    def windowed_vars(self, span_s: float | None = None) -> dict:
        """Fleet ``/vars``: true merged percentiles over every replica's
        retained window samples, summed rates and depths, plus each
        replica's own view."""
        per = [eng.windowed_vars(span_s) for eng in self.engines]
        live = [p for p in per if p.get("enabled")]
        if not live:
            return {"enabled": False, "per_replica": per}

        def pcts(name: str) -> dict:
            s: list[float] = []
            for eng in self.engines:
                s.extend(eng.window_samples(name, span_s))
            if not s:
                return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
            arr = np.asarray(s, np.float64)
            return {f"p{q}_ms": round(float(np.percentile(arr, q)) * 1e3, 3) for q in (50, 95, 99)}

        return {
            "enabled": True,
            "replicas": self.replicas,
            "window_s": max(p["window_s"] for p in live),
            "covered_s": max(p["covered_s"] for p in live),
            "ttft_ms": pcts("repro_serve_ttft_seconds"),
            "queue_wait_ms": pcts("repro_serve_queue_wait_seconds"),
            "token_latency_ms": pcts("repro_serve_step_latency_seconds"),
            "tok_s": round(sum(p["tok_s"] for p in live), 2),
            "admitted_per_s": round(sum(p["admitted_per_s"] for p in live), 3),
            "finished_per_s": round(sum(p["finished_per_s"] for p in live), 3),
            "rejected_per_s": round(sum(p["rejected_per_s"] for p in live), 3),
            "queue_depth": sum(p["queue_depth"] for p in live),
            "running_slots": sum(p["running_slots"] for p in live),
            "per_replica": per,
        }

    def slo_state(self) -> dict:
        """Fleet ``/slo``: the worst replica's state fronts the response
        (an alert on any replica is an alert on the service)."""
        per = [eng.slo_state() for eng in self.engines]
        live = [p for p in per if p.get("enabled")]
        if not live:
            return {"enabled": False, "per_replica": per}
        worst = max(live, key=lambda p: p.get("state_code", 0))
        return {
            "enabled": True,
            "state": worst.get("state", "OK"),
            "state_code": worst.get("state_code", 0),
            "per_replica": per,
        }

    def reset_stats(self) -> None:
        for eng in self.engines:
            eng.reset_stats()

    def export_perfetto(self, path: str) -> int:
        """One Chrome trace file over every replica: replica r's tracks
        appear under process ``pid=r``."""
        return export_perfetto({r: eng.tracer for r, eng in enumerate(self.engines)}, path)
