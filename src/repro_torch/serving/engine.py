"""Continuous-batching serving engine over the block-paged KV cache, the
port of the JAX package's ``serving/engine.py``.

``Engine.submit()`` enqueues requests; each ``step()`` runs one admission
pass over the first ``lookahead`` queued requests (in priority order),
grouping them by power-of-two suffix bucket and prefix-page bucket and
admitting each group (split into power-of-two chunks) with ONE batched
``prefill_paged`` call and ONE host fetch of its first tokens; then ONE
``decode_step_paged`` over every slot (ragged per-slot positions, idle
slots on the trash page) and ONE host fetch of the next-token row; then
finished sequences are evicted so their slot and pages are reusable the
very next step. ``drain()`` steps until the queue and the slots are empty.

Tokens are picked on the device. Plain greedy requests take the argmax
over the padded vocabulary (ties to the lowest id); a step with any
sampled or penalised request runs the sampler (``serving.sampling``) for
every slot, with per-slot params held on the device between admissions
and each row's sample index derived on the device as ``pos - plen + 1``.
The noise depends only on (seed, sample index), so streams do not depend
on slots, steps or batches.

With ``prefix_cache=True`` admission maps cached prompt-prefix pages
straight into the new slot's page table (``serving.prefix``) and prefills
only the uncached suffix; a slot copies a shared page before writing into
it (copy on write). Admission budgets each request's lifetime pages
(prompt + decode growth, minus shared pages, plus one copy-on-write
reserve page for a hit), so an oversubscribed pool never runs dry
mid-decode; a request skipped ``max_skips`` times becomes a barrier
(aging). When a higher-priority request is blocked on slots or pages, the
engine may preempt strictly lower-priority sequences that have run
``preempt_min_steps`` steps: their private pages go to host memory with
an asynchronous copy that overlaps the next decode step, shared pages are
pinned in place (``serving.swap``), and the request re-enters the queue to
resume with the same stream later. Requests that could never fit are
rejected (``REJECT_TOO_LARGE``), and queue-wait timeouts give
``REJECT_TIMEOUT``.

Observability (``repro_torch.obs``, the JAX package's ``obs``): the
stats are ``ServeStats``/``SwapStats``/``PrefixStats`` views over one
metrics registry with the JAX package's metric names; with
``EngineConfig(trace=)`` a span tracer records the admission, prefill,
decode-step and host-fetch phases of every step and each slot's
lifecycle (Perfetto export); ``monitor``/``slo``/``flight_dir`` add the
live plane: a rolling window ticked once per step (``windowed_vars``,
``/vars``), a burn-rate SLO monitor that may shed queued requests, and
incident bundles on step-time spikes, kernel-library builds after
warm-up and SLO CRITICAL transitions. All of it runs on the host after
the step's one fetch; with every option off the step pays one no-op
tracer call a site and never reads the tracer's clock.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.analysis import guards
from repro_torch.analysis.guards import compile_events_total, hot_path
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.obs import (
    NULL_TRACER,
    BurnRateMonitor,
    FlightRecorder,
    MetricsRegistry,
    SloConfig,
    SpikeDetector,
    Tracer,
    WindowedView,
)
from repro_torch.obs.slo import CRITICAL
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.prefix import PrefixCache, PrefixStats
from repro_torch.serving.request import (
    REJECT_SHED,
    REJECT_TIMEOUT,
    REJECT_TOO_LARGE,
    FinishedRequest,
    Request,
    ScheduleParams,
    SequenceState,
)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.stats import ServeStats
from repro_torch.serving.swap import SwapManager, SwapRecord, SwapStats

__all__ = ["Engine", "EngineConfig"]


class EngineConfig:
    """Serving knobs, with the JAX package's fields and defaults:
    ``max_slots`` concurrent sequences of ``max_len`` tokens of
    page-granular KV capacity; ``lookahead`` requests inspected per
    admission pass (default ``2 * max_slots``); ``max_prefill_batch``
    requests per prefill call (0 -> ``max_slots``); ``max_skips`` admission
    passes around a waiting request before it becomes a barrier (0 disables
    aging); ``n_pages`` pool size (0 -> worst case); ``sampler_candidates``
    the sampler's candidate cap C (0 -> the whole vocabulary; requests may
    not ask for top_k beyond it); ``prefix_cache`` radix-tree prefix reuse;
    ``preemption`` and its hysteresis ``preempt_min_steps``.

    ``trace``: span tracing (True for the default ring of 65536 events,
    an int for an explicit capacity). ``monitor``: the live plane, True
    for a 30 s rolling window, a float for a window in seconds. ``slo``:
    a ``repro_torch.obs.SloConfig`` burn-rate monitor (implies monitoring
    and widens the window to its slow timescale). ``flight_dir``: incident
    bundles under that directory when a decode step takes more than
    ``spike_factor`` times its warm EWMA, when a kernel library is built
    or loaded after the first clean step, and on SLO CRITICAL
    transitions. All default off."""

    def __init__(
        self,
        max_slots: int = 8,
        max_len: int = 512,
        *,
        lookahead: int | None = None,
        max_prefill_batch: int = 0,
        n_pages: int = 0,
        sampler_candidates: int = 64,
        max_skips: int = 64,
        prefix_cache: bool = False,
        preemption: bool = True,
        preempt_min_steps: int = 4,
        trace: bool | int = False,
        monitor: bool | float = False,
        slo=None,
        flight_dir: str | None = None,
        spike_factor: float = 8.0,
    ):
        self.max_slots = max_slots
        self.max_len = max_len
        self.n_pages = n_pages
        self.lookahead = lookahead if lookahead is not None else 2 * max_slots
        if self.lookahead < 1:
            raise ValueError("lookahead must be >= 1")
        if max_skips < 0:
            raise ValueError("max_skips must be >= 0 (0 disables aging)")
        self.max_skips = max_skips
        self.prefix_cache = prefix_cache
        self.preemption = preemption
        if preempt_min_steps < 1:
            raise ValueError("preempt_min_steps must be >= 1")
        self.preempt_min_steps = preempt_min_steps
        if trace is not True and trace is not False and int(trace) < 0:
            raise ValueError("trace must be a bool or a capacity >= 0")
        self.trace = trace
        # identity checks, not equality: 1.0 == True in Python, and a
        # 1-second window must not be mistaken for the bool default
        if monitor is not True and monitor is not False and float(monitor) <= 0:
            raise ValueError("monitor must be a bool or a window in seconds > 0")
        self.monitor = monitor
        if slo is not None and not isinstance(slo, SloConfig):
            raise TypeError("slo must be a repro_torch.obs.SloConfig or None")
        self.slo = slo
        self.flight_dir = flight_dir
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        self.spike_factor = spike_factor
        self.max_prefill_batch = max_prefill_batch or max_slots
        if not 1 <= self.max_prefill_batch <= max_slots:
            raise ValueError(
                f"max_prefill_batch {self.max_prefill_batch} must be in "
                f"[1, max_slots={max_slots}]"
            )
        if sampler_candidates < 0:
            raise ValueError("sampler_candidates must be >= 0")
        self.sampler_candidates = sampler_candidates or None

    @property
    def monitor_window_s(self) -> float | None:
        """Rolling-window retention in seconds (None = the live plane is
        off); ``slo`` implies monitoring and widens the window to cover
        its slow burn timescale."""
        if self.monitor is False and self.slo is None:
            return None
        w = 30.0 if self.monitor is True or self.monitor is False else float(self.monitor)
        if self.slo is not None:
            w = max(w, self.slo.slow_window_s)
        return w

    def rounded(self, page: int) -> "EngineConfig":
        """A copy with ``max_len`` rounded up to a whole page."""
        out = copy.copy(self)
        out.max_len = -(-self.max_len // page) * page
        return out


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


class _Plan:
    """One admission pass's outcome: prefill ``groups`` keyed by (suffix
    bucket, prefix-page bucket) holding (request, pinned prefix pages),
    swapped sequences to ``resume`` ((request, pinned pages) in priority
    order), the leftover page ``budget`` and ``free_slots``, and the
    highest-priority request that could not be planned for lack of slots
    or pages (``blocked``, the preemption trigger)."""

    def __init__(self):
        self.groups: dict[tuple[int, int], list[tuple[Request, list[int]]]] = {}
        self.resumes: list[tuple[Request, list[int]]] = []
        self.blocked: Request | None = None
        self.budget = 0
        self.free_slots = 0


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        engine_cfg: EngineConfig | None = None,
        seed: int = 0,
        params: dict[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        """``device`` None means the card (raises without one). ``params``
        is a state dict, e.g. from ``bridge.params_from_jax`` or another
        engine's ``model.state_dict()`` (shared, not copied, where device
        and dtype match); without it the weights are random from ``seed``
        (``transformer.init_model``). A model with SSM layers (the SSM and
        hybrid families) raises ``ValueError``: it is served by the
        fixed-batch ``launch.serve.Server``.

        ``mesh=None`` is the single-device engine. A ``(1, tp)`` mesh
        (``launch.mesh.make_tp_mesh``) serves tensor-parallel, the JAX
        ``Engine``'s ``strategy="tp"``: the model is cut into ``tp``
        shards (``transformer.shard_model``) and the KV pools into one
        pool a shard, each on its mesh device, while the scheduler,
        allocator, page table, prefix cache and sampler state stay once,
        on the host and the first shard's device (``device`` must be None
        or that device). A mesh with positions off the model axis raises:
        serving does not shard by data (``ReplicaRouter`` replicates), and
        an engine holding FSDP-sharded weights is ROADMAP Queue 1 item
        20."""
        tp = 1
        if mesh is not None:
            tp = sharding.Strategy(mesh, "tp").tp_size
            if mesh.size != tp:
                raise ValueError(
                    f"a mesh of shape {mesh.shape}: serving shards over the model axis only, "
                    f"a (1, tp) mesh; {sharding.REFUSED['engine_fsdp']}"
                )
            sharding.check_tp(cfg, tp)
            first = mesh.model_devices()[0]
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
        if cfg.has_ssm:
            raise ValueError(
                f"{cfg.name} has SSM layers, whose state is a row of each "
                "slot and not pages: the paged engine serves attention "
                "families; serve it with launch.serve.Server"
            )
        ecfg = (engine_cfg or EngineConfig()).rounded(cfg.attn_block)
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = T.resolve_device(device)
        self.mesh = mesh
        self.tp = tp
        # devices that really hold the engine: a tp run on one card is
        # reported as such
        self.distinct_devices = mesh.distinct_devices if mesh is not None else 1
        if tp > 1:
            if params is None:
                params = T.init_model(cfg, seed=seed, device=self.device).state_dict()
            self.model = T.shard_model(cfg, mesh, params)
        else:
            self.model = T.init_model(cfg, seed=seed, device=self.device, params=params)
        self.kv = PagedKVCache(
            cfg, ecfg.max_slots, ecfg.max_len, n_pages=ecfg.n_pages,
            device=self.device, mesh=mesh if tp > 1 else None,
        )
        # one metrics registry (ServeStats, SwapStats and PrefixStats are
        # views over it) and a span tracer; with trace off the no-op
        # tracer keeps every call site branch-free
        self.metrics = MetricsRegistry()
        if ecfg.trace:
            self.tracer = Tracer(capacity=(1 << 16) if ecfg.trace is True else int(ecfg.trace))
        else:
            self.tracer = NULL_TRACER
        self._intern_trace_ids()
        self.scheduler = Scheduler(
            ecfg.max_slots,
            on_event=self._sched_event if self.tracer.enabled else None,
        )
        self.stats = ServeStats(self.metrics)
        # Slot-indexed sampling state: host rows written at admission,
        # uploaded once per change (``_samp_dev``) and read by the sampler
        # on the device; ``presence`` ((slots, V+1) bool, column V absorbs
        # padding) tracks each slot's prompt + generated tokens for the
        # repetition penalty and never leaves the device.
        ms = ecfg.max_slots
        self._samp = {
            "temp": np.zeros((ms,), np.float32),
            "top_k": np.zeros((ms,), np.int64),
            "top_p": np.ones((ms,), np.float32),
            "rep": np.ones((ms,), np.float32),
            "key": np.zeros((ms, 2), np.int64),
            # prompt length per slot: the decode step derives each row's
            # sample index on the device as pos - plen + 1
            "plen": np.ones((ms,), np.int64),
        }
        self._samp_dev: dict[str, torch.Tensor] | None = None
        self._presence = torch.zeros(
            (ms, cfg.padded_vocab + 1), dtype=torch.bool, device=self.device
        )
        # slots whose request needs the sampler (noise or presence); an
        # empty set keeps the step on the plain argmax
        self._fancy_slots: set[int] = set()
        self._prefix = PrefixCache(self.kv, metrics=self.metrics) if ecfg.prefix_cache else None
        self.swap = SwapManager(
            self.kv,
            page_in_tree=self._prefix.page_in_tree if self._prefix else None,
            metrics=self.metrics,
        )
        # uid -> (state, record) of swapped-out sequences; their requests
        # wait in the queue and resume (swap in) instead of prefilling
        self._swapped: dict[int, tuple[SequenceState, SwapRecord]] = {}
        # swap records whose copy to host is in flight; finalized after
        # the next decode step
        self._pending_swaps: list[SwapRecord] = []
        self._rejected: list[FinishedRequest] = []
        # slot -> total pages its sequence may ever need (prompt + decode
        # growth, + the copy-on-write reserve); only pages_for_len(plen)
        # are allocated at admission, the rest is a reservation the
        # admission budget must not hand out twice
        self._page_need: dict[int, int] = {}
        # slot -> unconsumed copy-on-write reserve pages (1 for a prefix
        # hit): a split of an adopted shared page must never find the pool
        # dry
        self._cow_reserve: dict[int, int] = {}
        self._uid = 0
        self._step_idx = 0
        # ---- live plane (all opt-in; see EngineConfig) ---------------
        window_s = ecfg.monitor_window_s
        # re-reads self.metrics every tick, so the view follows
        # reset_stats()'s registry swap (the window restarts from zero)
        self._window = (
            WindowedView(lambda: self.metrics, window_s=window_s)
            if window_s is not None
            else None
        )
        # serialises window ticks and reads between the step loop and
        # the scrape thread (obs.http handlers), which touch host objects
        # only, never a device tensor
        self._obs_lock = threading.Lock()
        self._slo_mon = BurnRateMonitor(self._window, ecfg.slo) if ecfg.slo is not None else None
        self._flight = FlightRecorder(ecfg.flight_dir) if ecfg.flight_dir else None
        self._spike = SpikeDetector(factor=ecfg.spike_factor) if self._flight is not None else None
        # kernel-library captures arm after the first clean step: the
        # first launches of each kernel build or load its library
        self._flight_armed = False
        self._roofline: dict | None = None

    @property
    def paged_impl(self) -> str:
        """The paged decode read: the CUDA kernel on the card, the plain
        gather on the CPU (``kernels.ops`` picks by device). A
        tensor-parallel engine runs it on every shard: where the JAX
        package's ``paged_impl_for_mesh`` falls back to the gather at
        tp > 1 (a ``pallas_call`` has no GSPMD partitioning rule), each
        shard here holds whole pools of its own kv heads, the shard-local
        form that function's docstring names as the fix."""
        return "cuda" if self.device.type == "cuda" else "plain"

    # ---- observability -----------------------------------------------
    def _intern_trace_ids(self) -> None:
        """Resolve every track and name id the engine records, so the hot
        path does no string work (the no-op tracer returns 0 for all)."""
        tr = self.tracer
        self._tk_admission = tr.track("engine:admission")
        self._tk_prefill = tr.track("engine:prefill")
        self._tk_decode = tr.track("engine:decode")
        self._tk_sync = tr.track("engine:host_sync")
        self._tk_queue = tr.track("queue")
        self._tk_slot = [tr.track(f"slot{i}") for i in range(self.ecfg.max_slots)]
        self._nm_admission = tr.name("admission")
        self._nm_prefill = tr.name("prefill")
        self._nm_decode_step = tr.name("decode_step")
        self._nm_host_sync = tr.name("host_sync")
        self._nm_queued = tr.name("queued")
        self._nm_decode = tr.name("decode")
        self._nm_finished = tr.name("finished")
        self._nm_rejected = tr.name("rejected")
        self._nm_swap_out = tr.name("swap_out")
        self._nm_swap_in = tr.name("swap_in")
        self._nm_preempt = tr.name("preempt")
        self._nm_cow = tr.name("cow_split")
        self._nm_prefix_match = tr.name("prefix_match")
        self._nm_roofline = tr.name("roofline")
        # counter lanes, one sample each a step: pool occupancy, queue
        # depth, running slots
        self._tk_counters = tr.track("counters")
        self._nm_ctr_live = tr.name("pool_live_pages")
        self._nm_ctr_queue = tr.name("queue_depth")
        self._nm_ctr_running = tr.name("running_slots")
        self._sched_names = {
            kind: tr.name(kind) for kind in ("submit", "admit", "resume", "remove")
        }

    def _sched_event(self, kind: str, req: Request) -> None:
        """Scheduler hook -> queue-track instants (bound only when tracing
        is on)."""
        self.tracer.instant(self._tk_queue, self._sched_names[kind], req.uid)

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
        """Enqueue one request; returns its uid. A request that could never
        fit finishes with ``reject_reason REJECT_TOO_LARGE``, delivered by
        the next ``step()``. A sampled request may not ask for top_k beyond
        the sampler's candidate cap (``ValueError``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cap = self.ecfg.sampler_candidates
        if (
            sampling is not None
            and cap
            and not sampling.is_greedy  # greedy rows never read top_k
            and sampling.top_k > cap
        ):
            raise ValueError(
                f"top_k {sampling.top_k} exceeds the engine's sampler "
                f"candidate cap {cap} (EngineConfig(sampler_candidates=...))"
            )
        self._uid += 1
        req = Request(
            self._uid,
            prompt,
            max_new_tokens,
            eos_id=eos_id,
            sampling=sampling or SamplingParams(),
            schedule=schedule or ScheduleParams(),
            submit_s=time.perf_counter(),
        )
        if (
            prompt.size > self.ecfg.max_len
            or self._lifetime_pages(req) > self.kv.n_pages - 1
        ):
            self._rejected.append(self._reject(req, REJECT_TOO_LARGE))
            return self._uid
        self.scheduler.submit(req)
        return self._uid

    def _reject(self, req: Request, reason: str) -> FinishedRequest:
        self.stats.record_reject(
            reason,
            # shed requests are left out of SLO accounting: shedding is the
            # burn-rate monitor's response to misses, and counting sheds
            # as new misses would latch CRITICAL
            had_deadline=req.schedule.deadline_s is not None and reason != REJECT_SHED,
        )
        self.tracer.instant(self._tk_queue, self._nm_rejected, req.uid)
        return FinishedRequest(
            uid=req.uid,
            prompt=req.prompt,
            tokens=np.zeros((0,), np.int32),
            finish_reason="rejected",
            reject_reason=reason,
            admit_step=-1,
            finish_step=self._step_idx,
            schedule=req.schedule,
        )

    def _expire_waiting(self, finished: list[FinishedRequest]) -> None:
        """Queue-wait timeouts. Swapped-out sequences are exempt: they
        have run already and always resume."""
        now = time.perf_counter()
        for req in list(self.scheduler.waiting):
            wait = req.schedule.max_queue_wait_s
            if (
                wait is not None
                and req.uid not in self._swapped
                and now - req.submit_s > wait
            ):
                self.scheduler.remove(req)
                finished.append(self._reject(req, REJECT_TIMEOUT))

    # ---- sampler packing ---------------------------------------------
    def _bind_sampler(self, slot: int, sp: SamplingParams, plen: int) -> None:
        """Write one request's sampling params into its slot's rows. The
        base key depends only on the request's seed."""
        self._samp["temp"][slot] = sp.temperature
        self._samp["top_k"][slot] = sp.top_k
        self._samp["top_p"][slot] = sp.top_p
        self._samp["rep"][slot] = sp.repetition_penalty
        self._samp["key"][slot] = sampling_lib.base_key_data(sp.seed)
        self._samp["plen"][slot] = plen
        self._samp_dev = None  # rows changed: upload at next use
        if sp.is_plain:
            self._fancy_slots.discard(slot)
        else:
            self._fancy_slots.add(slot)

    @hot_path
    def _decode_sampler(self) -> dict[str, torch.Tensor]:
        """The slot-indexed sampler params on the device, uploaded once
        per admission and reused by every decode step until the next."""
        if self._samp_dev is None:
            self._samp_dev = {
                k: guards.device_put(v, self.device) for k, v in self._samp.items()
            }
        return self._samp_dev

    def _prefill_sampler(self, states: list[SequenceState]) -> dict[str, torch.Tensor]:
        """Per-request params of one admission group (sample index 0: the
        first emitted token) and the slots they landed in."""
        rows = [st_.slot for st_ in states]
        samp = {
            k: guards.device_put(v[rows], self.device) for k, v in self._samp.items()
        }
        samp["idx"] = torch.zeros((len(rows),), dtype=torch.int64, device=self.device)
        samp["slots"] = guards.device_put(np.asarray(rows, np.int64), self.device)
        samp["presence"] = self._presence
        return samp

    # ---- admission ---------------------------------------------------
    def _bucket(self, plen: int) -> int:
        """Pad prompt lengths to power-of-two page counts."""
        nb = min(_next_pow2(self.kv.pages_for_len(plen)), self.kv.pages_per_seq)
        return nb * self.kv.page

    def _pre_bucket(self, n_pages: int) -> int:
        """Pad prefix-hit page counts to powers of two (0 = a miss, which
        takes the plain prefill)."""
        if n_pages == 0:
            return 0
        return min(_next_pow2(n_pages), self.kv.pages_per_seq)

    def _lifetime_pages(self, req: Request) -> int:
        """Worst-case pages a request can ever touch (the last generated
        token is returned but never written back)."""
        return self.kv.pages_for_len(
            min(req.prompt.size + req.max_new_tokens - 1, self.ecfg.max_len)
        )

    def _alloc(self, slot: int, pos: int) -> None:
        """Grow ``slot`` to cover ``pos``, evicting LRU parked prefix pages
        first if the free list would run dry: parked pages never block a
        live sequence."""
        if self._prefix is not None:
            need = pos // self.kv.page + 1 - self.kv.pages_owned(slot)
            if need > self.kv.free_pages:
                self._prefix.ensure_free(need)
        self.kv.alloc_upto(slot, pos)

    def _ensure_writable(self, slot: int, pos: int) -> None:
        """Copy on write: a slot must own the page its next token writes
        into alone. A shared page (mapped into another slot) or an indexed
        page (its bytes are a tree key's value) is first replaced by a
        fresh page holding a device copy. The fresh page comes out of the
        slot's copy-on-write reservation, which keeps ``_reserved_pages``
        exact. Page-granular hits share only full pages behind the write
        position, so this fires on outside pins, not on the main path."""
        if self._prefix is None:
            return
        li = pos // self.kv.page
        if li >= self.kv.pages_owned(slot):
            return
        p = int(self.kv.page_table[slot, li])
        if self.kv.refcount(p) > 1 or self._prefix.page_in_tree(p):
            self._prefix.ensure_free(1)
            self.kv.cow_page(slot, li, keep=self._prefix.page_in_tree)
            if self._cow_reserve.get(slot, 0) > 0:
                self._cow_reserve[slot] -= 1
                self._page_need[slot] -= 1
            self.stats.record_cow()
            self.tracer.instant(self._tk_slot[slot], self._nm_cow, p)

    def _reserved_pages(self) -> int:
        """Pages promised to active sequences but not yet allocated."""
        return sum(
            max(0, need - self.kv.pages_owned(slot))
            for slot, need in self._page_need.items()
        )

    def _match_and_pin(self, req: Request) -> tuple[list[int], int]:
        """Walk the radix tree for ``req``'s prompt and pin every hit page
        (parked pages become live, live pages gain a reference), so
        nothing the plan relies on is evicted before the admission lands.
        Returns (pinned pages, admission cost in pages): the fresh pages
        the request still needs, plus the parked pages the pin took out of
        the evictable budget, plus one copy-on-write reserve page for a
        hit. Resumes come through the same walk: their pinned shared
        prefix is still indexed. A request whose lifetime fills every
        allocatable page cannot carry the reserve and declines the hit;
        resumes never decline (their pinned pages were never copied)."""
        lifetime = self._lifetime_pages(req)
        if self._prefix is None:
            return [], lifetime
        pages = self._prefix.match(req.prompt)
        if (
            pages
            and req.uid not in self._swapped
            and lifetime + 1 > self.kv.n_pages - 1
        ):
            return [], lifetime
        parked = 0
        for p in pages:
            if self.kv.is_cached(p):
                self.kv.take_cached(p)
                parked += 1
            else:
                self.kv.incref(p)
        reserve = 1 if pages else 0
        return pages, lifetime - len(pages) + parked + reserve

    def _unpin(self, pages: list[int]) -> None:
        for p in pages:
            self.kv.unpin(p)

    def _plan_admission(self) -> _Plan:
        """One bounded-lookahead pass over the waiting queue in priority
        order: group the admissible requests by (suffix bucket, prefix
        bucket), or list them as resumes, within the slot and lifetime-page
        budget. The budget counts only uncached pages and counts parked
        pages as evictable headroom. A request that does not fit is
        skipped, unless it has been admitted around ``max_skips`` times,
        which stops the pass at it. The highest-priority request that
        could not be planned is ``plan.blocked``."""
        plan = _Plan()
        plan.free_slots = self.scheduler.num_free_slots
        plan.budget = self.kv.free_pages - self._reserved_pages()
        if self._prefix is not None:
            plan.budget += self._prefix.evictable_pages()
        skipped: list[tuple[int, Request]] = []
        last_planned = -1
        for wi, req in enumerate(self.scheduler.peek_admissible(self.ecfg.lookahead)):
            if plan.free_slots == 0:
                if plan.blocked is None:
                    plan.blocked = req
                break
            pages, cost = self._match_and_pin(req)
            if cost > plan.budget:
                self._unpin(pages)
                skipped.append((wi, req))
                if plan.blocked is None:
                    plan.blocked = req
                if (
                    self.ecfg.max_skips
                    and self.scheduler.skip_count(req) >= self.ecfg.max_skips
                ):
                    break  # starved request: stop admitting around it
                continue
            if req.uid in self._swapped:
                plan.resumes.append((req, pages))
            else:
                suffix = req.prompt.size - len(pages) * self.kv.page
                key = (self._bucket(suffix), self._pre_bucket(len(pages)))
                plan.groups.setdefault(key, []).append((req, pages))
            plan.free_slots -= 1
            plan.budget -= cost
            last_planned = wi
        self.scheduler.note_skips([r for wi, r in skipped if wi < last_planned])
        return plan

    def _unplan(self, plan: _Plan) -> None:
        """Drop every pin a plan holds (it is recomputed after a
        preemption changed the resources)."""
        for plans in plan.groups.values():
            for _, pages in plans:
                self._unpin(pages)
        for _, pages in plan.resumes:
            self._unpin(pages)

    # ---- preemption --------------------------------------------------
    def _swap_pin_len(self, state: SequenceState) -> int:
        """How many of a victim's leading pages swap-out would pin in place
        (shared with other slots) rather than copy, capped at the radix
        match limit so a resume's re-match covers them."""
        owned = self.kv.owned_pages(state.slot)
        cap = min((state.plen - 1) // self.kv.page, len(owned))
        n = 0
        while n < cap and self.kv.refcount(owned[n]) > 1:
            n += 1
        return n

    def _maybe_preempt(self, plan: _Plan) -> bool:
        """Try to unblock ``plan.blocked`` by swapping out running sequences
        of strictly lower priority (lowest priority first, longest
        remaining first within a class) that have run ``preempt_min_steps``
        steps since their last admit or resume. Victims are swapped only
        if together they unblock the request. Returns True if anything was
        swapped (the caller re-plans)."""
        req = plan.blocked
        if req is None or not self.ecfg.preemption:
            return False
        pr = req.schedule.priority
        cands = [
            st_
            for st_ in self.scheduler.active()
            if st_.request.schedule.priority < pr
            and self._step_idx - st_.resume_step >= self.ecfg.preempt_min_steps
        ]
        if not cands:
            return False
        cands.sort(key=lambda st_: (st_.request.schedule.priority, -st_.remaining))
        pages, cost = self._match_and_pin(req)
        self._unpin(pages)
        budget, free_slots = plan.budget, plan.free_slots
        victims: list[SequenceState] = []
        for v in cands:
            if free_slots >= 1 and cost <= budget:
                break
            # swapping v frees its private pages (copied or parked) and
            # its unallocated reservation; only its pinned prefix stays
            need = self._page_need.get(v.slot, self.kv.pages_owned(v.slot))
            budget += need - self._swap_pin_len(v)
            free_slots += 1
            victims.append(v)
        if free_slots < 1 or cost > budget:
            return False
        for v in victims:
            self._preempt(v)
        return True

    def _preempt(self, state: SequenceState) -> None:
        """Swap one running sequence out to host memory and re-queue its
        request."""
        slot = state.slot
        uid = state.request.uid
        # close the slot's decode span before its pages move; a1 = 1 marks
        # the close as a preemption, not a finish
        self.tracer.end(self._tk_slot[slot], self._nm_decode, uid, 1)
        self.tracer.instant(self._tk_slot[slot], self._nm_preempt, uid)
        record = self.swap.swap_out(slot, max_pin=(state.plen - 1) // self.kv.page)
        self.tracer.instant(self._tk_slot[slot], self._nm_swap_out, uid, record.n_host)
        self.scheduler.evict(slot)
        self._page_need.pop(slot, None)
        self._cow_reserve.pop(slot, None)
        self._fancy_slots.discard(slot)
        state.preemptions += 1
        self._swapped[state.request.uid] = (state, record)
        self._pending_swaps.append(record)
        self.scheduler.submit(state.request)
        self.stats.record_preemption()

    def _resume(self, req: Request, pages: list[int]) -> SequenceState:
        """Swap a preempted sequence back in: adopt the re-matched resident
        prefix (``pages``, pinned by the plan), allocate fresh pages for
        the rest, copy the host pages in, and rebind the slot's sampler
        rows and presence row. The KV bytes round-trip unchanged and the
        noise depends only on (seed, sample index), so the stream goes on
        as if it had never stopped."""
        state, record = self._swapped.pop(req.uid)
        if self.scheduler.resume(state, request=req) is None:
            raise RuntimeError("resume planned without a free slot")
        slot = state.slot
        self.tracer.instant(self._tk_slot[slot], self._nm_swap_in, req.uid, record.n_host)
        self.tracer.begin(self._tk_slot[slot], self._nm_decode, req.uid)
        reserve = 1 if pages else 0
        self._page_need[slot] = self._lifetime_pages(req) + reserve
        self._cow_reserve[slot] = reserve
        self._bind_sampler(slot, req.sampling, state.plen)
        if pages:
            self.kv.adopt(slot, pages)
        self._alloc(slot, record.n_logical * self.kv.page - 1)
        self.swap.swap_in(record, slot, n_resident=len(pages))
        state.resume_step = self._step_idx
        state.prefix_hit_tokens = max(
            state.prefix_hit_tokens, len(pages) * self.kv.page
        )
        if not req.sampling.is_plain:
            seen = np.concatenate([req.prompt, np.asarray(state.generated, np.int32)])
            self._presence[slot] = False
            self._presence[slot, guards.device_put(seen.astype(np.int64), self.device)] = True
        self.stats.record_resume()
        return state

    # ---- prefill -----------------------------------------------------
    def _admit_group(
        self, plans: list[tuple[Request, list[int]]], s: int, npre: int
    ) -> list[SequenceState]:
        """One batched prefill call over tokens (N, S) and one host fetch
        of the N first tokens. Pages are allocated for the real prompts
        only; bucket padding scatters to the trash page. Hit pages are
        adopted into the slot's page table (the plan's pin becomes the
        slot's reference) and only the uncached suffix is prefilled; the
        prompt's pages are indexed in the radix tree after the call's
        host fetch, so a duplicate prompt in the same call never reads
        pages the call is still writing."""
        nb = len(plans)
        n_pages = s // self.kv.page
        tokens = np.zeros((nb, s), np.int32)
        plens = np.empty((nb,), np.int32)
        rows = np.zeros((nb, n_pages), np.int32)
        pre_rows = np.zeros((nb, max(npre, 1)), np.int32)
        pre_lens = np.zeros((nb,), np.int32)
        # whole prompts, for the sampler's presence rows
        full_tokens = np.zeros((nb, npre * self.kv.page + s), np.int32)
        full_plens = np.empty((nb,), np.int32)
        states = []
        t_admit = time.perf_counter()
        for i, (req, pages) in enumerate(plans):
            state = self.scheduler.admit(self._step_idx, request=req)
            state.resume_step = self._step_idx
            hit = len(pages) * self.kv.page
            state.prefix_hit_tokens = hit
            # queue wait: submit -> this admission pass, an X span on the
            # queue track (perf_counter and perf_counter_ns share a clock)
            wait = t_admit - req.submit_s
            self.stats.record_queue_wait(wait)
            self.tracer.complete(
                self._tk_queue, self._nm_queued,
                int(req.submit_s * 1e9), int(wait * 1e9), req.uid,
            )
            if pages:
                self.tracer.instant(
                    self._tk_slot[state.slot], self._nm_prefix_match, req.uid, len(pages)
                )
            reserve = 1 if pages else 0
            self._page_need[state.slot] = self._lifetime_pages(req) + reserve
            self._cow_reserve[state.slot] = reserve
            self._bind_sampler(state.slot, req.sampling, state.plen)
            if pages:
                self.kv.adopt(state.slot, pages)
            self._alloc(state.slot, state.plen - 1)
            suffix = req.prompt[hit:]
            tokens[i, : suffix.size] = suffix
            plens[i] = suffix.size
            rows[i] = self.kv.suffix_row(state.slot, len(pages), state.plen, n_pages)
            pre_rows[i, : len(pages)] = pages
            pre_lens[i] = hit
            full_tokens[i, : state.plen] = req.prompt
            full_plens[i] = state.plen
            self.stats.record_prefix_lookup(hit, state.plen, len(pages))
            states.append(state)
        t0 = time.perf_counter()
        t0_ns = self.tracer.begin(self._tk_prefill, self._nm_prefill, s, nb)
        dev = self.device
        args = (
            self.cfg,
            self.model,
            guards.device_put(tokens, dev),
            guards.device_put(plens, dev),
            self.kv.buffers,
            guards.device_put(rows, dev),
        )
        kw = {}
        if npre:
            kw = dict(
                prefix_rows=guards.device_put(pre_rows, dev),
                prefix_lens=guards.device_put(pre_lens, dev),
            )
        # a group of plain requests takes the argmax; one sampled or
        # penalised request switches the whole group to the sampler (its
        # plain peers still get the exact argmax through temp = 0 rows)
        if any(not req.sampling.is_plain for req, _ in plans):
            toks_dev, self.kv.buffers, self._presence = T.prefill_paged(
                *args,
                **kw,
                full_tokens=guards.device_put(full_tokens, dev),
                full_plens=guards.device_put(full_plens, dev),
                sampler=self._prefill_sampler(states),
                sampler_candidates=self.ecfg.sampler_candidates,
            )
        else:
            logits, self.kv.buffers = T.prefill_paged(*args, **kw)
            toks_dev = torch.argmax(logits, dim=-1)
        # the one batched fetch of this group's first tokens
        toks = guards.device_get(toks_dev)
        dt = time.perf_counter() - t0
        self.tracer.end(self._tk_prefill, self._nm_prefill, s, nb)
        self.stats.record_host_sync()
        now = time.perf_counter()
        self.stats.record_prefill(
            int(plens.sum()), dt, emitted=len(states), batch=len(states), bucket=(nb, s)
        )
        dur_ns = int(dt * 1e9)
        for i, state in enumerate(states):
            state.generated.append(int(toks[i]))
            state.pos = state.plen
            state.first_token_s = now
            self.stats.record_ttft(now - state.request.submit_s)
            # the slot's prefill interval, then its decode span, open
            # until finish or preemption
            slot_track = self._tk_slot[state.slot]
            self.tracer.complete(slot_track, self._nm_prefill, t0_ns, dur_ns, s, nb)
            self.tracer.begin(slot_track, self._nm_decode, state.request.uid)
            if self._prefix is not None:
                # index the prompt's full pages (hits refresh their LRU
                # tick; new full pages become matchable now their contents
                # are written)
                self._prefix.insert(state.request.prompt, self.kv.page_table[state.slot])
        return states

    # ---- stepping ----------------------------------------------------
    @hot_path
    @torch.no_grad()
    def step(self) -> list[FinishedRequest]:
        """One scheduler iteration: admit (batched, possibly after
        preempting) -> resume swapped sequences -> decode -> evict. Runs
        under ``torch.no_grad()``: the model's parameters are trainable,
        and no step (prefill, decode, sampler, swap) keeps an autograd
        graph.

        On the card the launches are asynchronous: the ``decode_step``
        span covers the host's launches and the wait inside its
        ``host_sync`` span, where the fetch of the next-token row is the
        step's one synchronisation."""
        finished: list[FinishedRequest] = list(self._rejected)
        self._rejected.clear()
        self._expire_waiting(finished)
        # each phase span carries the kernel-library builds and loads seen
        # while it ran (a1 of its E event): 0 after warm-up
        c0 = compile_events_total()
        tr = self.tracer
        tr.begin(self._tk_admission, self._nm_admission)
        plan = self._plan_admission()
        if self._maybe_preempt(plan):
            # the resources changed: recompute the whole pass so the
            # blocked high-priority request plans first
            self._unplan(plan)
            plan = self._plan_admission()
        n_admitted = len(plan.resumes)
        for req, pages in plan.resumes:
            self._resume(req, pages)
        cap = self.ecfg.max_prefill_batch
        for (s, npre), plans in plan.groups.items():
            i = 0
            while i < len(plans):
                # greedy power-of-two chunks: 3 -> 2 + 1
                n = 1 << (min(len(plans) - i, cap).bit_length() - 1)
                for state in self._admit_group(plans[i : i + n], s, npre):
                    n_admitted += 1
                    if state.done:  # max_new_tokens == 1 or instant EOS
                        finished.append(self._finish(state))
                i += n
        c1 = compile_events_total()
        tr.end(self._tk_admission, self._nm_admission, n_admitted, c1 - c0)

        # a prompt that already fills its slot cannot take a decode step
        for st_ in list(self.scheduler.active()):
            if st_.pos >= self.ecfg.max_len:
                finished.append(self._finish(st_, reason="capacity"))

        active = self.scheduler.active()
        decode_dt: float | None = None
        if active:
            tokens = np.zeros((self.ecfg.max_slots,), np.int32)
            positions = np.zeros((self.ecfg.max_slots,), np.int32)
            for st_ in active:
                self._ensure_writable(st_.slot, st_.pos)
                self._alloc(st_.slot, st_.pos)
                tokens[st_.slot] = st_.generated[-1]
                positions[st_.slot] = st_.pos
            t0 = time.perf_counter()
            tr.begin(self._tk_decode, self._nm_decode_step, len(active))
            dev = self.device
            pos_dev = guards.device_put(positions, dev)
            args = (
                self.cfg,
                self.model,
                self.kv.buffers,
                guards.device_put(tokens, dev),
                pos_dev,
                self.kv.device_table(),
            )
            if self._fancy_slots:
                samp = self._decode_sampler()
                toks_dev, self.kv.buffers, self._presence = T.decode_step_paged(
                    *args,
                    sampler={
                        **samp,
                        # the request in each slot has emitted
                        # pos - plen + 1 tokens (idle slots are ignored)
                        "idx": pos_dev.long() - samp["plen"] + 1,
                        "presence": self._presence,
                    },
                    sampler_candidates=self.ecfg.sampler_candidates,
                )
            else:
                logits, self.kv.buffers = T.decode_step_paged(*args)
                toks_dev = torch.argmax(logits, dim=-1)
            # THE one host fetch per decode step: every slot's next token
            tr.begin(self._tk_sync, self._nm_host_sync)
            nxt = guards.device_get(toks_dev)
            tr.end(self._tk_sync, self._nm_host_sync, len(active))
            dt = decode_dt = time.perf_counter() - t0
            tr.end(
                self._tk_decode, self._nm_decode_step, len(active),
                compile_events_total() - c1,
            )
            self.stats.record_host_sync()
            self.stats.record_decode_step(len(active), self.ecfg.max_slots, dt)
            for st_ in active:
                st_.pos += 1
                st_.generated.append(int(nxt[st_.slot]))
                if st_.done:
                    finished.append(self._finish(st_))
                elif st_.pos >= self.ecfg.max_len:
                    finished.append(self._finish(st_, reason="capacity"))
        # the decode step has been overlapping the swap-outs' copies to
        # host: land them and drop the device staging
        for record in self._pending_swaps:
            self.swap.finalize(record)
        self._pending_swaps.clear()
        step_compiles = compile_events_total() - c0
        self.stats.record_step_compiles(step_compiles)
        self._step_idx += 1
        self._observe_step(decode_dt, len(active), step_compiles)
        return finished

    # ---- live telemetry (end of step, on the host) -------------------
    def _observe_step(
        self, decode_dt: float | None, n_active: int, step_compiles: int
    ) -> None:
        """End-of-step observability, after the step's one fetch. With
        tracing, monitoring and the flight recorder all off this is three
        no-op tracer calls and an early return: no clock read."""
        tr = self.tracer
        kv = self.kv
        live = kv.n_pages - kv.free_pages - kv.cached_pages
        tr.counter(self._tk_counters, self._nm_ctr_live, live)
        tr.counter(self._tk_counters, self._nm_ctr_queue, len(self.scheduler.waiting))
        tr.counter(self._tk_counters, self._nm_ctr_running, n_active)
        if self._flight is not None:
            if step_compiles == 0:
                self._flight_armed = True
            elif self._flight_armed:
                # a kernel library was built or loaded mid-traffic
                self._capture_incident("dispatch_guard_trip", {"step_compiles": step_compiles})
            if decode_dt is not None:
                baseline = self._spike.baseline
                if self._spike.observe(decode_dt):
                    self._capture_incident(
                        "step_time_spike",
                        {
                            "decode_step_s": decode_dt,
                            "baseline_s": baseline,
                            "factor": self.ecfg.spike_factor,
                        },
                    )
        if self._window is None:
            return
        self._sample_memory(live)
        with self._obs_lock:
            self._window.tick()
            status = self._slo_mon.evaluate() if self._slo_mon is not None else None
        if status is None:
            return
        self.stats.record_slo_state(status["state_code"], status["fast_burn"], status["slow_burn"])
        if status["state"] == CRITICAL and self.ecfg.slo.shed:
            self._shed_queued(self.ecfg.slo.shed_max_per_tick)
        if status["transitioned_to"] == CRITICAL and self._flight is not None:
            self._capture_incident("slo_critical", {"slo": status})

    def _device_bytes_in_use(self) -> int:
        """The caching allocator's bytes in use on the card; 0 on the CPU,
        which has no allocator statistics (as the JAX package reports 0
        where its backend has none)."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.memory_stats(self.device)["allocated_bytes.all.current"])

    def _sample_memory(self, live_pages: int) -> None:
        """Per-step memory gauges: pool occupancy and fragmentation, the
        copy-on-write reserve, host-swap residency, and the allocator's
        bytes in use."""
        host_bytes = sum(rec.n_host for _, rec in self._swapped.values()) * self.swap.page_bytes
        self.stats.record_memory(
            n_pages=self.kv.n_pages,
            live_pages=live_pages,
            cached_pages=self.kv.cached_pages,
            reserved_pages=self._reserved_pages(),
            cow_reserve_pages=sum(self._cow_reserve.values()),
            host_swap_bytes=host_bytes,
            device_bytes_in_use=self._device_bytes_in_use(),
        )

    def _shed_queued(self, max_n: int) -> int:
        """CRITICAL-state load shed: reject up to ``max_n`` waiting
        requests of the lowest priority class present, newest first.
        Swapped-out sequences are exempt (they always resume). Sheds are
        structured ``REJECT_SHED`` results delivered by the next
        ``step()``."""
        cands = [r for r in self.scheduler.waiting if r.uid not in self._swapped]
        if not cands:
            return 0
        lowest = min(r.schedule.priority for r in cands)
        shed = [r for r in cands if r.schedule.priority == lowest]
        shed = shed[-max_n:][::-1]
        for req in shed:
            self.scheduler.remove(req)
            self._rejected.append(self._reject(req, REJECT_SHED))
        return len(shed)

    def _capture_incident(self, kind: str, context: dict) -> str | None:
        path = self._flight.capture(
            kind,
            tracer=self.tracer,
            metrics=self.metrics,
            config=self._config_dict(),
            context={**context, "step": self._step_idx},
        )
        if path is not None:
            self.stats.record_flight_incident(kind)
        return path

    def _config_dict(self) -> dict:
        e = self.ecfg
        return {
            "max_slots": e.max_slots,
            "max_len": e.max_len,
            "n_pages": self.kv.n_pages,
            "lookahead": e.lookahead,
            "max_prefill_batch": e.max_prefill_batch,
            "prefix_cache": e.prefix_cache,
            "preemption": e.preemption,
            "paged_impl": self.paged_impl,
            "spike_factor": e.spike_factor,
            "slo": dataclasses.asdict(e.slo) if e.slo else None,
        }

    def windowed_vars(self, span_s: float | None = None) -> dict:
        """Live rolling-window stats (the ``/vars`` endpoint). Safe from
        the scrape thread: ticks and reads under the obs lock. A window
        covering the whole run agrees with ``stats_summary()``'s
        percentiles."""
        if self._window is None:
            return {"enabled": False}
        with self._obs_lock:
            w = self._window
            w.tick()

            def pcts(name: str) -> dict:
                return {
                    f"p{q}_ms": round(w.percentile(name, q, span_s) * 1e3, 3)
                    for q in (50, 95, 99)
                }

            out = {
                "enabled": True,
                "window_s": w.window_s,
                "covered_s": round(w.covered_s, 3),
                "ttft_ms": pcts("repro_serve_ttft_seconds"),
                "queue_wait_ms": pcts("repro_serve_queue_wait_seconds"),
                "token_latency_ms": pcts("repro_serve_step_latency_seconds"),
                "tok_s": round(w.rate("repro_serve_generated_tokens_total", span_s), 2),
                "admitted_per_s": round(w.rate("repro_serve_prefill_requests_total", span_s), 3),
                "finished_per_s": round(w.rate("repro_serve_requests_finished_total", span_s), 3),
                "rejected_per_s": round(w.rate("repro_serve_rejected_total", span_s), 3),
                "queue_depth": len(self.scheduler.waiting),
                "running_slots": len(self.scheduler.active()),
                "memory": {
                    "pool_pages": w.gauge("repro_mem_pool_pages"),
                    "live_pages": w.gauge("repro_mem_pool_live_pages"),
                    "cached_pages": w.gauge("repro_mem_pool_cached_pages"),
                    "reserved_pages": w.gauge("repro_mem_pool_reserved_pages"),
                    "fragmentation": w.gauge("repro_mem_pool_fragmentation_ratio"),
                    "host_swap_bytes": w.gauge("repro_mem_host_swap_bytes"),
                    "device_bytes_in_use": w.gauge("repro_mem_device_bytes_in_use"),
                },
            }
            if self._slo_mon is not None:
                out["slo"] = dict(self._slo_mon.last)
            return out

    def window_samples(self, name: str, span_s: float | None = None) -> list[float]:
        """Raw window samples of one histogram, read under the obs lock."""
        if self._window is None:
            return []
        with self._obs_lock:
            self._window.tick()
            return self._window.samples(name, span_s)

    def slo_state(self) -> dict:
        """Read-only burn-rate status (the ``/slo`` endpoint). The step
        loop is the only evaluator: a scrape returns the last result and
        never consumes a state transition."""
        if self._slo_mon is None:
            return {"enabled": False}
        return {"enabled": True, **self._slo_mon.last}

    def roofline(self) -> dict:
        """Roofline terms of the decode step on this engine's device (lazy,
        cached): its FLOPs and bytes counted by ``analysis.roofline.count``
        over one run of ``decode_step_paged``, the time lower bounds at the
        H100's peaks for the model's dtype, and the dominant bottleneck;
        the JAX package's record and keys.

        The counted step writes nothing real: every slot's page row is the
        trash page, which only masked reads ever see (as an idle slot's
        decode write). Every slot sits at the last position of ``max_len``,
        so each reads its whole schedule, as the JAX record's HLO counts
        the step whatever the positions. The one run costs a decode step
        and one host read a paged-attention call (the keys it sees).

        On a tensor-parallel engine the record is one device's, as the JAX
        record of its per-device program is: the count of the whole step
        (every shard's heads and slices, and the joins' collectives, by the
        walker's rule) divided by ``tp``, the shards being symmetric."""
        if self._roofline is not None:
            return self._roofline
        from repro_torch.analysis.roofline import HW, count, roofline_terms

        ms = self.ecfg.max_slots
        dev = self.device
        tokens = guards.device_put(np.zeros((ms,), np.int32), dev)
        positions = guards.device_put(np.full((ms,), self.ecfg.max_len - 1, np.int32), dev)
        trash_table = torch.zeros_like(self.kv.device_table())
        with torch.no_grad():
            _, cost = count(lambda: T.decode_step_paged(
                self.cfg, self.model, self.kv.buffers, tokens, positions, trash_table
            ))
        cost = cost.divided(self.tp)
        terms = roofline_terms(cost, HW().for_dtype(self.cfg.dtype))
        self._roofline = {
            "available": True,
            "flops": cost.flops,
            "bytes_accessed": cost.bytes_accessed,
            "collective_bytes": cost.total_collective_bytes,
            "arithmetic_intensity": round(cost.flops / cost.bytes_accessed, 4)
            if cost.bytes_accessed
            else 0.0,
            "bottleneck": terms["bottleneck"],
            "compute_s": terms["compute_s"],
            "memory_s": terms["memory_s"],
            "collective_s": terms["collective_s"],
        }
        # annotate the trace: a0 = intensity x 1000, a1 = bottleneck
        self.tracer.instant(
            self._tk_decode,
            self._nm_roofline,
            int(self._roofline["arithmetic_intensity"] * 1000),
            {"compute": 0, "memory": 1, "collective": 2}.get(terms["bottleneck"], 3),
        )
        return self._roofline

    def _finish(
        self, state: SequenceState, *, reason: str | None = None
    ) -> FinishedRequest:
        # pages the lifetime budget reserved but the sequence never
        # touched go back to the admission budget with the need entry
        need = self._page_need.pop(state.slot, 0)
        self._cow_reserve.pop(state.slot, None)
        reclaimed = max(0, need - self.kv.pages_owned(state.slot))
        # close the slot's decode span (opened at admission or resume)
        slot_track = self._tk_slot[state.slot]
        self.tracer.end(slot_track, self._nm_decode, state.request.uid, len(state.generated))
        self.tracer.instant(slot_track, self._nm_finished, state.request.uid)
        if self._prefix is not None:
            # index the decode-written pages too (full blocks only): the
            # next turn of a conversation prompts with this history. The
            # last generated token is never written back.
            written = np.concatenate(
                [state.request.prompt, np.asarray(state.generated[:-1], np.int32)]
            )
            self.stats.record_decode_indexed(
                self._prefix.insert(written, self.kv.page_table[state.slot])
            )
        self.scheduler.evict(state.slot)
        # indexed pages are parked instead of freed: a future prompt
        # sharing the prefix maps them back in, eviction reclaims them
        self.kv.free_slot(
            state.slot,
            keep=None if self._prefix is None else self._prefix.page_in_tree,
        )
        self._fancy_slots.discard(state.slot)
        if reclaimed:
            self.stats.record_reclaimed(reclaimed)
        if reason is None:
            eos = state.request.eos_id
            reason = (
                "eos"
                if eos is not None and state.generated[-1] == eos
                else "length"
            )
        req = state.request
        fin = FinishedRequest(
            uid=req.uid,
            prompt=req.prompt,
            tokens=np.asarray(state.generated, np.int32),
            finish_reason=reason,
            admit_step=state.admit_step,
            finish_step=self._step_idx,
            prefix_hit_tokens=state.prefix_hit_tokens,
            preemptions=state.preemptions,
            ttft_s=(
                state.first_token_s - req.submit_s
                if state.first_token_s is not None
                else None
            ),
            e2e_s=time.perf_counter() - req.submit_s,
            schedule=req.schedule,
        )
        self.stats.record_finish(
            kind=req.sampling.kind, tokens=len(state.generated), slo_met=fin.slo_met
        )
        return fin

    def drain(self, max_steps: int | None = None) -> list[FinishedRequest]:
        """Step until every submitted request has finished (including
        structured rejections awaiting delivery)."""
        out: list[FinishedRequest] = []
        steps = 0
        while not self.scheduler.idle or self._rejected:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps and not self.scheduler.idle:
                raise RuntimeError(f"drain did not converge in {max_steps} steps")
        return out

    def reset_stats(self) -> None:
        """Zero the per-run counters; the radix tree's contents stay.

        The registry and the tracer ring reset together: a fresh registry
        is built and every stats view rebinds to it (one attribute store
        each, so a concurrent scrape renders the old or the new registry,
        never a mix), and the tracer closes its open spans (counted as
        truncated; their later ``end()`` calls are no-ops) before
        clearing its ring."""
        reg = MetricsRegistry()
        self.stats = ServeStats(reg)
        self.swap.stats = SwapStats(reg)
        if self._prefix is not None:
            self._prefix.stats = PrefixStats(reg)
        self.metrics = reg
        self.tracer.reset()

    def stats_summary(self) -> dict:
        """``ServeStats.summary()`` with the swap counters, the prefix
        cache's tree counters (when on) and the roofline record; an engine
        on a mesh adds ``tp`` and ``distinct_devices``."""
        out = self.stats.summary()
        out["preemption"].update(self.swap.stats.snapshot())
        if self._prefix is not None:
            out["prefix_cache"].update(self._prefix.stats.snapshot())
            out["prefix_cache"]["enabled"] = True
            out["prefix_cache"]["cached_pages"] = self.kv.cached_pages
            # keep the prom gauge in step with the pool
            self._prefix.stats.set_cached_pages(self.kv.cached_pages)
        out["roofline"] = self.roofline()
        if self.mesh is not None:  # the JAX schema plus the mesh's size
            out["tp"] = self.tp
            out["distinct_devices"] = self.distinct_devices
        return out

    def export_perfetto(self, path: str) -> int:
        """Write the trace ring as Chrome trace-event JSON (needs
        ``EngineConfig(trace=...)``); returns the events written."""
        return self.tracer.export_perfetto(path)
