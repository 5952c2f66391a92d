"""Continuous-batching serving engine over the block-paged KV cache: the
greedy path of the JAX package's ``serving/engine.py``.

``Engine.submit()`` enqueues requests; each ``step()`` runs one admission
pass over the first ``lookahead`` queued requests, grouping them by
power-of-two page bucket and admitting each same-bucket group (split into
power-of-two chunks) with ONE batched ``prefill_paged`` call and ONE host
fetch of its first tokens; then ONE ``decode_step_paged`` over every slot
(ragged per-slot positions, idle slots on the trash page) and ONE host
fetch of the next-token row; then finished sequences are evicted so their
slot and pages are reusable the very next step. ``drain()`` steps until
the queue and the slots are empty.

Admission budgets each request's lifetime pages (prompt + decode growth),
so an oversubscribed pool never runs dry mid-decode; a request skipped
``max_skips`` times becomes a barrier (aging). Requests that could never
fit are rejected (``REJECT_TOO_LARGE``), and queue-wait timeouts give
``REJECT_TIMEOUT``. Tokens are the argmax over the padded vocabulary,
ties to the lowest id.

Not ported yet, and refused with ``NotImplementedError``: sampling other
than plain greedy, the prefix cache, priorities other than 0 (with every
request at priority 0 preemption can never fire, so ``preemption=True``
stays the default), tracing, live monitoring, SLO shedding and the flight
recorder.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import (
    REJECT_TIMEOUT,
    REJECT_TOO_LARGE,
    FinishedRequest,
    Request,
    ScheduleParams,
    SequenceState,
)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler

__all__ = ["Engine", "EngineConfig"]


class EngineConfig:
    """Serving knobs, with the JAX package's fields and defaults:
    ``max_slots`` concurrent sequences of ``max_len`` tokens of
    page-granular KV capacity; ``lookahead`` requests inspected per
    admission pass (default ``2 * max_slots``); ``max_prefill_batch``
    requests per prefill call (0 -> ``max_slots``); ``max_skips`` admission
    passes around a waiting request before it becomes a barrier (0 disables
    aging); ``n_pages`` pool size (0 -> worst case).
    ``sampler_candidates``, ``preempt_min_steps`` and ``spike_factor`` are
    kept for the interface and not used by the greedy path."""

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
        self.trace = trace
        self.monitor = monitor
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

    def unported(self) -> list[str]:
        """The options set here that the port's engine does not serve yet,
        each with the ROADMAP item that brings it."""
        out = []
        if self.prefix_cache:
            out.append("prefix_cache (ROADMAP Queue 1 item 2)")
        for name in ("trace", "monitor", "slo", "flight_dir"):
            if getattr(self, name) not in (False, None):
                out.append(f"{name} (ROADMAP Queue 1 item 4)")
        return out

    def rounded(self, page: int) -> "EngineConfig":
        """A copy with ``max_len`` rounded up to a whole page."""
        out = copy.copy(self)
        out.max_len = -(-self.max_len // page) * page
        return out


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        engine_cfg: EngineConfig | None = None,
        seed: int = 0,
        params: dict[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
    ):
        """``device`` None means the card (raises without one). ``params``
        is a state dict, e.g. from ``bridge.params_from_jax``; without it
        the weights are random from ``seed`` (``transformer.init_model``)."""
        ecfg = (engine_cfg or EngineConfig()).rounded(cfg.attn_block)
        unported = ecfg.unported()
        if unported:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: " + ", ".join(unported)
            )
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = T.resolve_device(device)
        self.model = T.init_model(cfg, seed=seed, device=self.device)
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        self.kv = PagedKVCache(
            cfg, ecfg.max_slots, ecfg.max_len, n_pages=ecfg.n_pages,
            device=self.device,
        )
        self.scheduler = Scheduler(ecfg.max_slots)
        self._rejected: list[FinishedRequest] = []
        # slot -> total pages its sequence may ever need (prompt + decode
        # growth); only pages_for_len(plen) are allocated at admission, the
        # rest is a reservation the admission budget must not hand out twice
        self._page_need: dict[int, int] = {}
        self._uid = 0
        self._step_idx = 0
        self.stats = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> dict:
        return {
            "finished": 0,
            "rejected": 0,
            "generated_tokens": 0,
            "prefill_calls": 0,
            "prefill_tokens": 0,
            "prefill_s": 0.0,
            "decode_steps": 0,
            "decode_tokens": 0,
            "decode_step_s": [],
            "ttft_s": [],
        }

    def reset_stats(self) -> None:
        self.stats = self._fresh_stats()

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
        the next ``step()``."""
        if sampling is not None and not sampling.is_plain:
            raise NotImplementedError(
                "only plain greedy decoding is ported (sampling: ROADMAP "
                "Queue 1 item 1)"
            )
        schedule = schedule or ScheduleParams()
        if schedule.priority != 0:
            raise NotImplementedError(
                "only priority 0 is ported (priorities and preemption: "
                "ROADMAP Queue 1 item 3)"
            )
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._uid += 1
        req = Request(
            self._uid,
            prompt,
            max_new_tokens,
            eos_id=eos_id,
            schedule=schedule,
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
        self.stats["rejected"] += 1
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
        now = time.perf_counter()
        for req in list(self.scheduler.waiting):
            wait = req.schedule.max_queue_wait_s
            if wait is not None and now - req.submit_s > wait:
                self.scheduler.remove(req)
                finished.append(self._reject(req, REJECT_TIMEOUT))

    # ---- admission ---------------------------------------------------
    def _bucket(self, plen: int) -> int:
        """Pad prompt lengths to power-of-two page counts."""
        nb = min(_next_pow2(self.kv.pages_for_len(plen)), self.kv.pages_per_seq)
        return nb * self.kv.page

    def _lifetime_pages(self, req: Request) -> int:
        """Worst-case pages a request can ever touch (the last generated
        token is returned but never written back)."""
        return self.kv.pages_for_len(
            min(req.prompt.size + req.max_new_tokens - 1, self.ecfg.max_len)
        )

    def _reserved_pages(self) -> int:
        return sum(
            max(0, need - self.kv.pages_owned(slot))
            for slot, need in self._page_need.items()
        )

    def _plan_admission(self) -> dict[int, list[Request]]:
        """One bounded-lookahead pass: group the admissible requests by
        prefill bucket within the slot and lifetime-page budget. A request
        that does not fit is skipped, unless it has been admitted around
        ``max_skips`` times, which stops the pass at it."""
        groups: dict[int, list[Request]] = {}
        free_slots = self.scheduler.num_free_slots
        budget = self.kv.free_pages - self._reserved_pages()
        skipped: list[tuple[int, Request]] = []
        last_planned = -1
        for wi, req in enumerate(self.scheduler.peek_admissible(self.ecfg.lookahead)):
            if free_slots == 0:
                break
            cost = self._lifetime_pages(req)
            if cost > budget:
                skipped.append((wi, req))
                if (
                    self.ecfg.max_skips
                    and self.scheduler.skip_count(req) >= self.ecfg.max_skips
                ):
                    break  # starved request: stop admitting around it
                continue
            groups.setdefault(self._bucket(req.prompt.size), []).append(req)
            free_slots -= 1
            budget -= cost
            last_planned = wi
        self.scheduler.note_skips([r for wi, r in skipped if wi < last_planned])
        return groups

    def _admit_group(self, reqs: list[Request], s: int) -> list[SequenceState]:
        """One batched prefill call over tokens (N, S) and one host fetch of
        the N first tokens. Pages are allocated for the real prompts only;
        bucket padding scatters to the trash page."""
        nb = len(reqs)
        n_pages = s // self.kv.page
        tokens = np.zeros((nb, s), np.int32)
        plens = np.empty((nb,), np.int32)
        rows = np.zeros((nb, n_pages), np.int32)
        states = []
        for i, req in enumerate(reqs):
            state = self.scheduler.admit(self._step_idx, request=req)
            state.resume_step = self._step_idx
            self._page_need[state.slot] = self._lifetime_pages(req)
            self.kv.alloc_upto(state.slot, state.plen - 1)
            tokens[i, : state.plen] = req.prompt
            plens[i] = state.plen
            rows[i] = self.kv.bucket_row(state.slot, state.plen, n_pages)
            states.append(state)
        t0 = time.perf_counter()
        dev = self.device
        logits, self.kv.buffers = T.prefill_paged(
            self.cfg,
            self.model,
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(plens).to(dev),
            self.kv.buffers,
            torch.from_numpy(rows).to(dev),
        )
        # the one batched fetch of this group's first tokens (argmax ties
        # go to the lowest id)
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        now = time.perf_counter()
        st = self.stats
        st["prefill_calls"] += 1
        st["prefill_tokens"] += int(plens.sum())
        st["prefill_s"] += now - t0
        for i, state in enumerate(states):
            state.generated.append(int(toks[i]))
            state.pos = state.plen
            state.first_token_s = now
            st["ttft_s"].append(now - state.request.submit_s)
        return states

    # ---- stepping ----------------------------------------------------
    def step(self) -> list[FinishedRequest]:
        """One scheduler iteration: admit (batched) -> decode -> evict."""
        finished: list[FinishedRequest] = list(self._rejected)
        self._rejected.clear()
        self._expire_waiting(finished)
        cap = self.ecfg.max_prefill_batch
        for s, reqs in self._plan_admission().items():
            i = 0
            while i < len(reqs):
                # greedy power-of-two chunks: 3 -> 2 + 1
                n = 1 << (min(len(reqs) - i, cap).bit_length() - 1)
                for state in self._admit_group(reqs[i : i + n], s):
                    if state.done:  # max_new_tokens == 1 or instant EOS
                        finished.append(self._finish(state))
                i += n

        # a prompt that already fills its slot cannot take a decode step
        for st_ in list(self.scheduler.active()):
            if st_.pos >= self.ecfg.max_len:
                finished.append(self._finish(st_, reason="capacity"))

        active = self.scheduler.active()
        if active:
            tokens = np.zeros((self.ecfg.max_slots,), np.int32)
            positions = np.zeros((self.ecfg.max_slots,), np.int32)
            for st_ in active:
                self.kv.alloc_upto(st_.slot, st_.pos)
                tokens[st_.slot] = st_.generated[-1]
                positions[st_.slot] = st_.pos
            t0 = time.perf_counter()
            dev = self.device
            logits, self.kv.buffers = T.decode_step_paged(
                self.cfg,
                self.model,
                self.kv.buffers,
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev),
                self.kv.device_table(),
            )
            # THE one host fetch per decode step: every slot's next token
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            st = self.stats
            st["decode_step_s"].append(time.perf_counter() - t0)
            st["decode_steps"] += 1
            st["decode_tokens"] += len(active)
            for st_ in active:
                st_.pos += 1
                st_.generated.append(int(nxt[st_.slot]))
                if st_.done:
                    finished.append(self._finish(st_))
                elif st_.pos >= self.ecfg.max_len:
                    finished.append(self._finish(st_, reason="capacity"))
        self._step_idx += 1
        return finished

    def _finish(
        self, state: SequenceState, *, reason: str | None = None
    ) -> FinishedRequest:
        self._page_need.pop(state.slot, None)
        self.scheduler.evict(state.slot)
        self.kv.free_slot(state.slot)
        if reason is None:
            eos = state.request.eos_id
            reason = (
                "eos"
                if eos is not None and state.generated[-1] == eos
                else "length"
            )
        req = state.request
        self.stats["finished"] += 1
        self.stats["generated_tokens"] += len(state.generated)
        return FinishedRequest(
            uid=req.uid,
            prompt=req.prompt,
            tokens=np.asarray(state.generated, np.int32),
            finish_reason=reason,
            admit_step=state.admit_step,
            finish_step=self._step_idx,
            ttft_s=(
                state.first_token_s - req.submit_s
                if state.first_token_s is not None
                else None
            ),
            e2e_s=time.perf_counter() - req.submit_s,
            schedule=req.schedule,
        )

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
