"""Serving benchmark of the port, the twin of the JAX package's
``benchmarks/serve_engine.py``: the continuous-batching engine against the
fixed-batch ``Server``, and the engine's scheduling, sampling, prefix
cache, goodput and observability scenarios, on one device (the card by
default).

  PYTHONPATH=src python -m repro_torch.bench.serve_engine              # full width, the card
  PYTHONPATH=src python -m repro_torch.bench.serve_engine --smoke --device cpu

Scenarios, each as the JAX script runs it (its docstring says why):

1. **uniform**: one fixed batch of equal prompts through the engine and
   through the ``Server`` oracle (``speedup_vs_server``).
2. **mixed**: ragged prompts and gens, twice as many requests as slots,
   half of them submitted mid-flight.
3. **prefill-heavy**: many short prompts, tiny gens; batched admission
   against ``max_prefill_batch=1``, the median of paired ratios.
4. **decode-by-sampler**: the uniform wave greedy and fully sampled.
5. **prefix-cache**: a shared system prompt, cache on against off.
6. **goodput**: a burst, a long tail (preemption on against off) and
   multi-turn chat (prefix cache on), over ``serving.workloads`` traces.
7. **observability**: tracing on against off, paired repeats (the two
   engines' steps taken in turn, ``_paired``).
8. **observability_live**: rolling windows, the burn-rate monitor and
   memory gauges on against off, and ``slo_shed`` (shedding on against
   off under overload).
9. **dispatch_guard**: the uniform wave's steady-state decode steps
   inside ``analysis.guards.DispatchGuard``: zero kernel-library builds,
   zero implicit device->host syncs and one explicit fetch a step,
   enforced (raising) with ``--guards`` and at ``--smoke``, else counted.

Each asserts what the JAX script asserts: token streams identical across
the modes it compares, and its gains where the JAX script asserts them.
Where two modes are compared, their engines step in turn
(``_paired``, ``_replay_in_turn``), so a drift of the host's speed hits
both alike; the JAX script runs one mode after the other.
The JSON has the JAX file's top-level keys, so the two diff key for key.
``decode_by_impl`` holds the engine's one paged read (``cuda`` on the
card, ``plain`` on the CPU); ``mesh`` is ``bench.serve_mesh``'s payload on
the same weights (in this process; the JAX script runs its module in a
subprocess), at full width for tp 1 and 2 only (``MESH_TPS_FULL``). Counts, percentiles and rates come from the
engine's ``stats_summary()``, the ``repro_serve_*`` metrics and the
``engine:*`` spans.

Model: ``--smoke`` is the JAX script's configuration and sizes (the smoke
qwen3-1.7b, 2 layers, a 256-token vocabulary; batch 2, prompts of 8, 4
new tokens, one repeat). The default is full-width sparse qwen3-1.7b in
bf16 at the JAX script's non-smoke sizes (batch 4, prompts of 32, 16 new,
3 repeats) with the request counts and trace lengths of ``FULL_CUTS``:
a greedy decode step of the full model takes ~90 ms on an H100, so the
JAX script's traces would take tens of minutes. Every cut is written
under ``config.reduced``. Writes ``build/bench_serve_torch.json``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis.guards import DispatchGuard
from repro_torch.bench import serve_mesh
from repro_torch.configs import registry
from repro_torch.launch.serve import Server
from repro_torch.obs import SloConfig
from repro_torch.serving import workloads
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import REJECT_SHED
from repro_torch.serving.sampling import SamplingParams

__all__ = ["run", "main", "FULL_CUTS"]

ARCH = "qwen3-1.7b"
# the fully loaded sampled scenario (every filter live)
SAMPLED = SamplingParams(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1)

# The trace sizes of the JAX script: (smoke, non-smoke). ``shed_bg_gen``
# None is the JAX script's 2 * page - 1 (a background decode that fills a
# slot end to end).
SIZES = {
    "prefix_requests_per_slot": (2, 4),
    "prefill_heavy_requests_per_slot": (2, 8),
    "burst": ((40, 8, 22), (96, 12, 48)),  # background gen, burst step, deadline steps
    "long_tail": ((12, 3.0, 30), (32, 2.0, 40)),  # requests, mean gap steps, deadline steps
    "chat_turns": (2, 3),
    "chat_users": (None, None),  # None: one conversation a slot
    "shed_bg_per_slot": (4, 4),
    "shed_bg_gen": (None, None),
    "warm_replays": (True, True),
}

# What the full-width default cuts from the non-smoke sizes (written under
# ``config.reduced``), and why:
# request counts and trace lengths only, never a width.
FULL_CUTS = {
    "prefix_requests_per_slot": (2, "fewer requests sharing the system prompt"),
    "prefill_heavy_requests_per_slot": (4, "fewer short requests"),
    "burst": ((40, 8, 22), "the JAX --smoke burst trace (background gen 40, deadline 22 steps)"),
    "long_tail": ((12, 3.0, 30), "the JAX --smoke long-tail trace (12 requests)"),
    "chat_turns": (2, "two turns a conversation"),
    "chat_users": (2, "two conversations, not one a slot: four users' second turns do not all fit "
                      "the pool beside the pages the first turns parked, and the last waits a whole turn"),
    "shed_bg_per_slot": (2, "two waves of background decodes, not four"),
    "shed_bg_gen": (40, "background decodes of 40 tokens, not 2 * page - 1 = 255"),
    "warm_replays": (False, "no unarmed warm-up replay before a measured one (nothing compiles "
                            "just in time here); the seconds-per-step calibration replay stays"),
}


# the tensor-parallel degrees of the ``mesh`` scenario at full width
MESH_TPS_FULL = (1, 2)


def _warm_buckets(engine: Engine, lens: list[int], sampling: SamplingParams | None = None) -> None:
    """Drive one admission group at every power-of-two batch size up to
    ``max_prefill_batch`` for each prefill bucket the lens map to, then
    drain (the decode path too), so first-call costs (kernel-library
    loads, allocator growth, the GEMM library's heuristics) land before
    the clock starts. Resets the engine's stats afterwards."""
    vocab = engine.cfg.vocab_size
    rng = np.random.default_rng(4321)
    nvals, n = {1}, 1
    while 2 * n <= engine.ecfg.max_prefill_batch:
        n *= 2
        nvals.add(n)
    for s in sorted({engine._bucket(ln) for ln in lens}):
        # -1: a full-slot prompt would capacity-finish straight after
        # prefill, and the warm drain would never touch the decode path
        plen = min(s, engine.ecfg.max_len) - 1
        for n in sorted(nvals):
            for _ in range(n):
                engine.submit(rng.integers(0, vocab, plen).astype(np.int32), 2, sampling=sampling)
            engine.drain()
    engine.reset_stats()


def _measure_uniform(engine, prompts, gen, sampling=None, repeats=3) -> dict:
    """Serve the uniform wave ``repeats`` times after a warm-up and keep
    the run with the best decode tok/s. ``sampling``: request b gets
    seed + b; None keeps greedy."""
    _warm_buckets(engine, [prompts.shape[1]], sampling)
    best = None
    for _ in range(repeats):
        engine.reset_stats()
        t0 = time.perf_counter()
        for b in range(prompts.shape[0]):
            engine.submit(
                prompts[b], gen,
                sampling=None if sampling is None else dataclasses.replace(sampling, seed=sampling.seed + b),
            )
        finished = engine.drain()
        wall_s = time.perf_counter() - t0
        out = engine.stats_summary()
        out["wall_tok_s"] = round(sum(len(f.tokens) for f in finished) / wall_s, 2)
        out["wall_s"] = round(wall_s, 4)
        if best is None or out["decode_tok_s"] > best["decode_tok_s"]:
            best = out
    return best


def _measure_trace(engine, prompts, gens) -> dict:
    """Submit a whole trace, drain, fold the wall clock into the stats."""
    engine.reset_stats()
    t0 = time.perf_counter()
    for p, g in zip(prompts, gens):
        engine.submit(p, g)
    finished = engine.drain()
    wall_s = time.perf_counter() - t0
    out = engine.stats_summary()
    out["wall_tok_s"] = round(sum(len(f.tokens) for f in finished) / wall_s, 2)
    out["wall_s"] = round(wall_s, 4)
    out["requests"] = len(prompts)
    return out


def _streams(fins) -> list[list[int]]:
    return [f.tokens.tolist() for f in sorted(fins, key=lambda f: f.uid)]


def _measure_prefix_cache(cfg, sd, device, batch, n_per_slot, repeats) -> dict:
    """Shared-system-prompt scenario: prefix cache on against off on
    identical engines; the warm-up pass also fills the radix tree. Best
    of ``repeats`` by prefill seconds; streams identical."""
    page = cfg.attn_block
    sys_pages = 3
    max_len = (sys_pages + 2) * page
    n_req = n_per_slot * batch
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, cfg.vocab_size, sys_pages * page, dtype=np.int32)
    prompts = [
        np.concatenate([sys_prompt, rng.integers(0, cfg.vocab_size, int(rng.integers(4, page // 2)),
                                                 dtype=np.int32)])
        for _ in range(n_req)
    ]
    gens = [int(rng.integers(2, 5)) for _ in range(n_req)]
    results, streams = {}, {}
    for mode, on in (("on", True), ("off", False)):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=batch, max_len=max_len, prefix_cache=on),
                     params=sd, device=device)
        for p, g in zip(prompts, gens):  # warm every path (and the tree)
            eng.submit(p, g)
        eng.drain()
        best = None
        for _ in range(repeats):
            eng.reset_stats()
            t0 = time.perf_counter()
            for p, g in zip(prompts, gens):
                eng.submit(p, g)
            fins = eng.drain()
            wall = time.perf_counter() - t0
            out = eng.stats_summary()
            out["wall_s"] = round(wall, 4)
            out["wall_tok_s"] = round(sum(len(f.tokens) for f in fins) / wall, 2)
            if best is None or out["prefill_s"] < best["prefill_s"]:
                best = out
                streams[mode] = _streams(fins)
        results[mode] = best
    # the cache must be a pure optimization: identical token streams
    assert streams["on"] == streams["off"], "prefix cache changed tokens"
    keys = ("prefill_s", "prefill_tokens", "wall_s", "wall_tok_s", "p95_token_latency_ms")
    row = {m: {k: results[m][k] for k in keys} for m in ("on", "off")}
    pc = results["on"]["prefix_cache"]
    row["on"]["hit_rate"] = pc["hit_rate"]
    row["on"]["hit_tokens"] = pc["hit_tokens"]
    row["on"]["evicted_pages"] = pc["evicted_pages"]
    row["admission_speedup"] = round(results["off"]["prefill_s"] / max(results["on"]["prefill_s"], 1e-9), 2)
    row["wall_speedup"] = round(results["on"]["wall_tok_s"] / max(results["off"]["wall_tok_s"], 1e-9), 2)
    row["requests"] = n_req
    row["sys_prompt_tokens"] = sys_pages * page
    return row


def _replay_in_turn(engines: dict, items, calibration: list[float] | None) -> tuple[dict, list[float]]:
    """``workloads.replay`` of ``items`` on every engine at once: each
    round, every engine still busy takes the arrivals due at its own step
    count and one step. With ``calibration`` None the deadlines stay
    unarmed; else it holds the round times of an unarmed replay, and a
    deadline of n steps is n times the median of the last 16 rounds (the
    calibration's last ones until the replay's own fill the window), the
    same for every engine in a round. Returns ({mode: (finished, the wall
    seconds of its own steps, its steps, {uid: (its steps from submission
    to finish, its deadline in steps)})}, the round times).

    The JAX script replays a trace on one engine, then on the other, with
    one seconds-per-step value from a third replay. On a shared host a
    host-bound step's time drifts from one second to the next, enough that
    the mode without preemption met the deadlines of a burst it queued.
    Here both modes see the same host in every round, and a deadline
    follows the host's pace at the step it is set."""
    items = sorted(items, key=lambda w: w.arrival_step)
    state = {mode: {"next": 0, "fins": [], "wall": 0.0, "steps": 0, "due": {}, "took": {}} for mode in engines}
    recent = collections.deque(calibration or (), maxlen=16)
    busy, rounds = set(engines), []
    while busy:
        step_s = float(np.median(recent)) if calibration is not None else None
        t_round = time.perf_counter()
        for mode in [m for m in engines if m in busy]:
            eng, st = engines[mode], state[mode]
            while st["next"] < len(items) and items[st["next"]].arrival_step <= st["steps"]:
                w = items[st["next"]]
                uid = eng.submit(w.prompt, w.max_new_tokens, sampling=w.sampling,
                                 schedule=workloads._schedule(w, step_s))
                st["due"][uid] = (st["steps"], w.deadline_steps)
                st["next"] += 1
            t0 = time.perf_counter()
            done = eng.step()
            st["wall"] += time.perf_counter() - t0
            st["steps"] += 1
            st["fins"].extend(done)
            for f in done:
                submitted, deadline_steps = st["due"][f.uid]
                st["took"][f.uid] = (st["steps"] - submitted, deadline_steps)
            if st["next"] == len(items) and eng.scheduler.idle and not eng._rejected:
                busy.discard(mode)
        rounds.append(time.perf_counter() - t_round)
        recent.append(rounds[-1])
    return {m: (st["fins"], st["wall"], st["steps"], st["took"]) for m, st in state.items()}, rounds


def _goodput_pair(cfg, sd, device, slots, max_len, items, *, warm_replays, strict=False) -> dict:
    """One seeded trace with preemption on against off, the two engines
    stepped in turn (``_replay_in_turn``). An unarmed replay measures the
    seconds a round takes, which turns the step deadlines into the same
    wall-clock ``ScheduleParams`` for both modes. Streams identical across
    modes; ``strict`` also asserts a preemption and strictly more
    deadlines met with preemption on, counted in steps (each request's
    steps from submission to finish against its deadline's), which a
    drift of the host's pace cannot flip."""
    warm_lens = sorted({w.prompt.size for w in items})
    engines = {}
    for mode, on in (("on", True), ("off", False)):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=slots, max_len=max_len, preemption=on),
                     params=sd, device=device)
        _warm_buckets(eng, warm_lens)
        engines[mode] = eng
    if warm_replays:  # the swap path's first use, off the clock
        _replay_in_turn(engines, items, None)
    _, cal = _replay_in_turn(engines, items, None)
    for eng in engines.values():
        eng.reset_stats()
    runs, _ = _replay_in_turn(engines, items, cal)
    out, streams, met_in_steps = {}, {}, {}
    for mode, (fins, wall, steps, took) in runs.items():
        dl = [(n, d) for n, d in took.values() if d is not None]
        met_in_steps[mode] = sum(n <= d for n, d in dl) / len(dl) if dl else 1.0
        row = workloads.goodput(fins, engines[mode].stats_summary())
        row["wall_s"] = round(wall, 4)
        row["steps"] = steps
        out[mode] = row
        streams[mode] = _streams(fins)
    # preemption may only change WHEN things run, never WHAT they emit
    assert streams["on"] == streams["off"], "preemption changed token streams"
    out["attainment_gain"] = round(out["on"]["slo_attainment"] - out["off"]["slo_attainment"], 4)
    if strict:
        # counted in the trace's own unit, steps from submission to finish
        # against each deadline's steps: a drift of the host's pace between
        # a deadline's setting and its end cannot flip it (the wall-clock
        # attainment above is the JAX file's number)
        assert out["on"]["preemptions"] > 0, "trace never preempted"
        assert met_in_steps["on"] > met_in_steps["off"], (
            f"preemption did not raise SLO attainment (in steps): on={met_in_steps['on']} "
            f"off={met_in_steps['off']} (wall clock: on={out['on']['slo_attainment']} "
            f"off={out['off']['slo_attainment']})"
        )
    return out


def _paired(engines: dict, prompts, gen, repeats) -> tuple[list[dict], dict]:
    """The uniform wave on every engine at once, ``repeats`` times, their
    steps taken in turn: one step of each engine, then the next round.
    The JAX script serves the wave on one engine and then on the other;
    a host-bound decode step's time drifts from one second to the next on
    a shared host, so whole waves back to back compare two host speeds,
    where steps in turn see the same one. Each
    engine's ``wall_s`` sums its own steps. The streams of every engine
    must be identical in every repeat."""
    pairs, streams = [], {}
    for _ in range(repeats):
        fins = {mode: [] for mode in engines}
        wall = dict.fromkeys(engines, 0.0)
        for eng in engines.values():
            eng.reset_stats()
            for b in range(len(prompts)):
                eng.submit(prompts[b], gen)
        busy = set(engines)
        while busy:
            for mode in list(busy):
                eng = engines[mode]
                t0 = time.perf_counter()
                fins[mode] += eng.step()
                wall[mode] += time.perf_counter() - t0
                if eng.scheduler.idle and not eng._rejected:
                    busy.discard(mode)
        pair = {}
        for mode, eng in engines.items():
            out = eng.stats_summary()
            out["wall_s"] = round(wall[mode], 4)
            pair[mode] = out
            streams[mode] = _streams(fins[mode])
        first, *rest = streams.values()
        assert all(s == first for s in rest), f"{'/'.join(engines)} changed token streams"
        pairs.append(pair)
    return pairs, streams


def _median_pair(pairs, a, b) -> tuple[int, float]:
    ratios = [p[a]["decode_tok_s"] / max(p[b]["decode_tok_s"], 1e-9) for p in pairs]
    med_i = int(np.argsort(ratios)[len(ratios) // 2])
    return med_i, round(sorted(ratios)[len(ratios) // 2], 4)


def _measure_observability(cfg, sd, device, batch, prompt_len, gen, repeats, trace_out=None) -> dict:
    """Tracer cost: the uniform wave on two warm engines, tracing on and
    off, their steps in turn in each repeat; the median paired decode
    tok/s ratio (traced / off) must stay >= 0.80 and the streams identical.
    ``trace_out``: the traced engine's ring as Perfetto JSON."""
    max_len = prompt_len + gen + 1
    engines = {}
    for mode, on in (("traced", True), ("off", False)):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=batch, max_len=max_len, trace=on),
                     params=sd, device=device)
        _warm_buckets(eng, [prompt_len])
        engines[mode] = eng
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(batch, prompt_len), dtype=np.int32)
    pairs, _ = _paired(engines, prompts, gen, repeats)
    med_i, ratio = _median_pair(pairs, "traced", "off")
    assert ratio >= 0.80, f"tracer overhead blew the budget: traced/off decode ratio {ratio} (floor 0.80)"
    keys = ("decode_tok_s", "p95_token_latency_ms", "wall_s")
    row = {m: {k: pairs[med_i][m][k] for k in keys} for m in ("traced", "off")}
    row["traced_vs_off"] = ratio
    row["overhead_pct"] = round((1.0 - ratio) * 100.0, 2)
    row["events_recorded"] = int(engines["traced"].tracer.n_recorded)
    if trace_out:
        row["trace_events_written"] = engines["traced"].export_perfetto(trace_out)
    return row


def _measure_observability_live(cfg, sd, device, batch, prompt_len, gen, repeats, smoke, listen=None) -> dict:
    """The live plane (windows, the burn-rate monitor with shedding off,
    memory gauges) against a bare engine, paired repeats: the median
    monitored / off decode ratio must reach 0.95 (0.80 at smoke width),
    streams identical. With ``listen``, one more monitored run is scraped
    mid-decode (``/metrics``, ``/healthz``), and ``/vars``'s windowed
    percentiles must agree with the final ``stats_summary()``."""
    max_len = prompt_len + gen + 1
    monitored = EngineConfig(max_slots=batch, max_len=max_len, monitor=True,
                             slo=SloConfig(target=0.99, fast_window_s=5.0, slow_window_s=30.0))
    engines = {}
    for mode, ecfg in (("monitored", monitored), ("off", EngineConfig(max_slots=batch, max_len=max_len))):
        eng = Engine(cfg, engine_cfg=ecfg, params=sd, device=device)
        _warm_buckets(eng, [prompt_len])
        engines[mode] = eng
    prompts = np.random.default_rng(17).integers(0, cfg.vocab_size, size=(batch, prompt_len), dtype=np.int32)
    pairs, _ = _paired(engines, prompts, gen, repeats)
    med_i, ratio = _median_pair(pairs, "monitored", "off")
    floor = 0.80 if smoke else 0.95
    assert ratio >= floor, f"live monitoring blew the budget: monitored/off decode ratio {ratio} (floor {floor})"
    keys = ("decode_tok_s", "p95_token_latency_ms", "wall_s")
    row = {m: {k: pairs[med_i][m][k] for k in keys} for m in ("monitored", "off")}
    row["monitored_vs_off"] = ratio
    row["overhead_pct"] = round((1.0 - ratio) * 100.0, 2)
    if listen:
        row["live_scrape"] = _live_scrape(engines["monitored"], prompts, gen, listen)
    return row


def _live_scrape(eng, prompts, gen, listen) -> dict:
    import urllib.request

    from repro_torch.obs.http import attach
    from repro_torch.obs.prom import parse as prom_parse

    def get(url: str) -> str:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            assert r.status == 200, f"{url} -> {r.status}"
            return r.read().decode()

    srv = attach(eng, listen)
    try:
        eng.reset_stats()
        for b in range(len(prompts)):
            eng.submit(prompts[b], gen)
        scraped, step = None, 0
        while not eng.scheduler.idle or eng._rejected:
            eng.step()
            step += 1
            if step == max(gen // 2, 1):  # scrape mid-decode
                flat = prom_parse(get(srv.url + "/metrics"))
                assert flat["repro_serve_decode_steps_total"] > 0, "mid-run exposition missing decode steps"
                assert get(srv.url + "/healthz") == "ok\n"
                scraped = len(flat)
        assert scraped is not None, "run too short to scrape"
        live = json.loads(get(srv.url + "/vars"))
        s = eng.stats_summary()
        # the window spans the whole (post-reset) run: /vars raw-sample
        # percentiles must agree with the final summary
        for vk, sk in (("p50_ms", "p50_token_latency_ms"), ("p95_ms", "p95_token_latency_ms")):
            got, want = live["token_latency_ms"][vk], s[sk]
            assert abs(got - want) <= max(0.02, 0.01 * want), (
                f"/vars {vk}={got} disagrees with stats_summary {sk}={want}")
        slo = json.loads(get(srv.url + "/slo"))
        assert slo["enabled"] and slo["state"] == "OK"
        return {
            "listen": srv.url,
            "midrun_metric_samples": scraped,
            "vars_token_p50_ms": live["token_latency_ms"]["p50_ms"],
            "summary_token_p50_ms": s["p50_token_latency_ms"],
            "pool_pages": live["memory"]["pool_pages"],
        }
    finally:
        srv.stop()


def _measure_slo_shed(cfg, sd, device, slots, *, bg_per_slot, bg_gen, warm_replays) -> dict:
    """Burn-rate load shedding under overload, on against off, preemption
    off: long low-priority decodes pin every slot with a backlog behind
    them while short deadline'd high-priority requests arrive on a steady
    clock. With ``SloConfig(shed=True)`` the CRITICAL state drops the
    queued background as structured ``REJECT_SHED`` rejections, and the
    high-priority attainment must be strictly higher than without."""
    page = cfg.attn_block
    max_len = 3 * page
    bg_gen = bg_gen or 2 * page - 1  # fills a slot end to end, no capacity finish
    n_bg = bg_per_slot * slots
    hi_gap, hi_dl = 6, 10
    # misses only surface when a late request finishes, so the
    # interactive stream must outlive the background horizon
    n_hi = ((n_bg // slots) * bg_gen) // hi_gap
    rng = np.random.default_rng(23)
    items = [
        workloads.WorkItem(arrival_step=0, prompt=rng.integers(1, cfg.vocab_size, page).astype(np.int32),
                           max_new_tokens=bg_gen, priority=0)
        for _ in range(n_bg)
    ]
    items += [
        workloads.WorkItem(
            arrival_step=4 + hi_gap * k,
            prompt=rng.integers(1, cfg.vocab_size, int(rng.integers(6, page // 2))).astype(np.int32),
            max_new_tokens=3, priority=1, deadline_steps=hi_dl,
        )
        for k in range(n_hi)
    ]
    lens = sorted({w.prompt.size for w in items})
    # seconds a round of two bare engines takes, then both modes armed
    # alike and stepped in turn (``_replay_in_turn``)
    cal = {}
    for mode in ("off", "on"):
        cal[mode] = Engine(cfg, engine_cfg=EngineConfig(max_slots=slots, max_len=max_len, preemption=False),
                           params=sd, device=device)
        _warm_buckets(cal[mode], lens)
    if warm_replays:
        _replay_in_turn(cal, items, None)
    _, rounds = _replay_in_turn(cal, items, None)
    step_s = float(np.median(rounds))
    del cal
    # burn windows sized in measured steps
    fast_s = max(8 * step_s, 5e-3)

    def hi_attainment(fins) -> tuple[int, int]:
        hi = [f for f in fins if f.schedule.priority == 1 and f.schedule.deadline_s is not None
              and f.reject_reason != REJECT_SHED]
        return sum(1 for f in hi if f.slo_met), len(hi)

    engines = {}
    for mode, shed in (("off", False), ("on", True)):
        slo = SloConfig(target=0.9, fast_window_s=fast_s, slow_window_s=3 * fast_s, warn_burn=2.0,
                        critical_burn=6.0, shed=shed, shed_max_per_tick=2 * slots)
        engines[mode] = Engine(cfg, engine_cfg=EngineConfig(max_slots=slots, max_len=max_len, preemption=False,
                                                             monitor=True, slo=slo),
                               params=sd, device=device)
        _warm_buckets(engines[mode], lens)
    if warm_replays:
        _replay_in_turn(engines, items, None)
    for eng in engines.values():
        eng.reset_stats()
    runs, _ = _replay_in_turn(engines, items, rounds)
    out: dict = {}
    for mode, (fins, wall, steps, _) in runs.items():
        eng = engines[mode]
        stats = eng.stats_summary()
        sheds = [f for f in fins if f.reject_reason == REJECT_SHED]
        met, n_dl = hi_attainment(fins)
        out[mode] = {
            "requests": len(fins),
            "hi_with_deadline": n_dl,
            "hi_slo_met": met,
            "hi_attainment": round(met / n_dl, 4) if n_dl else 1.0,
            "sheds": len(sheds),
            "rejected_total": stats["rejected"]["total"],
            "slo_transitions": dict(eng._slo_mon.transitions),
            "wall_s": round(wall, 4),
            "steps": steps,
        }
        if mode == "on":
            assert sheds, "overload under CRITICAL never shed"
            assert all(f.finish_reason == "rejected" and f.reject_reason == REJECT_SHED for f in sheds), (
                "sheds must surface as structured rejections")
            assert out["on"]["slo_transitions"].get("CRITICAL", 0) >= 1
        else:
            assert not sheds and stats["rejected"]["total"] == 0, "shedding disabled must never reject"
    del engines
    out["hi_attainment_gain"] = round(out["on"]["hi_attainment"] - out["off"]["hi_attainment"], 4)
    assert out["on"]["hi_attainment"] > out["off"]["hi_attainment"], (
        f"shedding did not raise high-priority attainment: on={out['on']['hi_attainment']} "
        f"off={out['off']['hi_attainment']}")
    out["step_s"] = round(step_s, 6)
    return out


def _measure_guarded(engine: Engine, prompts: np.ndarray, gen: int, *, enforce: bool) -> dict:
    """One uniform wave with the steady-state decode loop inside a
    ``DispatchGuard``: proves (``enforce``, raising) or records (counting)
    that decode builds no kernel library and makes no implicit
    device->host sync after warm-up, with exactly one explicit fetch (the
    next-token row) a step. The first step (admission and the first
    decode) is warm-up, and the last ones are left out: requests
    finishing free their slots, which is not a steady step."""
    for b in range(prompts.shape[0]):
        engine.submit(prompts[b], gen)
    engine.step()
    steps = max(gen - 2, 1)
    guard = DispatchGuard(max_compiles=0 if enforce else None, raise_on_sync=enforce)
    with guard:
        for _ in range(steps):
            engine.step()
    engine.drain(max_steps=64 * max(gen, 1))
    return {
        "steps": steps,
        "compiles": guard.compiles,
        "implicit_d2h": guard.implicit_syncs,
        "explicit_syncs": guard.explicit_syncs,
        "enforced": enforce,
        "clean": guard.compiles == 0 and guard.implicit_syncs == 0,
    }


def _measure_goodput(cfg, sd, device, batch, sizes) -> dict:
    """The three scheduling scenarios over seeded workload traces."""
    page = cfg.attn_block
    slots = batch
    # burst: deadline'd high-priority burst on a full pool, >2x margin on
    # both sides of the deadline
    bg_gen, burst_at, dl = sizes["burst"]
    burst = workloads.poisson_burst(
        np.random.default_rng(11), vocab=cfg.vocab_size, page=page, n_background=slots, n_burst=slots,
        burst_step=burst_at, background_gen=bg_gen, burst_gen=6, deadline_steps=dl,
    )
    warm = sizes["warm_replays"]
    rows = {"burst": _goodput_pair(cfg, sd, device, slots, 3 * page, burst, warm_replays=warm, strict=True)}
    # long tail: open-loop Poisson arrivals, an interactive tier over a
    # heavy batch tail
    n, gap, deadline = sizes["long_tail"]
    tail = workloads.long_tail(
        np.random.default_rng(12), vocab=cfg.vocab_size, page=page, n=n, mean_gap_steps=gap,
        short_gen=(3, 8), heavy_gen=bg_gen, deadline_steps=deadline,
    )
    rows["long_tail"] = _goodput_pair(cfg, sd, device, slots, 3 * page, tail, warm_replays=warm)
    # chat: multi-turn conversations with the prefix cache on; turn 2+
    # extends turn 1's history and hits the pages decode wrote
    n_turns = sizes["chat_turns"]
    users = sizes["chat_users"] or slots

    def convs(seed):
        # gen page + 1: the answer fills the prompt's last page exactly,
        # so whole turns become matchable
        return workloads.chat_turns(np.random.default_rng(seed), vocab=cfg.vocab_size, n_users=users,
                                    n_turns=n_turns, user_tokens=page, gen=page + 1)

    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=slots, max_len=(2 * n_turns + 1) * page,
                                              prefix_cache=True),
                 params=sd, device=device)
    if warm:  # same-shaped conversations of other tokens: the tree stays cold
        workloads.replay_chat(eng, convs(998))
    eng.reset_stats()
    by_turn, wall, _ = workloads.replay_chat(eng, convs(13))
    later = [f for t, fs in by_turn.items() if t >= 1 for f in fs]
    hit = sum(f.prefix_hit_tokens for f in later)
    plen = sum(int(f.prompt.size) for f in later)
    ttft = [f.ttft_s for fs in by_turn.values() for f in fs]
    stats = eng.stats_summary()
    rows["chat"] = {
        "turns": n_turns,
        "users": users,
        "wall_s": round(wall, 4),
        "turn2plus_hit_rate": round(hit / plen, 4) if plen else 0.0,
        "turn2plus_hit_tokens": hit,
        "decode_indexed_pages": stats["prefix_cache"]["decode_indexed_pages"],
        "ttft_p50_ms": workloads._pct(ttft, 50),
        "ttft_p95_ms": workloads._pct(ttft, 95),
    }
    assert rows["chat"]["turn2plus_hit_rate"] > 0.25, (
        f"chat turns no longer hit decode-indexed pages: {rows['chat']}")
    return rows


def run(
    *,
    smoke: bool = False,
    device: str | None = None,
    repeats: int | None = None,
    trace_out: str | None = None,
    listen: str | None = None,
    out: str | None = "build/bench_serve_torch.json",
    guards: bool = False,
) -> dict:
    """Every scenario; returns the payload and writes it to ``out``."""
    t_start = time.perf_counter()
    if smoke:
        cfg = registry.get_smoke(ARCH, sparse=True).replace(num_layers=2, vocab_size=256)
        batch, prompt_len, gen, default_repeats = 2, 8, 4, 1
        sizes = {k: v[0] for k, v in SIZES.items()}
        reduced = {}
    else:
        cfg = registry.get(ARCH, sparse=True)
        batch, prompt_len, gen, default_repeats = 4, 32, 16, 3
        sizes = {k: v[1] for k, v in SIZES.items()}
        reduced = {}
        for key, (value, why) in FULL_CUTS.items():
            reduced[key] = {"jax": sizes[key], "here": value, "why": why}
            sizes[key] = value
    repeats = repeats or default_repeats
    if repeats < default_repeats:
        reduced["repeats"] = {"jax": default_repeats, "here": repeats, "why": "fewer repeats"}

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len), dtype=np.int32)

    # ---- the Server oracle (fixed batch, prompt through the decode step)
    server = Server(cfg, device=device)
    dev = server.device
    sd = server.model.state_dict()
    server.generate(prompts, 2)  # warm-up
    t0 = time.perf_counter()
    server_out = server.generate(prompts, gen)
    server_s = time.perf_counter() - t0
    server_tokens = int(server_out.size)
    server_tok_s = server_tokens / server_s

    # ---- engine, uniform workload (same requests, shared weights)
    max_len = prompt_len + gen + 1
    engine = Engine(cfg, engine_cfg=EngineConfig(max_slots=batch, max_len=max_len), params=sd, device=dev)
    uniform = _measure_uniform(engine, prompts, gen, repeats=repeats)

    # ---- decode-by-sampler: the same wave fully sampled
    keys = ("decode_tok_s", "p95_token_latency_ms", "p50_token_latency_ms")
    sampled = _measure_uniform(engine, prompts, gen, sampling=SAMPLED, repeats=repeats)
    by_sampler = {
        "greedy": {k: uniform[k] for k in keys},
        SAMPLED.kind: {k: sampled[k] for k in keys},
        "sampled_vs_greedy": round(sampled["decode_tok_s"] / max(uniform["decode_tok_s"], 1e-9), 4),
    }
    # the engine has one paged read: the CUDA kernel on the card, the plain
    # gather on the CPU
    by_impl = {engine.paged_impl: {k: uniform[k] for k in keys}}
    # ---- dispatch guard: counted always, enforced (raising) under
    # --guards and at --smoke, so a hot-path regression fails the run
    dispatch_guard = _measure_guarded(engine, prompts, gen, enforce=guards or smoke)
    del engine

    # ---- mixed-length trace with mid-flight arrivals
    engine2 = Engine(cfg, engine_cfg=EngineConfig(max_slots=batch, max_len=2 * max_len), params=sd, device=dev)
    rng = np.random.default_rng(1)
    n_req = 2 * batch
    lens = [int(rng.integers(8, 2 * prompt_len)) for _ in range(n_req)]
    gens = [int(rng.integers(max(gen // 2, 1), 2 * gen)) for _ in range(n_req)]
    _warm_buckets(engine2, lens)
    t0 = time.perf_counter()
    for i in range(n_req // 2):
        engine2.submit(rng.integers(0, cfg.vocab_size, lens[i]).astype(np.int32), gens[i])
    fins = []
    for _ in range(max(gen // 2, 1)):  # let the first wave progress
        fins += engine2.step()
    for i in range(n_req // 2, n_req):  # late arrivals, admitted mid-flight
        engine2.submit(rng.integers(0, cfg.vocab_size, lens[i]).astype(np.int32), gens[i])
    fins += engine2.drain()
    mixed_s = time.perf_counter() - t0
    mixed = engine2.stats_summary()
    mixed["wall_tok_s"] = round(sum(len(f.tokens) for f in fins) / mixed_s, 2)
    mixed["requests"] = n_req
    del engine2

    # ---- prefill-heavy: batched admission against one request a call,
    # the median of paired ratios
    rng = np.random.default_rng(2)
    ph_n = sizes["prefill_heavy_requests_per_slot"] * batch
    ph_prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 3 * prompt_len))).astype(np.int32)
                  for _ in range(ph_n)]
    ph_gens = [int(rng.integers(2, 5)) for _ in range(ph_n)]
    ph_engines = {}
    for mode, cap in (("batched", 0), ("per_request", 1)):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2 * batch, max_len=2 * max_len, max_prefill_batch=cap),
                     params=sd, device=dev)
        _warm_buckets(eng, [p.size for p in ph_prompts])
        ph_engines[mode] = eng
    ph_pairs = [{m: _measure_trace(ph_engines[m], ph_prompts, ph_gens) for m in ("batched", "per_request")}
                for _ in range(repeats)]
    ph_ratios = [p["batched"]["wall_tok_s"] / max(p["per_request"]["wall_tok_s"], 1e-9) for p in ph_pairs]
    ph = ph_pairs[int(np.argsort(ph_ratios)[len(ph_ratios) // 2])]
    ph_speedup = round(sorted(ph_ratios)[len(ph_ratios) // 2], 2)
    del ph_engines

    prefix = _measure_prefix_cache(cfg, sd, dev, batch, sizes["prefix_requests_per_slot"], repeats)
    obs = _measure_observability(cfg, sd, dev, batch, prompt_len, gen, repeats, trace_out=trace_out)
    obs_live = _measure_observability_live(cfg, sd, dev, batch, prompt_len, gen, repeats, smoke, listen=listen)
    obs_live["slo_shed"] = _measure_slo_shed(cfg, sd, dev, batch, bg_per_slot=sizes["shed_bg_per_slot"],
                                             bg_gen=sizes["shed_bg_gen"], warm_replays=sizes["warm_replays"])
    good = _measure_goodput(cfg, sd, dev, batch, sizes)
    # the mesh trajectory (bench.serve_mesh) on the same weights; at full
    # width only tp 1 and 2 (chip_smoke.py phase 14d runs all four)
    mesh_tps = serve_mesh.TPS if smoke else MESH_TPS_FULL
    if not smoke:
        reduced["mesh_tps"] = {"jax": list(serve_mesh.TPS), "here": list(mesh_tps),
                               "why": "tp 1 and 2 only; python -m repro_torch.bench.serve_mesh runs every tp"}
    mesh = serve_mesh.run(smoke=smoke, device=dev, params=sd, tps=mesh_tps)

    payload = {
        "config": {
            "arch": ARCH,
            "smoke": smoke,
            "sparse": True,
            "dtype": cfg.dtype,
            "num_layers": cfg.num_layers,
            "d_model": cfg.d_model,
            "batch": batch,
            "prompt_len": prompt_len,
            "gen": gen,
            "page": cfg.attn_block,
            "slots": batch,
            "repeats": repeats,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "reduced": reduced,
            "wall_s": round(time.perf_counter() - t_start, 2),
        },
        "server": {"tok_s": round(server_tok_s, 2), "total_tokens": server_tokens, "wall_s": round(server_s, 4)},
        "engine_uniform": uniform,
        "engine_mixed": mixed,
        "engine_prefill_heavy": ph["batched"],
        "prefill_heavy_baseline": ph["per_request"],
        "prefill_heavy_speedup": ph_speedup,
        "decode_by_impl": by_impl,
        "decode_by_sampler": by_sampler,
        "dispatch_guard": dispatch_guard,
        "observability": obs,
        "observability_live": obs_live,
        "prefix_cache": prefix,
        "goodput": good,
        "mesh": mesh,
        "paged_impl_default": next(iter(by_impl)),
        "speedup_vs_server": round(uniform["tok_s"] / server_tok_s, 2),
    }
    if out:
        path = Path(out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(payload, indent=1, default=float))
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the port's serving benchmark (twin of benchmarks/serve_engine.py)")
    ap.add_argument("--smoke", action="store_true", help="the JAX script's smoke config and sizes")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    ap.add_argument("--repeats", type=int, default=None, help="default 3 (1 with --smoke)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="the observability scenario's traced ring as Perfetto JSON")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="scrape the monitored engine's endpoint mid-run (port 0 = ephemeral)")
    ap.add_argument("--guards", action="store_true",
                    help="enforce the dispatch guard: raise on any kernel-library build or implicit "
                         "device->host sync in the steady-state decode loop (always at --smoke)")
    ap.add_argument("--out", default="build/bench_serve_torch.json")
    args = ap.parse_args(argv)
    payload = run(smoke=args.smoke, device=args.device, repeats=args.repeats, trace_out=args.trace_out,
                  listen=args.listen, out=args.out, guards=args.guards)
    u, s = payload["engine_uniform"], payload["server"]
    print(f"serve_engine ({payload['config']['device']}, {payload['config']['wall_s']} s): uniform {u['tok_s']} tok/s, "
          f"server {s['tok_s']} tok/s (x{payload['speedup_vs_server']}), prefill-heavy "
          f"x{payload['prefill_heavy_speedup']}, prefix admission x{payload['prefix_cache']['admission_speedup']}, "
          f"burst SLO {payload['goodput']['burst']['on']['slo_attainment']} on / "
          f"{payload['goodput']['burst']['off']['slo_attainment']} off; wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
