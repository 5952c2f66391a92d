"""The port's engine observability against the JAX engine's, and its own
contracts, on the CPU.

Parity: the JAX ``Engine`` (on ``make_tp_mesh(1)``) and the port's on
bridged weights serve the same step-driven traffic with tracing on:
mixed prefill buckets, a prefix-cache hit, a sampled request, a request
too large to admit, deadlines and a priority request that preempts. Every
count of ``stats_summary()`` must be equal, and the Perfetto traces must
hold the same multiset of (track, name, phase) events. Wall times, the
compile counts (XLA compiles against kernel-library loads) and the
roofline record (the JAX engine analyses its compiled HLO, the port counts
one run of its decode step: ``tests/test_torch_roofline.py`` holds the
two against each other) are left out.

The port's own contracts follow ``tests/test_obs.py`` and
``tests/test_obs_live.py``, whose engine tests fail on jax 0.9 only for
their mesh: tracing off is free and changes no token, ``reset_stats()``
mid-traffic is atomic, the SLO monitor sheds the lowest priority as
structured results, a step-time spike gives one valid bundle, and
scrapes racing ``reset_stats()`` stay parseable.
"""

import collections
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

import repro_torch.obs.trace as trace_mod
from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ScheduleParams as JScheduleParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.obs import SloConfig, attach, validate_trace_file
from repro_torch.obs.prom import parse
from repro_torch.obs.slo import CRITICAL, OK
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import REJECT_SHED, REJECT_TOO_LARGE, ScheduleParams
from repro_torch.serving.sampling import SamplingParams


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return registry.get_smoke("qwen3-1.7b", num_layers=2, vocab_size=128, **kw)


def _prompts(n, rng=None, plen=12):
    rng = rng or np.random.default_rng(3)
    return [rng.integers(1, 127, plen).astype(np.int32) for _ in range(n)]


# ----------------------------------------------------------------------
# parity with the JAX engine
# ----------------------------------------------------------------------

# summary fields that hold wall time, or what only one package can count
NOT_COUNTS = {
    "ttft_ms", "queue_wait_ms", "prefill_s", "decode_s", "total_s", "tok_s", "decode_tok_s",
    "prefill_tok_s", "p50_token_latency_ms", "p95_token_latency_ms", "p99_token_latency_ms",
    "roofline",
}


def _counts(summary: dict) -> dict:
    out = {k: v for k, v in summary.items() if k not in NOT_COUNTS}
    # XLA compiles in the JAX engine, kernel-library loads in the port
    out["dispatch_guard"] = {"host_syncs": summary["dispatch_guard"]["host_syncs"]}
    return out


def _perfetto_multiset(path) -> collections.Counter:
    events = json.loads(open(path).read())["traceEvents"]
    tracks = {(e["pid"], e["tid"]): e["args"]["name"] for e in events if e["ph"] == "M"}
    return collections.Counter(
        (tracks[(e["pid"], e["tid"])], e["name"], e["ph"]) for e in events if e["ph"] != "M"
    )


def _traffic(eng, sp_cls, sch_cls, page):
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(1, 127, 2 * page + 5).astype(np.int32)
    uids = {eng.submit(sys_prompt, 10): "a"}
    fins = eng.step()  # the system prompt is prefilled and indexed
    hit = np.concatenate([sys_prompt[: 2 * page], rng.integers(1, 127, 30).astype(np.int32)])
    uids[eng.submit(hit, 8, sampling=sp_cls(temperature=0.8, top_k=40, top_p=0.95, seed=5))] = "hit"
    uids[eng.submit(rng.integers(1, 127, 20).astype(np.int32), 6,
                    schedule=sch_cls(deadline_s=600.0))] = "short"
    uids[eng.submit(rng.integers(1, 127, 5 * page).astype(np.int32), 4)] = "too_large"
    for _ in range(4):
        fins += eng.step()
    uids[eng.submit(rng.integers(1, 127, 9).astype(np.int32), 4,
                    schedule=sch_cls(priority=3, deadline_s=600.0))] = "vip"
    fins += eng.drain(max_steps=500)
    return {uids[f.uid]: (f.tokens.tolist(), f.finish_reason, f.reject_reason, f.preemptions,
                          f.prefix_hit_tokens) for f in fins}


def test_stats_and_trace_equal_jax_engine(tmp_path):
    jcfg = jreg.get_smoke("qwen3-1.7b", num_layers=2, vocab_size=128)
    cfg = _cfg()
    page = cfg.attn_block
    ecfg = dict(max_slots=2, max_len=4 * page, prefix_cache=True, preempt_min_steps=2, trace=True)
    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg))
    want = _traffic(jeng, JSamplingParams, JScheduleParams, page)
    sd = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = Engine(cfg, engine_cfg=EngineConfig(**ecfg), params=sd, device="cpu")
    got = _traffic(eng, SamplingParams, ScheduleParams, page)
    assert got == want
    assert got["too_large"][2] == REJECT_TOO_LARGE
    assert got["hit"][4] == 2 * page
    assert sum(v[3] for v in got.values()) >= 1  # the vip preempted someone
    # the traces first: the JAX engine's roofline() (in stats_summary)
    # adds an instant to its ring
    paths = {name: str(tmp_path / f"{name}.json") for name in ("jax", "port")}
    jeng.export_perfetto(paths["jax"])
    eng.export_perfetto(paths["port"])
    validate_trace_file(paths["port"])
    want_ev, got_ev = (_perfetto_multiset(paths[n]) for n in ("jax", "port"))
    assert got_ev == want_ev
    assert got_ev[("engine:decode", "decode_step", "E")] == eng.stats.decode_steps
    assert got_ev[("engine:host_sync", "host_sync", "B")] == eng.stats.decode_steps
    js, s = jeng.stats_summary(), eng.stats_summary()
    hits = s["prefix_cache"].pop("hits")  # the port's one extra count
    assert hits == 1
    assert set(s) == set(js) and set(s["prefix_cache"]) == set(js["prefix_cache"])
    assert _counts(s) == _counts(js)
    assert s["preemption"]["preemptions"] >= 1 and s["slo"]["with_deadline"] == 2
    assert s["dispatch_guard"]["step_compiles"] == 0  # nothing is built on the CPU


# ----------------------------------------------------------------------
# the port's own contracts
# ----------------------------------------------------------------------


def test_tracer_disabled_bit_identical_and_zero_obs_work(monkeypatch):
    """trace=False is free: the same tokens, and not one call into the
    tracer's clock from the serve loop."""
    cfg = _cfg()
    prompts = _prompts(3, np.random.default_rng(5))
    calls = {"n": 0}
    real = trace_mod.perf_counter_ns

    def counting():
        calls["n"] += 1
        return real()

    monkeypatch.setattr(trace_mod, "perf_counter_ns", counting)
    streams = {}
    for on in (False, True):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=64, trace=on), device="cpu")
        calls["n"] = 0
        for p in prompts:
            eng.submit(p, 8)
        fins = eng.drain(max_steps=300)
        streams[on] = [f.tokens.tolist() for f in sorted(fins, key=lambda f: f.uid)]
        if on:
            assert calls["n"] > 0 and eng.tracer.n_recorded > 0
        else:
            assert calls["n"] == 0, f"the untraced engine read the tracer clock {calls['n']} times"
    assert streams[True] == streams[False]


def test_reset_stats_mid_traffic_is_atomic(tmp_path):
    """reset_stats() with requests in flight: the registry zeroes, open
    spans close as truncated, and the summary and a later export stay
    consistent."""
    eng = Engine(_cfg(), engine_cfg=EngineConfig(max_slots=2, max_len=64, trace=True), device="cpu")
    for p in _prompts(2, np.random.default_rng(8), plen=10):
        eng.submit(p, 12)
    for _ in range(3):
        eng.step()
    assert eng.tracer.open_spans()  # decode spans are live mid-traffic
    assert eng.stats.decode_steps > 0
    eng.reset_stats()
    assert eng.tracer.truncated_spans > 0 and eng.tracer.open_spans() == {}
    assert eng.stats.decode_steps == 0 and eng.stats.finished == 0
    assert eng.metrics["repro_serve_decode_steps_total"].value == 0
    assert len(eng.drain(max_steps=300)) == 2  # traffic survives the reset
    s = eng.stats_summary()
    assert s["requests_finished"] == 2 and s["decode_steps"] > 0
    out = tmp_path / "after_reset.json"
    eng.export_perfetto(str(out))
    validate_trace_file(str(out))
    assert eng.stats.registry is eng.metrics and eng.swap.stats.registry is eng.metrics
    assert eng.swap.stats.out_pages == 0


def test_monitoring_never_changes_streams_and_vars_agree():
    """Monitor + SLO (no shed) emits the bare engine's tokens, and a
    /vars window covering the run reproduces stats_summary()'s
    percentiles."""
    cfg = _cfg()
    prompts = _prompts(3)
    streams, monitored = {}, None
    for on in (False, True):
        extra = dict(monitor=300.0, slo=SloConfig(target=0.99, fast_window_s=30.0,
                                                  slow_window_s=300.0)) if on else {}
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=64, **extra), device="cpu")
        for p in prompts:
            eng.submit(p, 8, schedule=ScheduleParams(deadline_s=120.0))
        fins = eng.drain(max_steps=300)
        streams[on] = [f.tokens.tolist() for f in sorted(fins, key=lambda f: f.uid)]
        monitored = eng
    assert streams[True] == streams[False]
    v = monitored.windowed_vars()
    s = monitored.stats_summary()
    assert v["token_latency_ms"]["p50_ms"] == pytest.approx(s["p50_token_latency_ms"], abs=1e-6)
    assert v["ttft_ms"]["p95_ms"] == pytest.approx(s["ttft_ms"]["p95_ms"], abs=1e-6)
    assert v["memory"]["pool_pages"] > 0 and 0.0 <= v["memory"]["fragmentation"] <= 1.0
    assert v["memory"]["device_bytes_in_use"] == 0  # the CPU has no allocator statistics
    slo = monitored.slo_state()
    assert slo["enabled"] and slo["state"] == OK
    bare = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=64), device="cpu")
    assert bare.windowed_vars() == {"enabled": False}
    assert bare.slo_state() == {"enabled": False}
    assert bare.window_samples("repro_serve_ttft_seconds") == []


def test_slo_shed_rejects_lowest_priority_as_structured_results():
    """Impossible deadlines drive the monitor CRITICAL; with shed armed,
    queued priority-0 requests come back as REJECT_SHED results and the
    priority-1 work finishes. With shed off nothing is shed."""
    cfg = _cfg()
    for shed in (False, True):
        eng = Engine(cfg, engine_cfg=EngineConfig(
            max_slots=1, max_len=64, preemption=False, monitor=True,
            slo=SloConfig(target=0.9, fast_window_s=0.5, slow_window_s=1.0, warn_burn=2.0,
                          critical_burn=6.0, shed=shed, shed_max_per_tick=4),
        ), device="cpu")
        prompts = _prompts(8, np.random.default_rng(11))
        for p in prompts[:4]:
            eng.submit(p, 6, schedule=ScheduleParams(priority=1, deadline_s=1e-3))
        for p in prompts[4:]:
            eng.submit(p, 6, schedule=ScheduleParams(priority=0))
        fins = eng.drain(max_steps=3000)
        assert len(fins) == 8
        sheds = [f for f in fins if f.reject_reason == REJECT_SHED]
        if shed:
            assert sheds and all(f.finish_reason == "rejected" for f in sheds)
            shed0 = [f for f in sheds if f.schedule.priority == 0]
            shed1 = [f for f in sheds if f.schedule.priority == 1]
            assert {f.uid for f in shed0} == {f.uid for f in fins if f.schedule.priority == 0}
            if shed1:
                assert min(f.finish_step for f in shed1) >= max(f.finish_step for f in shed0)
            assert eng._slo_mon.transitions[CRITICAL] >= 1
            assert eng.metrics["repro_serve_rejected_total"].get(REJECT_SHED) == len(sheds)
            # sheds are not SLO misses: only the 4 deadline'd requests count
            assert eng.stats.slo_total == 4 - len(shed1)
        else:
            assert not sheds and all(f.finish_reason != "rejected" for f in fins)


def test_step_time_spike_produces_exactly_one_valid_bundle(tmp_path):
    """A decode step-time spike after warm-up: exactly one incident
    bundle, and its trace (counter lanes included) validates."""
    eng = Engine(_cfg(), engine_cfg=EngineConfig(
        max_slots=2, max_len=64, trace=True, flight_dir=str(tmp_path / "incidents"),
        spike_factor=8.0,
    ), device="cpu")
    for p in _prompts(2):
        eng.submit(p, 6)
    eng.drain(max_steps=300)
    before = len(eng._flight.incidents)
    for _ in range(32):
        eng._observe_step(0.01, 1, 0)
    eng._observe_step(5.0, 1, 0)
    eng._observe_step(5.0, 1, 0)  # cooldown and debounce: still one bundle
    bundles = eng._flight.incidents[before:]
    assert len(bundles) == 1 and "step_time_spike" in bundles[0]
    d = tmp_path / "incidents" / bundles[0].rsplit("/", 1)[-1]
    man = json.loads((d / "manifest.json").read_text())
    assert man["context"]["decode_step_s"] == 5.0
    assert man["config"]["max_slots"] == 2 and man["config"]["paged_impl"] == "plain"
    assert set(man["files"]) == {"manifest.json", "metrics.prom", "trace.json"}
    rep = validate_trace_file(str(d / "trace.json"))
    assert rep["counter_series"] >= 3 and rep["spans"] > 0
    assert eng.metrics["repro_flight_incidents_total"].get("step_time_spike") == 1
    # a kernel-library build or load after the first clean step is a
    # dispatch_guard_trip bundle
    eng._observe_step(None, 0, 2)
    assert "dispatch_guard_trip" in eng._flight.incidents[-1]


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def test_concurrent_scrape_vs_reset_stats():
    """Scrapes racing reset_stats() and live stepping always get a
    parseable exposition and consistent JSON."""
    eng = Engine(_cfg(), engine_cfg=EngineConfig(max_slots=2, max_len=64, monitor=True, slo=SloConfig()),
                 device="cpu")
    srv = attach(eng)
    stop = threading.Event()
    errors: list[str] = []
    scrapes = {"n": 0}

    def scraper():
        while not stop.is_set():
            try:
                _, body = _get(srv.url + "/metrics")
                parse(body)
                _, body = _get(srv.url + "/vars")
                assert json.loads(body)["enabled"] is True
                _, body = _get(srv.url + "/slo")
                assert json.loads(body)["enabled"] is True
                scrapes["n"] += 1
            except Exception as e:  # the failure path: reported below
                errors.append(repr(e))
                return

    t = threading.Thread(target=scraper, daemon=True)
    t.start()
    try:
        rng = np.random.default_rng(5)
        for _ in range(4):
            for p in _prompts(2, rng):
                eng.submit(p, 4)
            eng.drain(max_steps=300)
            eng.reset_stats()
    finally:
        stop.set()
        t.join(timeout=10.0)
        srv.stop()
    assert not t.is_alive()
    assert not errors, errors
    assert scrapes["n"] > 0
    assert eng.window_samples("repro_serve_ttft_seconds") == []


def test_engine_config_obs_validation():
    with pytest.raises(ValueError):
        EngineConfig(max_slots=1, max_len=32, trace=-4)
    with pytest.raises(ValueError):
        EngineConfig(max_slots=1, max_len=32, monitor=-1.0)
    with pytest.raises(TypeError):
        EngineConfig(max_slots=1, max_len=32, slo=object())
    assert EngineConfig(max_slots=1, max_len=32, trace=1024).trace == 1024
    assert EngineConfig(max_slots=1, max_len=32, monitor=1.0).monitor_window_s == 1.0
    assert EngineConfig(max_slots=1, max_len=32, slo=SloConfig(slow_window_s=90.0)).monitor_window_s == 90.0
    assert EngineConfig(max_slots=1, max_len=32).monitor_window_s is None
