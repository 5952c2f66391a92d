"""``repro_torch.obs`` against the JAX package's ``repro.obs``: the same
operations, with the tracer's ``perf_counter_ns`` and the window, SLO and
flight-recorder clocks patched to the same deterministic sequence in both
modules, must give equal outputs. Each case below is one component run
through both packages; Prometheus text is compared with its ``# HELP``
lines dropped (the port's help strings say what the port does)."""

import importlib
import itertools
import json
import types
import urllib.error
import urllib.request

import pytest

PACKAGES = ("repro", "repro_torch")
SUBMODULES = ("metrics", "trace", "perfetto", "prom", "windows", "slo", "flight", "http")


def _obs(pkg: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        root=importlib.import_module(f"{pkg}.obs"),
        **{m: importlib.import_module(f"{pkg}.obs.{m}") for m in SUBMODULES},
    )


class _Clock:
    """A settable clock for ``now_fn``/``clock`` arguments."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _no_help(text: str) -> str:
    return "\n".join(line for line in text.splitlines() if not line.startswith("# HELP"))


def _patch_ns(monkeypatch, o):
    """The tracer's clock: 1000, 2000, ... ns, the same in both packages."""
    ticks = itertools.count(1, 1)
    monkeypatch.setattr(o.trace, "perf_counter_ns", lambda: 1000 * next(ticks))


# ----------------------------------------------------------------------
# scenarios: each returns a JSON-able record of what the package produced
# ----------------------------------------------------------------------


def registry_ops(o, tmp_path, monkeypatch):
    a, b = o.metrics.MetricsRegistry(), o.metrics.MetricsRegistry()
    for reg, k in ((a, 1), (b, 2)):
        reg.counter("repro_x_total", "things").inc(7 * k)
        lc = reg.counter("repro_y_total", "labeled", labelname="bucket")
        lc.inc(3 * k, label=(4, 32))
        lc.inc(k, label=(8, 64))
        lc.inc(2)  # an unlabeled increment beside the labeled ones
        reg.counter("repro_s_total", "by kind", labelname="kind").inc(k, label="greedy")
        reg.gauge("repro_g", "gauge").set(2.5 * k)
        h = reg.histogram("repro_h_seconds", "hist")
        for v in (0.0004 * k, 0.02, 0.5 * k, 2.0):
            h.observe(v)
        reg.histogram("repro_occ_ratio", "occ", buckets=(0.25, 0.5, 1.0)).observe(0.5 * k)
        reg.gauge("repro_nan", "").set(float("nan") if k == 1 else float("inf"))
    b.counter("repro_only_b_total", "o").inc(9)
    merged = o.metrics.MetricsRegistry.merged([a, b])
    out = {}
    for name, reg in (("a", a), ("b", b), ("merged", merged)):
        text = o.prom.render(reg)
        out[name] = _no_help(text)
        out[name + "_parsed"] = repr(sorted(o.prom.parse(text).items()))
    path = tmp_path / f"{o.root.__name__}.prom"
    o.prom.write_snapshot(str(path), merged)
    out["snapshot"] = _no_help(path.read_text())
    h = merged["repro_h_seconds"]
    out["hist"] = [h.count, h.sum, h.percentile(50), h.percentile(99), h.mean(), h.min(),
                   h.max(), h.cumulative_buckets()]
    out["labeled"] = [merged["repro_y_total"].get((4, 32)), merged["repro_y_total"].value,
                      sorted(merged["repro_y_total"].items(), key=repr)]
    return out


def tracer_perfetto(o, tmp_path, monkeypatch):
    _patch_ns(monkeypatch, o)
    tr = o.trace.Tracer(capacity=16)
    slot, eng, ctr = tr.track("slot0"), tr.track("engine:decode"), tr.track("counters")
    nm = {n: tr.name(n) for n in ("decode", "decode_step", "finished", "queued", "live")}
    out = {}
    for step in range(3):  # wraps the 16-event ring
        tr.begin(slot, nm["decode"], step)
        tr.begin(eng, nm["decode_step"], 2)
        tr.counter(ctr, nm["live"], 3 + step)
        tr.end(eng, nm["decode_step"], 2, 0)
        tr.complete(slot, nm["queued"], 500, 250 + step, step)
        tr.instant(slot, nm["finished"], step)
    out["open"] = tr.open_spans()
    out["counts"] = [tr.n_events, tr.n_recorded]
    path = tmp_path / f"{o.root.__name__}-wrap.json"
    out["n_wrap"] = tr.export_perfetto(str(path))
    out["wrap"] = json.loads(path.read_text())
    out["wrap_report"] = o.perfetto.validate_trace_file(str(path))
    # reset with open spans: they are counted as truncated, their late
    # ends record nothing, and fresh spans export cleanly
    tr.reset()
    tr.end(slot, nm["decode"], 9)
    tr.begin(slot, nm["decode"], 7)
    tr.instant(eng, nm["finished"], 7)
    out["truncated"] = tr.truncated_spans
    path = tmp_path / f"{o.root.__name__}-reset.json"
    out["n_reset"] = tr.export_perfetto(str(path))
    out["reset"] = json.loads(path.read_text())
    out["events"] = tr.events()
    # two tracers in one file, as replicas' processes
    t2 = o.trace.Tracer(capacity=4)
    t2.instant(t2.track("queue"), t2.name("submit"), 1)
    path = tmp_path / f"{o.root.__name__}-two.json"
    out["n_two"] = o.perfetto.export_perfetto({0: tr, 1: t2}, str(path))
    out["two"] = json.loads(path.read_text())
    null = o.trace.NULL_TRACER
    out["null"] = [null.enabled, null.begin(0, 0), null.events(), null.open_spans(), null.n_events]
    return out


def windowed_view(o, tmp_path, monkeypatch):
    clk = _Clock()
    box = {"reg": o.metrics.MetricsRegistry()}

    def record(reg, k):
        reg.counter("c_total", "").inc(k)
        reg.counter("r_total", "", labelname="reason").inc(1, label="timeout" if k % 2 else "shed")
        reg.histogram("h_seconds", "").observe(0.001 * k)
        reg.gauge("g", "").set(k)

    w = o.windows.WindowedView(lambda: box["reg"], window_s=5.0, n_buckets=5, now_fn=clk)
    seq = []
    for i, t in enumerate((0.0, 0.4, 1.1, 2.5, 3.0, 4.9, 6.2, 7.0, 30.0, 31.5)):
        clk.t = t
        if i == 7:  # reset_stats swaps the registry: the window restarts
            box["reg"] = o.metrics.MetricsRegistry()
        record(box["reg"], i + 1)
        w.tick()
        seq.append({
            "delta": [w.delta("c_total"), w.delta("c_total", span_s=1.0),
                      w.delta("r_total", label="timeout")],
            "rate": [w.rate("c_total"), w.rate("c_total", 2.0)],
            "pct": [w.percentile("h_seconds", q, span) for q in (50, 95) for span in (None, 1.5)],
            "samples": w.samples("h_seconds"),
            "gauge": [w.gauge("g"), w.gauge("missing", 7)],
            "covered": w.covered_s,
        })
    e = o.windows.Ewma(0.3)
    seq.append([e.update(v) for v in (1.0, 2.0, 0.5, 4.0)] + [e.value, e.n])
    return seq


def burn_rate_monitor(o, tmp_path, monkeypatch):
    clk = _Clock()
    cfg = o.slo.SloConfig(target=0.9, fast_window_s=2.0, slow_window_s=10.0,
                          warn_burn=2.0, critical_burn=6.0)
    reg = o.metrics.MetricsRegistry()
    total = reg.counter("repro_serve_slo_requests_total", "")
    met = reg.counter("repro_serve_slo_met_total", "")
    fin = reg.counter("repro_serve_requests_finished_total", "")
    rej = reg.counter("repro_serve_rejected_total", "", labelname="reason")
    w = o.windows.WindowedView(lambda: reg, window_s=10.0, n_buckets=10, now_fn=clk)
    mon = o.slo.BurnRateMonitor(w, cfg)
    script = [  # (t, deadline'd, met, finished, rejections)
        (0.0, 10, 10, 10, {}), (1.0, 20, 0, 20, {}), (1.5, 0, 0, 0, {}),
        (3.0, 5, 4, 5, {"timeout": 2}), (6.0, 0, 0, 10, {"shed": 30}),
        (12.0, 10, 9, 10, {}), (100.0, 20, 19, 20, {}), (100.5, 10, 3, 10, {}),
        (101.0, 0, 0, 10, {"timeout": 10}),
    ]
    out = []
    for t, n_total, n_met, n_fin, rejections in script:
        clk.t = t
        total.inc(n_total)
        met.inc(n_met)
        fin.inc(n_fin)
        for reason, n in rejections.items():
            rej.inc(n, label=reason)
        w.tick()
        out.append(mon.evaluate())
    out.append(dict(mon.transitions))
    out.append([o.slo.OK, o.slo.WARN, o.slo.CRITICAL])
    return out


def spike_and_flight(o, tmp_path, monkeypatch):
    _patch_ns(monkeypatch, o)
    det = o.flight.SpikeDetector(factor=4.0, min_samples=8, cooldown=4, min_value=0.005)
    signal = [0.01] * 8 + [1.0, 1.0] + [0.01] * 6 + [0.002, 0.5] + [1.0] * 12 + [9.0]
    fired = [(det.observe(v), det.baseline) for v in signal]
    clk = _Clock()
    reg = o.metrics.MetricsRegistry()
    reg.counter("c_total", "help").inc(3)
    tr = o.trace.Tracer(capacity=8)
    tk = tr.track("slot0")
    tr.begin(tk, tr.name("decode"), 1)
    fr = o.flight.FlightRecorder(tmp_path / o.root.__name__, min_interval_s=1.0,
                                 max_bundles=3, clock=clk)
    bundles = []
    for t, kind in ((0.0, "step_time_spike"), (0.5, "step_time_spike"), (0.6, "slo_critical"),
                    (2.0, "step_time_spike"), (9.0, "dispatch_guard_trip")):
        clk.t = t
        path = fr.capture(kind, tracer=tr, metrics=reg, config={"max_slots": 2},
                          context={"t": t})
        if path is None:
            bundles.append(None)
            continue
        d = tmp_path / o.root.__name__ / path.rsplit("/", 1)[-1]
        man = json.loads((d / "manifest.json").read_text())
        del man["captured_unix_s"]
        bundles.append({
            "name": d.name.split("-", 2)[-1],  # without the wall-clock stamp
            "manifest": man,
            "prom": _no_help((d / "metrics.prom").read_text()),
            "trace": json.loads((d / "trace.json").read_text()),
            "report": o.perfetto.validate_trace_file(str(d / "trace.json")),
        })
    return {"fired": fired, "n_fired": det.fired, "bundles": bundles}


BAD_TRACES = [
    {"traceEvents": "nope"},
    {"nope": []},
    {"traceEvents": [{"ph": "E", "pid": 0, "tid": 0, "ts": 1, "name": "x"}]},
    {"traceEvents": [{"ph": "B", "pid": 0, "tid": 0, "ts": 2, "name": "x"},
                     {"ph": "E", "pid": 0, "tid": 0, "ts": 1, "name": "x"}]},
    {"traceEvents": [{"ph": "B", "pid": 0, "tid": 0, "ts": 1, "name": "x"}]},
    {"traceEvents": [{"ph": "B", "pid": 0, "tid": 0, "ts": 1, "name": "x"},
                     {"ph": "E", "pid": 0, "tid": 0, "ts": 2, "name": "y"}]},
    {"traceEvents": [{"ph": "Q", "pid": 0, "tid": 0, "ts": 1, "name": "x"}]},
    {"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "ts": 1, "name": "x", "dur": -1}]},
    {"traceEvents": [{"ph": "C", "pid": 0, "tid": 1, "ts": 1.0, "name": "q",
                      "args": {"value": True}}]},
    {"traceEvents": [{"ph": "C", "pid": 0, "tid": 1, "ts": 1.0, "name": "q", "args": {}}]},
    {"traceEvents": [{"ph": "C", "pid": 0, "tid": 1, "ts": 2.0, "name": "q", "args": {"value": 1}},
                     {"ph": "C", "pid": 0, "tid": 1, "ts": 1.0, "name": "q", "args": {"value": 1}}]},
    {"traceEvents": [{"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
                      "args": {"name": "slot0"}},
                     {"ph": "X", "pid": 0, "tid": 0, "ts": 0.0, "dur": 1.0, "name": "decode",
                      "args": {}}]},
]


def trace_validation(o, tmp_path, monkeypatch):
    out = []
    for i, payload in enumerate(BAD_TRACES):
        try:
            out.append({"ok": o.perfetto.validate_trace(payload)})
        except o.perfetto.TraceValidationError as e:
            out.append({"error": str(e)})
        path = tmp_path / f"{o.root.__name__}-{i}.json"
        path.write_text(json.dumps(payload))
        try:
            out.append({"file_ok": o.perfetto.validate_trace_file(str(path))})
        except o.perfetto.TraceValidationError as e:
            out.append({"file_error": str(e)})
    bad_json = tmp_path / f"{o.root.__name__}-bad.json"
    bad_json.write_text("{not json")
    try:
        o.perfetto.validate_trace_file(str(bad_json))
        out.append("accepted")
    except (ValueError, o.perfetto.TraceValidationError) as e:
        out.append(type(e).__name__)
    return out


def http_routes(o, tmp_path, monkeypatch):
    reg = o.metrics.MetricsRegistry()
    reg.counter("c_total", "help").inc(5)
    reg.histogram("h_seconds", "h").observe(0.25)

    def boom():
        raise RuntimeError("nope")

    out = {"split": [o.http.split_listen("127.0.0.1:9090"), o.http.split_listen("[::1]:0")]}
    try:
        o.http.split_listen("9090")
    except ValueError as e:
        out["split_error"] = str(e)
    srv = o.http.MetricsServer("127.0.0.1", 0, registry_fn=lambda: reg,
                               vars_fn=lambda: {"enabled": True, "tok_s": 1.5}, slo_fn=boom)
    with srv:
        for route in ("/metrics", "/healthz", "/vars?span_s=5", "/slo", "/nope"):
            try:
                with urllib.request.urlopen(srv.url + route, timeout=10) as r:
                    out[route] = [r.status, r.headers["Content-Type"], _no_help(r.read().decode())]
            except urllib.error.HTTPError as e:
                out[route] = [e.code]
    return out


SCENARIOS = [registry_ops, tracer_perfetto, windowed_view, burn_rate_monitor, spike_and_flight,
             trace_validation, http_routes]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_obs_equals_reference(scenario, tmp_path, monkeypatch):
    ref, port = (scenario(_obs(pkg), tmp_path, monkeypatch) for pkg in PACKAGES)
    assert port == ref


def test_port_obs_exports_match_reference():
    """The same public surface as ``repro.obs``, name for name (that the
    port imports neither JAX nor ``repro`` is test_torch_imports')."""
    ref, port = _obs("repro"), _obs("repro_torch")
    assert port.root.__all__ == ref.root.__all__
    for m in SUBMODULES:
        assert getattr(getattr(port, m), "__all__", None) == getattr(getattr(ref, m), "__all__", None), m
