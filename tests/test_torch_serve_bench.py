"""The port's serving benchmark (``repro_torch.bench.serve_engine``, the
twin of ``benchmarks/serve_engine.py``) and serving example
(``repro_torch.examples.serve_lm``, the twin of ``examples/serve_lm.py``)
at the JAX scripts' smoke sizes on the CPU.

The benchmark's own assertions are the JAX script's (token streams
identical across the modes each scenario compares, and the gains it
asserts); here it must run through all of them and write a JSON whose
keys are ``BENCH_serve.json``'s, at the top level and in each scenario
the port runs. Nine paired repeats in place of the smoke run's one: the
overhead floors compare the decode rates of two engines over three decode
steps each, where one scheduling hiccup of a busy CPU is a large share of
a 2 ms step, and the median of nine pairs rides over a few of them."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench import serve_engine
from repro_torch.examples import serve_lm
from repro_torch.obs import validate_trace_file

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys_equal(want, got, path=""):
    assert set(got) == set(want), (path, sorted(set(want) ^ set(got)))
    for k, w in want.items():
        if isinstance(w, dict) and k not in ("prefill_by_bucket", "slo_transitions"):
            _keys_equal(w, got[k], f"{path}/{k}")


def test_bench_smoke_runs_every_scenario_with_the_reference_keys(tmp_path, monkeypatch):
    # the burst's deadlines, counted in engine steps: every armed replay's
    # {mode: (finished, wall, steps, {uid: (steps taken, deadline steps)})}
    armed = []
    replay = serve_engine._replay_in_turn

    def spy(engines, items, calibration):
        runs, rounds = replay(engines, items, calibration)
        if calibration is not None:
            armed.append(runs)
        return runs, rounds

    monkeypatch.setattr(serve_engine, "_replay_in_turn", spy)
    out, trace = tmp_path / "bench.json", tmp_path / "trace.json"
    payload = serve_engine.main(["--smoke", "--device", "cpu", "--repeats", "9", "--out", str(out),
                                 "--trace-out", str(trace), "--listen", "127.0.0.1:0"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(payload, default=float))
    ref = json.loads((ROOT / "BENCH_serve.json").read_text())
    assert set(payload) == set(ref)
    mesh = payload["mesh"]  # bench.serve_mesh's payload on the same weights
    # every tp of the JAX list: 4 and 8 (2 kv heads) in the sequence-parallel mode
    assert mesh["streams_equal"] and mesh["router"]["streams_equal"] and set(mesh["by_tp"]) == {"1", "2", "4", "8"}
    assert mesh["refused"] == {}
    guard = payload["dispatch_guard"]  # enforced at --smoke: a trip raises
    assert guard["enforced"] and guard["clean"] and guard["explicit_syncs"] == guard["steps"]
    assert payload["paged_impl_default"] == "plain" and set(payload["decode_by_impl"]) == {"plain"}
    assert payload["config"]["reduced"] == {} and payload["config"]["device"] == "cpu"
    obs = dict(payload["observability"])
    assert obs.pop("trace_events_written") >= validate_trace_file(str(trace))["events"] > 0  # --trace-out
    for key in ("server", "decode_by_sampler", "dispatch_guard", "prefix_cache", "goodput",
                "observability_live"):
        _keys_equal(ref[key], payload[key], key)
    _keys_equal(ref["observability"], obs, "observability")
    assert payload["observability_live"]["live_scrape"]["midrun_metric_samples"] > 0  # --listen
    # what the scenarios show at smoke width, as in the JAX file
    good = payload["goodput"]
    assert good["burst"]["on"]["preemptions"] > 0
    # SLO attainment with preemption above that without, in engine steps
    # (each request's steps from submission to finish against its
    # deadline's): a drift of the host's pace cannot flip it, as it can
    # the wall-clock attainment
    burst = armed[0]  # the first armed replay is the burst's

    def met_in_steps(mode):
        took = [(n, d) for n, d in burst[mode][3].values() if d is not None]
        return sum(n <= d for n, d in took) / len(took)

    assert met_in_steps("on") > met_in_steps("off")
    assert payload["prefix_cache"]["on"]["hit_rate"] > 0
    shed = payload["observability_live"]["slo_shed"]
    assert shed["on"]["sheds"] > 0 and shed["off"]["sheds"] == 0
    assert payload["engine_uniform"]["generated_tokens"] == 2 * 4


def test_full_width_cuts_only_trace_sizes():
    """The full-width default changes trace sizes the JAX script has, and
    nothing of the model."""
    assert set(serve_engine.FULL_CUTS) <= set(serve_engine.SIZES)
    for key, (value, why) in serve_engine.FULL_CUTS.items():
        jax_value = serve_engine.SIZES[key][1]
        assert why and (jax_value is None or type(value) is type(jax_value)), key


def test_serve_example_smoke(capsys):
    """Six requests (two submitted mid-flight) with four sampler kinds,
    each to its full length."""
    finished = serve_lm.main(["--smoke", "--device", "cpu"])
    assert [len(f.tokens) for f in finished] == [12, 6, 10, 8, 5, 9]
    assert all(f.finish_reason == "length" for f in finished)
    # greedy takes the argmax over the padded vocabulary (256 here), as
    # the JAX engine does
    assert all(0 <= t < 256 for f in finished for t in f.tokens)
    assert max(f.admit_step for f in finished) > 0  # late arrivals took freed slots
    out = capsys.readouterr().out
    assert "50 tokens" in out and "by sampler" in out
    assert np.isfinite(float(out.split(" tok/s")[0].split(", ")[-1]))
