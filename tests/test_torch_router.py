"""The port's data-parallel ``ReplicaRouter`` (``repro_torch.serving.
router``, ``tp = 1``) on the CPU, held to the contracts of the JAX
package's ``tests/test_mesh_serving.py``, whose router tests need eight
forced host devices and a mesh: streams equal to one engine's, greedy and
sampled (here the JAX single ``Engine`` on ``make_tp_mesh(1)``, its
weights carried across by ``bridge.params_from_jax``), least-loaded
routing with router uids, merged fleet metrics, a replica that never saw
a request, ``obs.http.attach`` over the router, and the serve CLI's
``--replicas`` (``--tp`` without ``--strategy tp``, ``--production-mesh``
and the Server at tp 2 exit; tensor parallelism is
``tests/test_torch_tp_serving.py``'s). Streams and counts exact."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.obs import SloConfig
from repro_torch.obs.http import attach
from repro_torch.obs.prom import parse, render
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.sampling import SamplingParams


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(num_layers=2, vocab_size=256)
    return (registry.get_smoke("qwen3-1.7b", sparse=True).replace(**kw),
            jreg.get_smoke("qwen3-1.7b", sparse=True).replace(**kw))


def _prompts(n=4):
    rng = np.random.default_rng(0)
    return [rng.integers(1, 250, size=ln).astype(np.int32) for ln in (9, 17, 5, 12, 30)[:n]]


def _router(cfg, replicas=2, **ecfg):
    ecfg = {"max_slots": 4, "max_len": 64, **ecfg}
    return ReplicaRouter(cfg, replicas=replicas, engine_cfg=EngineConfig(**ecfg), devices=["cpu"] * replicas)


@pytest.mark.parametrize("sampled", [False, True])
def test_router_streams_equal_jax_single_engine(sampled):
    cfg, jcfg = _cfgs()
    ecfg = dict(max_slots=4, max_len=64, prefix_cache=True)
    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg), seed=0)
    tree = jax.tree.map(np.asarray, jeng.params)

    def sp(cls, i):
        return cls(temperature=0.8, top_k=40, seed=100 + i) if sampled else None

    for i, p in enumerate(_prompts()):
        jeng.submit(p, 12, sampling=sp(JSamplingParams, i))
    want = {f.uid: f.tokens.tolist() for f in jeng.drain(max_steps=80)}
    router = ReplicaRouter(cfg, replicas=2, engine_cfg=EngineConfig(**ecfg),
                           params=params_from_jax(jax.tree.map(jnp.asarray, tree), cfg, "cpu"),
                           devices=["cpu", "cpu"])
    uids = [router.submit(p, 12, sampling=sp(SamplingParams, i)) for i, p in enumerate(_prompts())]
    got = {f.uid: f.tokens.tolist() for f in router.drain(max_steps=200)}
    # same submit order -> the same router uids as the single engine's
    assert uids == sorted(want) and got == want
    # traffic spread over both replicas, every request accounted for
    assert all(n == 0 for n in router._outstanding)
    assert [e.stats.finished for e in router.engines] == [2, 2]


def test_least_loaded_routing_and_uid_retagging():
    cfg, _ = _cfgs()
    router = _router(cfg)
    uids = [router.submit(p, 3) for p in _prompts(5)]
    assert uids == [1, 2, 3, 4, 5]
    # outstanding counts, ties to the lowest index: 0, 1, 0, 1, 0
    assert [r for r, _ in (router._placed[u] for u in uids)] == [0, 1, 0, 1, 0]
    assert [local for _, local in (router._placed[u] for u in uids)] == [1, 1, 2, 2, 3]
    assert router._outstanding == [3, 2]
    fins = router.drain(max_steps=50)
    assert sorted(f.uid for f in fins) == uids  # router uids, not replica-local ones
    assert router.idle and router._placed == {} and router._outstanding == [0, 0]
    # the replicas share replica 0's weights (one card, one copy)
    w0, w1 = (dict(e.model.named_parameters())["embed.tok"] for e in router.engines)
    assert w0.data_ptr() == w1.data_ptr()


def test_router_merged_metrics_and_summary():
    cfg, _ = _cfgs()
    router = _router(cfg)
    for p in _prompts(5):
        router.submit(p, 4)
    router.drain(max_steps=50)
    merged = router.merged_metrics()
    per = [e.metrics for e in router.engines]
    assert merged["repro_serve_requests_finished_total"].value == 5
    steps = merged["repro_serve_step_latency_seconds"].samples
    assert len(steps) == sum(len(m["repro_serve_step_latency_seconds"].samples) for m in per)
    s = router.stats_summary()
    assert s["requests_finished"] == 5
    assert [r["requests_finished"] for r in s["per_replica"]] == [3, 2]
    assert s["roofline"] is router.engines[0].roofline() and s["roofline"]["available"]
    assert parse(render(merged))["repro_serve_requests_finished_total"] == 5
    router.reset_stats()
    assert router.merged_metrics()["repro_serve_requests_finished_total"].value == 0


def test_router_zero_traffic_replica_observability():
    """A replica that never saw a request does not poison fleet
    aggregation: merged metrics stay parseable, fleet percentiles come
    from the replica that has samples, and the fleet /slo state is
    defined."""
    cfg, _ = _cfgs()
    router = _router(cfg, monitor=60.0, slo=SloConfig(target=0.99, fast_window_s=10.0, slow_window_s=60.0))
    router.submit(_prompts(1)[0], 8)  # least-loaded -> replica 0 only
    fins = router.drain(max_steps=80)
    assert len(fins) == 1
    assert [e.stats.finished for e in router.engines] == [1, 0]
    flat = parse(render(router.merged_metrics()))
    assert flat["repro_serve_requests_finished_total"] == 1
    s = router.stats_summary()
    assert s["requests_finished"] == 1
    assert [r["requests_finished"] for r in s["per_replica"]] == [1, 0]
    assert s["per_replica"][1]["p50_token_latency_ms"] == 0.0
    v = router.windowed_vars()
    assert v["enabled"] and v["replicas"] == 2
    # fleet percentile == replica 0's (an average of averages would halve it)
    assert v["token_latency_ms"] == router.engines[0].windowed_vars()["token_latency_ms"]
    assert v["queue_depth"] == 0 and v["running_slots"] == 0
    slo = router.slo_state()
    assert slo["enabled"] and slo["state"] == "OK" and len(slo["per_replica"]) == 2


def test_attach_serves_the_router_fleet():
    cfg, _ = _cfgs()
    router = _router(cfg, monitor=30.0)
    for p in _prompts(3):
        router.submit(p, 4)
    router.drain(max_steps=50)
    srv = attach(router, "127.0.0.1:0")
    try:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            flat = parse(r.read().decode())
        with urllib.request.urlopen(srv.url + "/vars", timeout=10) as r:
            fleet = json.loads(r.read())
    finally:
        srv.stop()
    assert flat["repro_serve_requests_finished_total"] == 3  # both replicas, summed
    assert fleet["replicas"] == 2 and len(fleet["per_replica"]) == 2


def test_router_perfetto_has_one_process_a_replica(tmp_path):
    cfg, _ = _cfgs()
    router = _router(cfg, trace=True)
    for p in _prompts(2):
        router.submit(p, 3)
    router.drain(max_steps=50)
    path = tmp_path / "fleet.json"
    assert router.export_perfetto(str(path)) > 0
    pids = {e["pid"] for e in json.loads(path.read_text())["traceEvents"]}
    assert pids == {0, 1}


def test_router_refusals():
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="2 replicas x tp=2 need 4 devices, have 3"):
        ReplicaRouter(cfg, replicas=2, tp=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=">= 1"):
        ReplicaRouter(cfg, replicas=0, devices=["cpu"])
    with pytest.raises(ValueError, match="need 3 devices"):
        ReplicaRouter(cfg, replicas=3, devices=["cpu"])


CLI = ["--arch", "qwen3-1.7b", "--sparse", "--smoke", "--device", "cpu", "--batch", "5", "--slots", "2",
       "--prompt-len", "16", "--gen", "6"]


def test_serve_cli_replicas(capsys, tmp_path):
    """``--replicas 2`` serves through the router: the grid equals one
    engine's, with a fleet trace and snapshot."""
    trace, snap = tmp_path / "t.json", tmp_path / "m.prom"
    fleet = serve.main(CLI + ["--replicas", "2", "--trace-out", str(trace), "--metrics-out", str(snap)])
    out = capsys.readouterr().out
    assert isinstance(fleet.engine, ReplicaRouter) and "2 replicas" in out
    assert "per-replica finished: [3, 2]" in out
    one = serve.main(CLI)
    assert isinstance(one.engine, Engine)
    assert [t.tolist() for t in fleet.tokens] == [t.tolist() for t in one.tokens]
    assert parse(snap.read_text())["repro_serve_requests_finished_total"] == 5
    assert json.loads(trace.read_text())["traceEvents"]


# each flag and why it exits: tp without the tp layout (as the JAX CLI),
# also for the Server, and the production mesh on a machine with fewer
# devices
CLI_EXITS = {
    ("--tp", "2"): "pass --strategy tp",
    ("--production-mesh",): "needs 256 devices",
    ("--tp", "2", "--legacy-server"): "pass --strategy tp",
}


@pytest.mark.parametrize("flag", [list(f) for f in CLI_EXITS])
def test_serve_cli_tensor_parallel_still_exits(flag):
    with pytest.raises(SystemExit, match=CLI_EXITS[tuple(flag)]):
        serve.main(CLI + flag)
