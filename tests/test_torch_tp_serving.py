"""Tensor-parallel serving of the port on the CPU (``Engine(mesh=
make_tp_mesh(2, ["cpu"] * 2))``), held to the contracts of the JAX
package's ``tests/test_mesh_serving.py``, whose mesh tests need eight
forced host devices: the tp engine's streams equal the single-device
engine's, greedy and seeded-sampled, here the JAX ``Engine`` on
``make_tp_mesh(1)`` with the same weights (``bridge.params_from_jax``),
the prefix cache on (d); ``ReplicaRouter(replicas=2, tp=2)`` gives the
same streams (e); every configuration the port does not shard raises
naming its ROADMAP item, and too few devices raise (f); the serve CLI's
``--tp 2 --strategy tp`` and ``bench.serve_mesh --smoke`` (g). Streams and
counts exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh as jax_make_tp_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch.bench import serve_mesh
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_local_mesh, make_tp_mesh
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
    return [rng.integers(1, 250, size=ln).astype(np.int32) for ln in (9, 17, 5, 12)[:n]]


def _sp(cls, i, sampled):
    return cls(temperature=0.8, top_k=40, seed=100 + i) if sampled else None


ECFG = dict(max_slots=4, max_len=64, prefix_cache=True)


def _jax_streams(jcfg, sampled):
    """The JAX engine on one device (the contract: tp streams equal tp 1's)
    and its weights as numpy."""
    jeng = JEngine(jcfg, jax_make_tp_mesh(1), engine_cfg=JEngineConfig(**ECFG), seed=0)
    for i, p in enumerate(_prompts()):
        jeng.submit(p, 12, sampling=_sp(JSamplingParams, i, sampled))
    want = {f.uid: f.tokens.tolist() for f in jeng.drain(max_steps=80)}
    return want, jax.tree.map(np.asarray, jeng.params)


@pytest.mark.parametrize("sampled", [False, True])
def test_tp2_engine_streams_equal_jax_engine(sampled):
    cfg, jcfg = _cfgs()
    want, tree = _jax_streams(jcfg, sampled)
    eng = Engine(cfg, engine_cfg=EngineConfig(**ECFG), mesh=make_tp_mesh(2, ["cpu"] * 2),
                 params=params_from_jax(jax.tree.map(jnp.asarray, tree), cfg, "cpu"))
    assert eng.tp == 2 and eng.distinct_devices == 1 and eng.paged_impl == "plain"
    # one pool a shard, each with its kv head (smoke: 2 kv heads over 2)
    assert len(eng.kv.buffers) == 2
    assert [tuple(shard[0]["k"].shape[-2:]) for shard in eng.kv.buffers] == [(1, cfg.head_dim)] * 2
    for i, p in enumerate(_prompts()):
        eng.submit(p, 12, sampling=_sp(SamplingParams, i, sampled))
    got = {f.uid: f.tokens.tolist() for f in eng.drain(max_steps=80)}
    assert got == want
    s = eng.stats_summary()
    assert s["tp"] == 2 and s["distinct_devices"] == 1 and s["requests_finished"] == 4
    # one device's count of the tp 2 decode step, its joins' collectives included
    assert s["roofline"]["available"] is True and s["roofline"]["collective_bytes"] > 0


def test_tp2_prefix_cache_hit():
    """A prompt served twice: the second admission maps the first's full
    pages (shared by both shards' pools through the one page table) and
    prefills only the suffix; the stream is the single-device engine's."""
    cfg, _ = _cfgs()
    ecfg = EngineConfig(max_slots=2, max_len=256, prefix_cache=True)
    base = Engine(cfg, engine_cfg=ecfg, device="cpu")
    eng = Engine(cfg, engine_cfg=ecfg, mesh=make_tp_mesh(2, ["cpu"] * 2),
                 params=base.model.state_dict())
    prompt = np.random.default_rng(1).integers(1, 250, size=150).astype(np.int32)
    streams = []
    for e in (base, eng):
        e.submit(prompt, 8)
        streams.append(e.drain(max_steps=40)[0].tokens.tolist())
        e.submit(prompt, 8)
        assert e.drain(max_steps=40)[0].tokens.tolist() == streams[-1]
    assert streams[0] == streams[1]
    assert eng.stats_summary()["prefix_cache"]["hit_tokens"] == 2 * cfg.attn_block


def test_tp2_preemption_swaps_every_shard():
    """A high-priority request preempts a running one: its pages go to host
    memory from both shards' pools and come back; the streams equal the
    single-device engine's."""
    from repro_torch.serving.request import ScheduleParams

    cfg, _ = _cfgs()
    base = Engine(cfg, engine_cfg=EngineConfig(max_slots=1, max_len=64, preempt_min_steps=1), device="cpu")
    sd = base.model.state_dict()

    def run(eng):
        lo = eng.submit(_prompts()[1], 12, schedule=ScheduleParams(priority=0))
        fins = eng.step()
        eng.step()
        hi = eng.submit(_prompts()[0], 6, schedule=ScheduleParams(priority=5))
        fins += eng.drain(max_steps=80)
        return {f.uid: f.tokens.tolist() for f in fins}, lo, hi

    want, _, _ = run(base)
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=1, max_len=64, preempt_min_steps=1),
                 mesh=make_tp_mesh(2, ["cpu"] * 2), params=sd)
    got, _, _ = run(eng)
    assert got == want
    pre = eng.stats_summary()["preemption"]
    assert pre["preemptions"] >= 1 and pre["out_bytes"] == pre["out_pages"] * eng.swap.page_bytes > 0
    assert eng.swap.page_bytes == base.swap.page_bytes  # the shards' halves add up to a page


def test_tp2_router_streams_equal_jax_engine():
    cfg, jcfg = _cfgs()
    want, tree = _jax_streams(jcfg, True)
    router = ReplicaRouter(cfg, replicas=2, tp=2, engine_cfg=EngineConfig(**ECFG),
                           params=params_from_jax(jax.tree.map(jnp.asarray, tree), cfg, "cpu"),
                           devices=["cpu"] * 4)
    assert [e.tp for e in router.engines] == [2, 2]
    uids = [router.submit(p, 12, sampling=_sp(SamplingParams, i, True)) for i, p in enumerate(_prompts())]
    got = {f.uid: f.tokens.tolist() for f in router.drain(max_steps=200)}
    assert got == want and sorted(got) == uids
    assert sum(e.stats.finished for e in router.engines) == 4
    s = router.stats_summary()
    assert s["tp"] == 2 and s["distinct_devices"] == 1


def test_refusals_name_their_roadmap_items():
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="2 replicas x tp=2 need 4 devices, have 3"):
        ReplicaRouter(cfg, replicas=2, tp=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="tp=2 needs 2 devices, have 1"):
        make_tp_mesh(2, ["cpu"])
    ecfg = EngineConfig(max_slots=2, max_len=64)

    def tp_engine(c, tp, **kw):
        return Engine(c, engine_cfg=ecfg, mesh=make_tp_mesh(tp, ["cpu"] * tp), **kw)

    # kv heads (2) that do not divide tp: the sequence-parallel mode
    with pytest.raises(ValueError, match="item 16"):
        tp_engine(cfg, 4)
    # nb_out that does not divide tp: 3 kv blocks of 64 over 2 shards
    odd = cfg.replace(num_heads=2, num_kv_heads=2, head_dim=96)
    with pytest.raises(ValueError, match="item 16"):
        tp_engine(odd, 2)
    with pytest.raises(ValueError, match="item 17"):
        tp_engine(registry.get_smoke("deepseek-moe-16b", sparse=True), 2)
    with pytest.raises(ValueError, match="item 18"):
        tp_engine(registry.get_smoke("mamba2-130m", sparse=True), 2)
    # positions off the model axis: serving does not shard by data
    with pytest.raises(ValueError, match="item 20"):
        Engine(cfg, engine_cfg=ecfg, mesh=make_local_mesh(model=2, devices=["cpu"] * 4))
    eng = tp_engine(cfg, 2)
    rec = eng.roofline()  # counted per device, with the collectives (no longer refused)
    assert rec["available"] and rec["collective_bytes"] > 0
    # a (1, 1) mesh is the single-device engine
    one = Engine(cfg, engine_cfg=ecfg, mesh=make_tp_mesh(1, ["cpu"]))
    assert one.tp == 1 and one.roofline()["available"]


SMOKE = ["--arch", "qwen3-1.7b", "--sparse", "--smoke", "--device", "cpu", "--batch", "4", "--slots", "2",
         "--prompt-len", "16", "--gen", "6"]


def test_serve_cli_tp(capsys):
    """``--tp 2 --strategy tp`` serves the grid of one device; ``--tp 2``
    alone exits as the JAX CLI does, and so do the production mesh on a
    machine with fewer devices and the Server at tp 2."""
    tp = serve.main(SMOKE + ["--tp", "2", "--strategy", "tp"])
    out = capsys.readouterr().out
    assert "tp 2 on 1 distinct device(s)" in out and tp.engine.tp == 2
    one = serve.main(SMOKE)
    assert [t.tolist() for t in tp.tokens] == [t.tolist() for t in one.tokens]
    fleet = serve.main(SMOKE + ["--tp", "2", "--strategy", "tp", "--replicas", "2"])
    assert [t.tolist() for t in fleet.tokens] == [t.tolist() for t in one.tokens]
    with pytest.raises(SystemExit, match="pass --strategy tp"):
        serve.main(SMOKE + ["--tp", "2"])
    with pytest.raises(SystemExit, match="needs 256 devices, this machine has 1"):
        serve.main(SMOKE + ["--production-mesh"])
    with pytest.raises(SystemExit, match="item 18"):
        serve.main(SMOKE + ["--tp", "2", "--strategy", "tp", "--legacy-server"])


def test_serve_mesh_bench_smoke(capsys):
    payload = serve_mesh.main(["--smoke", "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    assert json.loads(last) == json.loads(json.dumps(payload))
    assert payload["streams_equal"] and payload["router"]["streams_equal"]
    assert set(payload["by_tp"]) == {"1", "2"} and set(payload["refused"]) == {"4", "8"}
    assert all("item 16" in why for why in payload["refused"].values())
    assert payload["distinct_devices"] == 1 and payload["platform"] == "cpu"
    jax_keys = {"smoke", "devices", "platform", "batch", "prompt_len", "gen", "streams_equal", "by_tp", "router"}
    assert jax_keys <= set(payload)
    assert set(payload["by_tp"]["2"]) == {"devices", "distinct_devices", "paged_impl", "decode_tok_s",
                                          "wall_tok_s", "wall_s", "p95_token_latency_ms"}
