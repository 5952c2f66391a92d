"""The port's serve CLI (``repro_torch.launch.serve``), its fixed-batch
``Server`` oracle, the contiguous-cache decode path under it, and the
seeded workloads (``serving.workloads``), against the JAX package on the
CPU.

``Server.generate`` must equal the JAX ``Server``'s tokens on bridged fp32
smoke weights, and ``T.prefill``/``T.decode_step`` the JAX functions'
logits (dense and pixelfly-sparse decode reads). The CLI serves the smoke
model with ``--device cpu``, gives the ``--legacy-server`` grid, writes a
valid trace, snapshot and flight directory, answers its four routes while
it serves, and refuses what needs distribution. The workload generators
give the JAX package's items for the same seeds, and ``goodput`` its
numbers for the same finished list.
"""

import dataclasses
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.launch.mesh import make_tp_mesh
from repro.models import transformer as JT
from repro.serving import request as jrequest
from repro.serving import workloads as jworkloads
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.obs import validate_trace_file
from repro_torch.obs.prom import parse
from repro_torch.serving import request, workloads
from repro_torch.serving.sampling import SamplingParams


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMOKE = ["--arch", "qwen3-1.7b", "--sparse", "--smoke", "--device", "cpu"]


# ----------------------------------------------------------------------
# the contiguous-cache path and the Server oracle
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "sparse,plen,gen",
    [(True, 20, 11), (False, 30, 6), (True, 7 * 64, 63)],
    ids=["sparse-dense-read", "dense", "sparse-read-8-blocks"],
)
def test_prefill_and_decode_step_equal_jax(sparse, plen, gen):
    """The last case's cache is 8 blocks of 64: the pixelfly decode read
    (``sparse_decode_attention``) skips blocks once the query is 5 blocks
    in; the others take the dense read."""
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=sparse, num_layers=2)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=sparse, num_layers=2)
    jp = JT.init_model(jax.random.PRNGKey(1), jcfg)
    model = T.init_model(cfg, params=params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"),
                         device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
    jl, jcaches = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(prompts)})
    tl, tcaches = T.prefill(cfg, model, {"tokens": prompts})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for jc, tc in zip(jcaches, tcaches):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=1e-4, atol=1e-4)
    max_len = plen + gen + 1
    jc, tc = JT.init_cache(jcfg, 2, max_len), T.init_cache(cfg, 2, max_len, device="cpu")
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, p, c, t, pos))
    tok = prompts[:, 0]
    for i in range(max_len - 1):
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        tl, tc = T.decode_step(cfg, model, tc, torch.from_numpy(tok), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        tok = prompts[:, i + 1] if i + 1 < plen else np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_server_generate_equals_jax_server():
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=True)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    jsrv = jserve.Server(jcfg, make_tp_mesh(1))
    srv = serve.Server(cfg, params=params_from_jax(jax.tree.map(np.asarray, jsrv.params), cfg, "cpu"),
                       device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    want = jsrv.generate(prompts, 12)
    got = srv.generate(prompts, 12)
    assert got.dtype == np.int32 and got.shape == (3, 12)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------


def test_cli_serves_and_matches_legacy_server(capsys):
    args = SMOKE + ["--batch", "4", "--slots", "2", "--prompt-len", "32", "--gen", "8"]
    served = serve.main(args)
    out = capsys.readouterr().out
    assert "served 4 requests / 32 tokens" in out
    assert "paged decode: plain PyTorch gather (CPU)" in out
    s = served.engine.stats_summary()
    assert s["requests_finished"] == 4 and s["generated_tokens"] == 32
    legacy = serve.main(args + ["--legacy-server"])
    assert legacy.engine is None and "generated (4, 8) tokens" in capsys.readouterr().out
    # the engine's grid is the oracle's
    np.testing.assert_array_equal(np.stack(served.tokens), np.stack(legacy.tokens))


def test_cli_observability_outputs(tmp_path, monkeypatch, capsys):
    """--trace-out, --metrics-out and --flight-dir write valid files, and
    --listen answers all four routes while the engine serves."""
    routes = {}
    real_listen = serve._maybe_listen

    def listen_and_scrape(engine, args):
        srv = real_listen(engine, args)
        for route in ("/metrics", "/healthz", "/vars", "/slo"):
            with urllib.request.urlopen(srv.url + route, timeout=10) as r:
                routes[route] = (r.status, r.read().decode())
        return srv

    monkeypatch.setattr(serve, "_maybe_listen", listen_and_scrape)
    trace, prom, flight = tmp_path / "t.json", tmp_path / "m.prom", tmp_path / "incidents"
    eng = serve.main(SMOKE + [
        "--batch", "5", "--slots", "2", "--prompt-len", "140", "--gen", "6",
        "--prefix-cache", "--shared-prefix", "128", "--temperature", "0.7", "--top-p", "0.9",
        "--deadline", "60", "--slo-target", "0.99", "--monitor", "30",
        "--trace-out", str(trace), "--metrics-out", str(prom), "--flight-dir", str(flight),
        "--listen", "127.0.0.1:0",
    ]).engine
    out = capsys.readouterr().out
    assert "live telemetry at http://127.0.0.1:" in out and "flight recorder: " in out
    assert {k: v[0] for k, v in routes.items()} == dict.fromkeys(routes, 200) and len(routes) == 4
    assert routes["/healthz"][1] == "ok\n"
    rep = validate_trace_file(str(trace))
    s = eng.stats_summary()
    assert rep["slot_tracks"] == 2 and rep["counter_series"] == 3
    spans = [e for e in eng.tracer.events() if e["kind"] == 1]  # span ends
    assert sum(e["name"] == "decode_step" for e in spans) == s["decode_steps"]
    assert sum(e["name"] == "prefill" and e["track"] == "engine:prefill" for e in spans) == s["prefill_calls"]
    got = parse(prom.read_text())
    assert got["repro_serve_requests_finished_total"] == s["requests_finished"] == 5
    assert got["repro_serve_decode_steps_total"] == s["decode_steps"]
    assert got["repro_serve_host_syncs_total"] == s["dispatch_guard"]["host_syncs"]
    assert got["repro_serve_prefix_hit_tokens_total"] == s["prefix_cache"]["hit_tokens"] > 0
    assert s["slo"]["with_deadline"] == 5 and flight.is_dir()
    assert eng.slo_state()["enabled"] and eng.windowed_vars()["enabled"]


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--replicas", "2", "--tp", "2"], ["--production-mesh"],
                                  ["--strategy", "tp"]])
def test_cli_refuses_distribution(flag):
    """Tensor parallelism waits for distribution; ``--replicas`` alone
    serves through the router, tensor-parallel replicas wait too."""
    with pytest.raises(SystemExit, match="Queue 1 item 9"):
        serve.main(SMOKE + flag)


def test_cli_legacy_server_refuses_sampling():
    with pytest.raises(SystemExit, match="plain greedy only"):
        serve.main(SMOKE + ["--legacy-server", "--temperature", "0.5"])


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------


def _items(items):
    return [{**dataclasses.asdict(w), "prompt": w.prompt.tolist(),
             "sampling": None if w.sampling is None else dataclasses.asdict(w.sampling)}
            for w in items]


GENERATORS = {
    "poisson_burst": lambda mod, rng: mod.poisson_burst(
        rng, vocab=128, page=64, n_background=6, n_burst=4, burst_step=5,
        background_gen=40, burst_gen=6, deadline_steps=30),
    "long_tail": lambda mod, rng: mod.long_tail(
        rng, vocab=128, page=64, n=12, mean_gap_steps=2.5, short_gen=(3, 9), heavy_gen=50,
        heavy_frac=0.3, deadline_steps=40),
    "chat_turns": lambda mod, rng: mod.chat_turns(
        rng, vocab=128, n_users=3, n_turns=3, user_tokens=20, gen=5),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("seed", [0, 7])
def test_workload_generators_equal_reference(name, seed):
    want = GENERATORS[name](jworkloads, np.random.default_rng(seed))
    got = GENERATORS[name](workloads, np.random.default_rng(seed))
    if name == "chat_turns":
        assert [[(p.tolist(), g) for p, g in conv] for conv in got] == \
            [[(p.tolist(), g) for p, g in conv] for conv in want]
    else:
        assert _items(got) == _items(want)


def test_goodput_equals_reference():
    rng = np.random.default_rng(4)
    stats = {
        "preemption": {"preemptions": 2, "resumes": 2, "out_bytes": 4096, "in_bytes": 2048},
        "p50_token_latency_ms": 3.5, "p99_token_latency_ms": 9.25, "rejected": {"total": 1},
    }

    def finished(mod):
        out = []
        for i in range(9):
            deadline = [None, 0.5, 2.0][i % 3]
            out.append(mod.FinishedRequest(
                uid=i, prompt=np.arange(4, dtype=np.int32), tokens=np.arange(i % 4, dtype=np.int32),
                finish_reason="rejected" if i == 8 else "length",
                reject_reason=mod.REJECT_TIMEOUT if i == 8 else None,
                admit_step=-1 if i == 8 else i, finish_step=i + 3,
                ttft_s=None if i == 8 else float(rng_vals[i]), e2e_s=float(rng_vals[i] * 3),
                schedule=mod.ScheduleParams(deadline_s=deadline),
            ))
        return out

    rng_vals = rng.uniform(0.01, 1.0, 9)
    want = jworkloads.goodput(finished(jrequest), stats)
    got = workloads.goodput(finished(request), stats)
    assert got == want
    assert 0 < got["slo_met"] < got["with_deadline"]


def test_replay_drives_the_port_engine():
    """``replay`` of a poisson burst through the port's engine: every item
    finishes, the burst preempts the background, and ``goodput`` folds
    the run (deadlines unarmed with ``step_s=None``)."""
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = registry.get_smoke("qwen3-1.7b", num_layers=1, vocab_size=128)
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=4 * 64, preempt_min_steps=2),
                 device="cpu")
    items = workloads.poisson_burst(
        np.random.default_rng(1), vocab=128, page=64, n_background=2, n_burst=2, burst_step=5,
        background_gen=16, burst_gen=4, deadline_steps=30,
    )
    items[0] = dataclasses.replace(items[0], sampling=SamplingParams(temperature=0.7, seed=3))
    fins, wall, steps = workloads.replay(eng, items, step_s=None)
    assert len(fins) == len(items) and wall > 0 and steps > 0
    g = workloads.goodput(fins, eng.stats_summary())
    assert g["requests"] == len(items) and g["with_deadline"] == 0 and g["slo_attainment"] == 1.0
    assert g["preemptions"] >= 1 and g["resumes"] == g["preemptions"]
