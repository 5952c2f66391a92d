"""Mesh-serving benchmark of the port, the twin of the JAX package's
``benchmarks/serve_mesh.py``: tensor-parallel decode throughput per tp,
and data-parallel replica routing.

For each tp in {1, 2, 4, 8} that ``sharding.check_tp`` takes in serving, one engine
on a ``(1, tp)`` mesh (``launch.mesh.make_tp_mesh``: the weights and the
paged KV pools in ``tp`` shards) serves the same uniform trace, greedy and
seeded-sampled; both streams must equal the tp = 1 engine's
(``streams_equal``), and the best of the greedy repeats (by decode tok/s)
gives ``decode_tok_s``, ``wall_tok_s``, ``wall_s`` and
``p95_token_latency_ms``. The other tp values are listed under
``refused`` with ``check_tp``'s words, which name the ROADMAP item that
would shard them (none for qwen3-1.7b: where tp does not divide its kv
heads, the engine serves in the sequence-parallel mode). A 2-replica
``ReplicaRouter`` run
rides along, its streams held to the same oracle.

By default the mesh is the card ``tp`` times: all shards share one H100's
SMs, and the one host process launches each shard's kernels in turn. So
the rows measure what sharding costs, not a speedup; ``distinct_devices``
says how many devices held each run. The JAX script's simulated CPU
devices share one host in the same way. With ``--device cpu`` every shard
runs the plain versions on the CPU.

Sizes: ``--smoke`` is the JAX script's (smoke qwen3-1.7b, 2 layers, a
256-token vocabulary; 2 requests of 8 tokens, 4 new, one repeat: tp 1
and 2 by heads, 4 and 8 by sequence, its 2 kv heads). The default is full-width sparse qwen3-1.7b (28
layers, d 2048, 8 kv heads: tp 1, 2, 4 and 8) in bf16, random weights
from seed 0, at the JAX script's non-smoke trace (4 requests of 32
tokens, 16 new, 2 repeats). It runs in the calling process. The last line
of stdout is the JSON payload, with the JAX payload's keys and
``distinct_devices`` and ``refused``.

  PYTHONPATH=src python -m repro_torch.bench.serve_mesh [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.distributed.sharding import check_tp
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.sampling import SamplingParams

__all__ = ["run", "main", "ARCH", "TPS"]

ARCH = "qwen3-1.7b"
TPS = (1, 2, 4, 8)


def _log(msg: str) -> None:
    print(f"serve_mesh: {msg}", file=sys.stderr, flush=True)


def _serve(eng, prompts, gen: int, sampled: bool) -> dict[int, list[int]]:
    for i, p in enumerate(prompts):
        sp = SamplingParams(temperature=0.8, top_k=40, seed=100 + i) if sampled else None
        eng.submit(p, gen, sampling=sp)
    fins = eng.drain()
    # uid counters run across serves; key by submit order so streams from
    # different engines and passes compare directly
    ordered = sorted(fins, key=lambda f: f.uid)
    return {i: f.tokens.tolist() for i, f in enumerate(ordered)}


def _measure_tp(tp: int, cfg, params, device, prompts, gen: int, repeats: int):
    """One engine on a (1, tp) mesh of ``device``: serve the trace greedy
    and sampled (the first passes also warm up), then time the greedy
    repeats and keep the best decode tok/s."""
    eng = Engine(
        cfg,
        engine_cfg=EngineConfig(max_slots=len(prompts), max_len=len(prompts[0]) + gen + 1),
        mesh=make_tp_mesh(tp, [device] * tp),
        params=params,
    )
    greedy = _serve(eng, prompts, gen, sampled=False)
    sampled = _serve(eng, prompts, gen, sampled=True)
    best = None
    for _ in range(repeats):
        eng.reset_stats()
        t0 = time.perf_counter()
        fins = _serve(eng, prompts, gen, sampled=False)
        wall = time.perf_counter() - t0
        out = eng.stats_summary()
        out["wall_tok_s"] = sum(len(t) for t in fins.values()) / wall
        out["wall_s"] = wall
        if best is None or out["decode_tok_s"] > best["decode_tok_s"]:
            best = out
    row = {
        "devices": tp,
        "distinct_devices": eng.distinct_devices,
        "paged_impl": eng.paged_impl,
        "decode_tok_s": best["decode_tok_s"],
        "wall_tok_s": best["wall_tok_s"],
        "wall_s": best["wall_s"],
        "p95_token_latency_ms": best["p95_token_latency_ms"],
    }
    return row, greedy, sampled


def _measure_router(cfg, params, device, prompts, gen: int, oracle: dict) -> dict:
    """2-replica data-parallel routing (tp = 1 a replica): router uids
    follow submit order, so the streams must equal the single engine's."""
    router = ReplicaRouter(
        cfg,
        replicas=2,
        tp=1,
        engine_cfg=EngineConfig(max_slots=len(prompts), max_len=len(prompts[0]) + gen + 1),
        params=params,
        devices=[device] * 2,
    )
    _serve(router, prompts, gen, sampled=True)  # warm both replicas
    t0 = time.perf_counter()
    streams = _serve(router, prompts, gen, sampled=True)
    wall = time.perf_counter() - t0
    equal = streams == oracle
    assert equal, "replica routing changed token streams"
    return {
        "replicas": 2,
        "tp": 1,
        "wall_s": wall,
        "wall_tok_s": sum(len(t) for t in streams.values()) / wall,
        "streams_equal": equal,
        "per_replica_finished": [int(e.stats.finished) for e in router.engines],
    }


def run(
    smoke: bool = False,
    device: str | torch.device | None = None,
    params: dict[str, torch.Tensor] | None = None,
    tps: tuple[int, ...] = TPS,
) -> dict:
    """The payload (also printed as the last line of stdout). ``params``:
    the model's state dict (random from seed 0 when None); ``tps``: the tp
    values to try (those ``sharding.check_tp`` refuses are listed under
    ``refused``)."""
    dev = T.resolve_device(device)
    cfg = registry.get_smoke(ARCH, sparse=True) if smoke else registry.get(ARCH, sparse=True)
    batch, prompt_len, gen, repeats = 4, 32, 16, 2
    if smoke:
        cfg = cfg.replace(num_layers=2, vocab_size=256)
        batch, prompt_len, gen, repeats = 2, 8, 4, 1
    refused = {}
    for t in tps:
        try:
            check_tp(cfg, t)
        except ValueError as e:
            refused[str(t)] = str(e)
    run_tps = [t for t in tps if str(t) not in refused]
    if params is None:
        params = T.init_model(cfg, seed=0, device=dev).state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32) for _ in range(batch)]

    by_tp, oracle_g, oracle_s = {}, None, None
    equal = True
    for tp in run_tps:
        _log(f"tp={tp} on {dev} (smoke={smoke})")
        row, greedy, sampled = _measure_tp(tp, cfg, params, dev, prompts, gen, repeats)
        if tp == run_tps[0]:
            oracle_g, oracle_s = greedy, sampled
        else:
            ok = greedy == oracle_g and sampled == oracle_s
            equal = equal and ok
            assert ok, f"tp={tp} streams diverged from the tp={run_tps[0]} engine's"
        by_tp[str(tp)] = row
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    _log("router replicas=2")
    router = _measure_router(cfg, params, dev, prompts, gen, oracle_s)

    payload = {
        "smoke": smoke,
        "devices": max(run_tps),
        "distinct_devices": max(r["distinct_devices"] for r in by_tp.values()),
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "batch": batch,
        "prompt_len": prompt_len,
        "gen": gen,
        "streams_equal": equal,
        "by_tp": by_tp,
        "refused": refused,
        "router": router,
    }
    print(json.dumps(payload), flush=True)
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the port's mesh-serving benchmark (twin of benchmarks/serve_mesh.py)")
    ap.add_argument("--smoke", action="store_true", help="the JAX script's smoke config and sizes")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    return run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
