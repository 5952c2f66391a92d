"""Serving launcher of the port: a thin CLI over the continuous-batching
engine, on one device (the card by default), the counterpart of the JAX
package's ``launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --sparse \\
      --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --sparse \\
      --batch 24 --slots 8 --prompt-len 512 --gen 64 --trace-out build/serve.trace.json

Requests flow through ``repro_torch.serving.Engine``: batched bucketed
prefill straight into the block-paged KV cache, one decode step per token
over all slots, admission and eviction every step. On the card the
kernels are the hand-written CUDA ones; on the CPU (``--device cpu``) the
plain PyTorch versions. Nothing falls back from one to the other.

``Server`` below is the fixed-batch reference path over a contiguous
cache. For attention families it prefills token by token through the
decode step and is kept as the numerics oracle for the engine
(``--legacy-server``). It is also the serving path of the SSM and hybrid
families (mamba2-130m, zamba2-2.7b), whose state is a row of each slot and
not pages, greedy only, as in the JAX package; for them it prefills the
prompts in one ``transformer.prefill`` pass:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --sparse

``--replicas N`` serves through ``serving.router.ReplicaRouter``: N
complete engines (on one card they share the weights) behind a
least-loaded router, one fleet summary and one scrape endpoint.

``--tp N --strategy tp`` serves tensor-parallel: the engine holds N shards
of the model and of the KV pools on a ``(1, N)`` mesh (``launch.mesh``),
by default the card N times; with ``--legacy-server``, and for the SSM and
hybrid families, the ``Server`` holds the N shards on that mesh, the SSM
mixer and its state by heads. On one card that measures what sharding
costs, not a speedup: the shards share the card's SMs and the host
launches each shard's kernels in turn. ``--tp`` composes with
``--replicas`` (``replicas * tp`` devices). ``--production-mesh`` builds
the JAX package's 16 x 16 mesh and exits when the machine has fewer
devices, as the JAX launcher fails on too few devices.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh, make_tp_mesh
from repro_torch.models import transformer as T
from repro_torch.obs import SloConfig
from repro_torch.obs.http import attach
from repro_torch.obs.prom import write_snapshot
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import ScheduleParams
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.sampling import SamplingParams
from repro_torch.training.loop import MeshState

__all__ = ["Server", "Served", "main"]


class Server:
    """Fixed-batch LM server (reference): prefill once, then step the
    decode cache. ``params`` is a state dict (``bridge.params_from_jax``
    or a model's ``state_dict()``); without it the weights are random from
    ``seed``.

    With ``mesh`` (``launch.mesh``; its devices say where the shards go, so
    ``device`` must then be None) the server holds a
    ``training.loop.MeshState``: the weights cut by the JAX rules under
    ``strategy`` ("fsdp", the JAX ``Server``'s default, or "tp"), and
    ``transformer.prefill`` and ``decode_step`` run on it, each data
    replica on its rows and, under tp, each model shard on its heads, its
    SSM heads and its slices (``sharding.check_tp`` refuses the rest). The
    logits are gathered onto the first position's device."""

    def __init__(self, cfg, *, mesh=None, strategy: str = "fsdp", seed: int = 0, params=None, device=None):
        self.cfg, self.mesh = cfg, mesh
        if mesh is None:
            self.device = T.resolve_device(device)
            self.model = T.init_model(cfg, seed=seed, device=self.device, params=params)
            return
        if device is not None:
            raise ValueError("a mesh Server takes its devices from the mesh; pass device=None")
        sharding.check_tp(cfg, sharding.Strategy(mesh, strategy).tp_size)
        self.device = torch.device(mesh.devices.flat[0])
        if params is None:
            params = T.init_model(cfg, seed=seed, device=self.device).state_dict()
        self.model = MeshState(cfg, mesh, strategy, params, copy=False)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, gen_len: int) -> np.ndarray:
        """prompts (B, P) int -> (B, gen_len) int32, greedy over the
        vocabulary (the padded logits past ``vocab_size`` are never
        chosen). An SSM or hybrid config prefills in one
        ``transformer.prefill`` pass (block-sparse attention and every
        linear at M = B x P); any other goes through the decode step one
        token at a time, as the JAX package's ``Server`` does. The tokens
        stay on the device until the one fetch at the end."""
        cfg, model = self.cfg, self.model
        b, plen = prompts.shape
        max_len = plen + gen_len + 1
        toks = torch.as_tensor(np.asarray(prompts, np.int32), device=self.device)
        if cfg.has_ssm:
            logits, caches = T.prefill(cfg, model, {"tokens": toks}, max_len=max_len)
        else:
            if self.mesh is None:
                caches = T.init_cache(cfg, b, max_len, device=self.device)
            else:
                caches = T.init_mesh_cache(cfg, model, b, max_len)
            for i in range(plen):
                logits, caches = T.decode_step(cfg, model, caches, toks[:, i], i)
        out = []
        tok = torch.argmax(logits[:, : cfg.vocab_size], dim=-1)
        for j in range(gen_len):
            out.append(tok)
            logits, caches = T.decode_step(cfg, model, caches, tok, plen + j)
            tok = torch.argmax(logits[:, : cfg.vocab_size], dim=-1)
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


@dataclasses.dataclass
class Served:
    """What ``main`` served: each request's tokens in submission order,
    the drained engine (None for ``--legacy-server``; the
    ``ReplicaRouter`` with ``--replicas``) and the wall seconds of the
    drain (of ``generate`` for the Server)."""

    tokens: list[np.ndarray]
    engine: Engine | ReplicaRouter | None
    wall_s: float


def _write_obs(served, metrics, args) -> None:
    """Flush observability artifacts after the drain: a Perfetto timeline
    (``--trace-out``) and a Prometheus snapshot (``--metrics-out``).
    ``served`` is the Engine or the ReplicaRouter, ``metrics`` its
    registry (the router's merged one)."""
    if args.trace_out:
        n = served.export_perfetto(args.trace_out)
        print(f"wrote {n} trace events to {args.trace_out} (open at ui.perfetto.dev)")
    if args.metrics_out:
        write_snapshot(args.metrics_out, metrics)
        print(f"wrote Prometheus snapshot to {args.metrics_out}")


def _maybe_listen(served, args):
    """Start the live scrape endpoint (``--listen``) over the Engine or
    the ReplicaRouter before draining; returns the running
    ``MetricsServer`` or None."""
    if not args.listen:
        return None
    server = attach(served, args.listen)
    print(f"live telemetry at {server.url} (/metrics /healthz /vars /slo)", flush=True)
    return server


def _shutdown_live(server, engines: list[Engine], args) -> None:
    """Stop the ``--listen`` endpoint and report the flight recorder's
    incident bundles of every engine, by kind."""
    if server is not None:
        server.stop()
    if args.flight_dir:
        kinds: dict[str, int] = {}
        for engine in engines:
            for kind, n in incident_kinds(engine).items():
                kinds[kind] = kinds.get(kind, 0) + n
        print(f"flight recorder: {sum(kinds.values())} incident bundle(s) under "
              f"{args.flight_dir} {kinds}")


def incident_kinds(engine: Engine) -> dict[str, int]:
    """Flight-recorder bundles written since the last ``reset_stats``, by
    kind."""
    return dict(engine.metrics["repro_flight_incidents_total"].items())


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="serve a decoder LM of the port")
    ap.add_argument("--arch", choices=registry.ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sparse", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="number of requests to submit")
    ap.add_argument("--slots", type=int, default=0,
                    help="engine cache slots (default: --batch)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-slot KV capacity (default: fits prompt+gen)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--lookahead", type=int, default=0,
                    help="admission lookahead window K (default: 2*slots)")
    ap.add_argument("--max-prefill-batch", type=int, default=0,
                    help="cap requests per prefill call (default: slots; 1 = "
                         "per-request admission)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy, the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = disabled)")
    ap.add_argument("--repetition-penalty", type=float, default=1.0,
                    help="penalty on already-seen tokens (1.0 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed; request b uses seed+b")
    ap.add_argument("--sampler-candidates", type=int, default=64,
                    help="the sampler's top-C candidate cap (0 = the whole "
                         "vocabulary; top-k must fit under it)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prompt-prefix reuse: admission maps cached "
                         "prefix pages into the new slot and prefills only the "
                         "uncached suffix")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="first N tokens of every synthetic prompt are a common "
                         "system prompt (0 = independent prompts)")
    ap.add_argument("--priority", type=int, default=0,
                    help="scheduling priority of the submitted batch")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="soft end-to-end deadline in seconds (0 = none); "
                         "reported as SLO attainment")
    ap.add_argument("--max-queue-wait", type=float, default=0.0,
                    help="structured rejection if not admitted within this many "
                         "seconds (0 = wait forever)")
    ap.add_argument("--no-preemption", action="store_true",
                    help="disable priority preemption (host-memory page swap)")
    ap.add_argument("--preempt-min-steps", type=int, default=4,
                    help="steps a sequence runs after admit/resume before it "
                         "can be preempted")
    ap.add_argument("--max-skips", type=int, default=64,
                    help="after this many passes of being admitted around, a "
                         "waiting request blocks later admissions (0 disables)")
    ap.add_argument("--strategy", choices=["tp", "fsdp"], default="fsdp",
                    help="parameter layout; 'tp' shards over the model axis (needed for --tp > 1)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard the weights and the paged KV pools "
                         "over a (1, tp) mesh, by default the card tp times")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel replicas: N complete engines on disjoint (1, tp) "
                         "meshes behind a least-loaded router (serving.router)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the JAX package's 16 x 16 production mesh (exits on fewer devices)")
    ap.add_argument("--legacy-server", action="store_true",
                    help="use the fixed-batch reference Server instead")
    ap.add_argument("--trace", action="store_true",
                    help="enable span tracing without writing a file")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event / Perfetto JSON timeline "
                         "after draining (implies --trace)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus text snapshot of the serving "
                         "metrics after draining")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve live /metrics /healthz /vars /slo over HTTP "
                         "while running (port 0 = ephemeral; implies --monitor 30)")
    ap.add_argument("--monitor", type=float, default=0.0, metavar="SECS",
                    help="rolling live-telemetry window in seconds (0 = off)")
    ap.add_argument("--slo-target", type=float, default=0.0,
                    help="SLO attainment objective, e.g. 0.99 (0 = burn-rate "
                         "monitor off)")
    ap.add_argument("--slo-fast-window", type=float, default=60.0,
                    help="fast burn-rate window in seconds")
    ap.add_argument("--slo-slow-window", type=float, default=300.0,
                    help="slow burn-rate window in seconds")
    ap.add_argument("--slo-shed", action="store_true",
                    help="shed lowest-priority queued requests while the "
                         "burn-rate state is CRITICAL")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="write incident bundles (trace + metrics + config) "
                         "under DIR on step-time spikes, kernel-library builds "
                         "after warm-up and SLO CRITICAL transitions")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the plain versions")
    return ap


def main(argv=None) -> Served:
    """Parse ``argv`` and serve ``--batch`` synthetic requests."""
    args = _parser().parse_args(argv)
    if args.tp > 1 and args.strategy != "tp":
        raise SystemExit("--tp > 1 shards over the model axis: pass --strategy tp")
    if args.production_mesh:
        mesh = make_production_mesh()
        have = torch.cuda.device_count() if args.device is None else 1
        raise SystemExit(
            f"--production-mesh: the {mesh.shape} mesh needs {mesh.size} devices, this machine "
            f"has {have}"
        )
    cfg = (
        registry.get_smoke(args.arch, sparse=args.sparse)
        if args.smoke
        else registry.get(args.arch, sparse=args.sparse)
    )
    if not cfg.embed_inputs:
        raise SystemExit(
            f"{args.arch} has a stub modality frontend; serve the backbone "
            "via the dry-run (decode_32k) instead"
        )
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len), dtype=np.int32)
    if args.shared_prefix:
        n = min(args.shared_prefix, args.prompt_len)
        prompts[:, :n] = prompts[0, :n]  # one system prompt for everyone
    # the paged cache covers attention families; SSM and hybrid state is
    # slot-indexed, not paged: those are served by the reference Server
    has_ssm = cfg.has_ssm
    if has_ssm and not args.legacy_server:
        print(f"{args.arch} has SSM layers: using the fixed-batch Server "
              "(paged engine covers attention families)")
    sp0 = SamplingParams(
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        seed=args.seed,
    )
    if args.legacy_server or has_ssm:
        if not sp0.is_plain:
            raise SystemExit(
                f"sampler '{sp0.kind}' needs the paged engine; the reference "
                "Server path is plain greedy only"
            )
        if args.tp > 1:
            devices = None if args.device is None else [args.device] * args.tp
            server = Server(cfg, mesh=make_tp_mesh(args.tp, devices), strategy=args.strategy)
        else:
            server = Server(cfg, device=args.device)
        t0 = time.perf_counter()
        out = server.generate(prompts, args.gen)
        dt = time.perf_counter() - t0
        print(f"generated {out.shape} tokens in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s), tp {args.tp}")
        print(out[:2])
        return Served(list(out), None, dt)

    slo = None
    if args.slo_target:
        slo = SloConfig(
            target=args.slo_target,
            fast_window_s=args.slo_fast_window,
            slow_window_s=args.slo_slow_window,
            shed=args.slo_shed,
        )
    # --listen without an explicit window still needs the live window
    # behind /vars; the SLO monitor sizes its own window when set
    monitor = args.monitor if args.monitor else bool(args.listen)
    ecfg = EngineConfig(
        max_slots=args.slots or args.batch,
        max_len=args.max_len or (args.prompt_len + args.gen + 1),
        lookahead=args.lookahead or None,
        max_prefill_batch=args.max_prefill_batch,
        sampler_candidates=args.sampler_candidates,
        max_skips=args.max_skips,
        prefix_cache=args.prefix_cache,
        preemption=not args.no_preemption,
        preempt_min_steps=args.preempt_min_steps,
        trace=bool(args.trace or args.trace_out),
        monitor=monitor,
        slo=slo,
        flight_dir=args.flight_dir,
    )
    schedule = ScheduleParams(
        priority=args.priority,
        deadline_s=args.deadline or None,
        max_queue_wait_s=args.max_queue_wait or None,
    )
    devices = None if args.device is None else [args.device] * (args.replicas * args.tp)
    if args.replicas > 1:
        served = ReplicaRouter(cfg, replicas=args.replicas, tp=args.tp, engine_cfg=ecfg, devices=devices)
        engines = served.engines
    else:
        mesh = make_tp_mesh(args.tp, devices) if args.tp > 1 else None
        served = Engine(cfg, engine_cfg=ecfg, device=None if mesh else args.device, mesh=mesh)
        engines = [served]
    impl = ("CUDA kernel (csrc/paged_attention.cu)" if engines[0].paged_impl == "cuda"
            else "plain PyTorch gather (CPU)")
    distinct = len({str(d) for e in engines for d in (e.mesh.model_devices() if e.mesh else [e.device])})
    print(f"device: {engines[0].device}, paged decode: {impl}, sampler: {sp0.kind}"
          + (f", {args.replicas} replicas" if args.replicas > 1 else "")
          + f", tp {args.tp} on {distinct} distinct device(s)")
    for b in range(args.batch):
        # each request gets its own noise stream through a distinct seed
        served.submit(
            prompts[b],
            args.gen,
            sampling=dataclasses.replace(sp0, seed=args.seed + b),
            schedule=schedule,
        )
    server = _maybe_listen(served, args)
    t0 = time.perf_counter()
    finished = served.drain()
    dt = time.perf_counter() - t0
    s = served.stats_summary()
    total = sum(len(f.tokens) for f in finished)
    print(
        f"served {len(finished)} requests / {total} tokens in {dt:.2f}s "
        f"({total / dt:.1f} tok/s end-to-end, "
        f"{s['decode_tok_s']:.1f} tok/s decode, "
        f"p50 {s['p50_token_latency_ms']:.1f}ms "
        f"p95 {s['p95_token_latency_ms']:.1f}ms, "
        f"occupancy {s['mean_occupancy']:.2f}, "
        f"{s['mean_prefill_batch']:.1f} req/prefill)"
    )
    if args.replicas > 1:
        per = [int(rep["requests_finished"]) for rep in s["per_replica"]]
        print(f"per-replica finished: {per}")
    pre = s["preemption"]
    if pre["preemptions"] or s["rejected"]["total"] or args.deadline:
        print(
            f"scheduling: {pre['preemptions']} preemptions "
            f"({pre['out_bytes']} bytes swapped out, {pre['in_bytes']} restored), "
            f"{s['rejected']['total']} rejected, "
            f"SLO attainment {s['slo']['attainment']:.0%} "
            f"({s['slo']['met']}/{s['slo']['with_deadline']}), "
            f"ttft p95 {s['ttft_ms']['p95_ms']:.1f}ms"
        )
    if args.prefix_cache:
        pc = s["prefix_cache"]
        print(
            f"prefix cache: {pc['hit_rate']:.0%} hit rate "
            f"({pc['hit_tokens']}/{pc['prompt_tokens']} prompt tokens, "
            f"{pc['hit_pages']} shared pages, "
            f"{pc['inserted_pages']} indexed, {pc['evicted_pages']} "
            f"evicted, {pc['cow_copies']} COW)"
        )
    _write_obs(served, served.merged_metrics() if args.replicas > 1 else served.metrics, args)
    _shutdown_live(server, engines, args)
    tokens = [f.tokens for f in sorted(finished, key=lambda f: f.uid)]
    print(np.stack(tokens[:2]))
    return Served(tokens, served, dt)


if __name__ == "__main__":
    main()
