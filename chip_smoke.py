#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--out build/chip_smoke.json]

Phases; any failure raises and the script exits non-zero:

1. Device line: ``nvidia-smi`` name and power limit, the CUDA device name
   and count; TF32 off for matmuls and cuDNN.
2. Build: every kernel of ``src/repro_torch/csrc`` with nvcc (in parallel),
   with the compiler's register/spill report.
3. Each kernel against its plain PyTorch version on the same CUDA tensors:
   at the main path's shapes in bfloat16, and at small shapes in float32,
   with the reference tolerances (``assert_allclose`` style, rtol = atol).
   ``paged_decode_attention`` has two more bf16 rows at the main shape:
   every scheduled page visible, and the dense schedule (w = 16); its main
   row must be faster than SDPA on the same inputs.
   Per kernel: the kernel's time (CUDA events, L2 flushed before every
   launch, as the decode loop finds weights cold, all launches queued
   behind a device sleep so host time is not counted), the plain version's and
   one PyTorch library call's for the same function, the host time of one
   call (wrapper and launch, not waited on), and the bound: the
   larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s (bf16) or
   67 TFLOP/s (fp32), H100 SXM data-sheet peaks.
4. Smoke-width parity: the fp32 smoke model, same seeded weights, served
   on the CPU (plain versions) and on the card (kernels): equal greedy
   streams, with a max_len whose sparse decode schedule skips pages; then
   equal streams for three more workloads: a sampled mix (temperature
   0.8, top_k 40, top_p 0.95, repetition penalty 1.1, per-request seeds,
   beside temperature-0 rows), a shared-prefix mix with the prefix cache
   on, and a full pool that a priority-1 request preempts.
5. Full width: ``Engine(registry.get("qwen3-1.7b", sparse=True))`` with
   ``EngineConfig(max_slots=8, max_len=2048)`` serves 12 requests (prompt
   lengths 200-1000 from --seed, 32 new tokens each) with every kernel's
   launch count reset just before; each kernel must have launched. Then
   two profiled windows (device busy share, top kernels, the port's
   kernels by name): 4 decode steps with 8 slots busy, and one prefill
   call of 4 prompts of 1024 tokens.
6. Full width with the prefix cache on, on phase 5's weights (passed as
   its state dict, not drawn again): 8 requests sharing a 1024-token
   system prompt with 64-256-token suffixes and 8 unrelated 200-1000-token
   prompts, half sampled, 48 new tokens each, and 2 priority-1 requests
   submitted after step 6 with all 8 slots busy, with every kernel's
   launch count reset just before. Every request must finish, >= 7
   admissions must hit the cache and prefill only their suffixes, a
   preemption and a resume must happen, and every kernel must launch.
   Prints decode tok/s, step p50, TTFT p50 of hits and misses, the swap
   traffic, and the device time of the sampler (4 sampled decode steps)
   and of the partial-prefill attention (one partial prefill call) from
   profiled windows and from CUDA events.
7. Training. (a) ``BsrMatmul`` (the kernel forward, the kernel dX on the
   transposed pattern, the batched dBlocks) against autograd of
   ``ref.bsr_matmul_gather`` at M = 8192 for q, gate and down, fp32 and
   bf16, and ``BlockSparseAttention`` (kernel forward, the JAX package's
   gradient backward) against autograd of ``ref.sparse_attention`` at
   B = 1, S = 2048, H = 16, Hk = 8, D = 128; phase 3's tolerances, the
   gradients relative to their largest entry; then the bf16 times of dX
   beside its bound, its plain version and ``dy @ W_dense^T``, of the
   dBlocks contraction, and of attention forward and backward at B = 4.
   (b) One fp32 smoke-width train step, seed 0, on the CPU and the card:
   loss, grad_norm and parameters agree. (c) Full-width sparse qwen3-1.7b
   through ``Trainer`` at B = 4, S = 2048: a warm-up step and 3 timed
   steps (step ms, train tokens/s, peak memory, launch counts; finite loss
   and grad norm; both training kernels launched), then one profiled step
   (top kernels, the step's ranges, launches in forward vs backward) and
   one step traced on the device only (its busy share). (d) A smoke-width checkpoint round trip on the card.
8. The rest of the dense family. (a) The three kernels at the shapes of
   smollm-360m (GQA group 3, head dim 64, linears at block 64) and
   qwen2-1.5b (group 6, head dim 128) against their plain versions, timed
   as in phase 3, with bsr_matmul's dX on the transposed patterns; the
   G in {1, 2, 4} attention outputs at phase 3's main shape (digests, and
   equal bit for bit to the one-head-a-block launch); the dense baseline's
   attention (PyTorch's flash kernel, no TPU kernel) against the chunked
   plain version at qwen3-1.7b's training shape. (b) fp32 sparse smoke
   models of both: equal greedy streams on the CPU and the card, and one
   qwen2-1.5b train step held as in 7b. (c) Each at full width, sparse,
   at cut depth (``DEPTH_CUTS``: 16 of 32 and 14 of 28 layers):
   ``Engine(max_slots=8, max_len=2048)`` serves 8 requests of 200-1000
   prompt tokens, 32 new each, then a ``Trainer`` takes 1 warm-up and 2
   timed steps at B = 4, S = 2048, the kernels' counts set to 0 just
   before each and read just after. (d) ``repro_torch.bench.lm_speedup``:
   dense against pixelfly training for qwen3-1.7b (B = 4) and smollm-360m
   (B = 8) at S = 2048: step times, speedup, parameter ratio, each arm's
   device busy share and top device kernels.
9. The serve CLI and observability. (a) ``repro_torch.launch.serve.main``
   serves full-width sparse qwen3-1.7b: 24 requests of 512 tokens (a
   256-token shared prefix), 64 new each, temperature 0.7, top-p 0.9,
   8 slots, the prefix cache, a 60 s deadline, SLO target 0.99, a 30 s
   window, with the trace, the Prometheus snapshot and the flight
   recorder written under ``build/chip_smoke_serve`` and ``--listen
   127.0.0.1:0`` scraped on all four routes by a thread while it drains,
   the kernels' counts set to 0 just before. Checks: every route answered
   200, the trace validates and holds one decode_step and one prefill
   span per decode step and prefill call, the snapshot agrees with
   ``stats_summary()``, the allocator's bytes in use cover the parameters
   and the KV pool, every kernel launched. (b) ``--legacy-server``: at
   smoke width its grid equals the engine's; at full width (8 x 128, 16
   new) ``bsr_matmul`` launches and the share of tokens equal to the
   engine's is reported. (c) What observability costs: a bare and a
   fully observed full-width engine on one state dict serve the same 8
   greedy requests in turns off, on, on, off (decode-step p50, host us a
   ``_observe_step``, tracer ns an event, host_sync's share of a decode
   step from the trace). (d) A ``workloads.poisson_burst`` replay through
   the observed engine: goodput and the SLO state after each step.
10. Vision and the paper's other benchmarks. (a) ``bsr_matmul`` at
   b = 32 (ViT-B/16's qkv, proj, fc1, fc2), 16 (the ablation example's
   linears) and 8 (ViT-B/16's MLP at block 8), fp32 and bf16, forward and
   dX on the transposed pattern, at M in {1, 8, 16, 17} and the path's M
   (128 x 197, or 8 x 64), against the plain version with phase 3's
   tolerances; timed at M = 8 and the path's M beside the bound, the plain
   version and ``x @ bsr_to_dense``. (b) ViT and Mixer at the JAX script's
   bench width, sparse fp32: logits, every gradient and one SGD step on
   the card equal the CPU's (logits 1e-4, gradients 1e-4 of each leaf's
   largest entry, loss 1e-5, parameters 1e-6). (c) ``repro_torch.bench.vision_speedup``
   at the B/16 widths, bf16, B = 128, dense and pixelfly, ViT and Mixer
   (2 warm-up, 3 timed, 1 traced step each; finite losses; 2 bsr_matmul
   launches a step per sparse linear), the counts set to 0 just before.
   (d) flat vs product, the block microbenchmark, LRA attention and the
   NTK distances at their defaults. (e) ``repro_torch.examples.
   sparsity_ablation --smoke`` (the Trainer at linear block 16), the
   counts set to 0 just before.
11. The vlm and audio backbones, qwen2-vl-7b (M-RoPE, QKV bias, G = 7,
   linears 28 and 148 blocks wide) and musicgen-large (multi-head, head
   dim 64, 48 layers). (a) The three kernels at their shapes against the
   plain versions, timed as in phase 8a. (b) fp32 sparse smoke models:
   equal greedy streams on the CPU and the card, ``forward_train`` on
   embeddings and distinct position streams (loss and gradients), and one
   train step. (c), (d) Each at full width, sparse, as in phase 8c (at
   cut depth: 7 of 28 and 12 of 48 layers), the
   Trainer on ``EmbedsWrapper`` batches (B = 4; B = 2 only if B = 4 runs
   out of memory or peaks above 72 GB), and one more step traced on the
   device (busy share). (e) ``repro_torch.bench.serve_engine`` at full
   width, three repeats. (f) ``repro_torch.examples.serve_lm`` on the card.
   The kernels' counts are set to 0 just before each of (c)-(f) and read
   just after.
12. The MoE, SSM and hybrid families. (a) The three kernels at the new
   shapes against their plain versions, timed as in phase 8a:
   bsr_matmul forward (M = 8 and 4 x 2048) and dX for every linear shape
   of deepseek-moe-16b (q/k/v/o, the dense layer's gate/up and down at
   block 64, the shared experts), zamba2-2.7b (attention, MLP, the SSM's
   out_proj) and mamba2-130m (out_proj); bf16 attention at deepseek-moe
   (H = Hk = 16, D = 128) and zamba2 (H = Hk = 32, D = 80), B = 1 and 4,
   S = 2048, beside SDPA; the paged read at deepseek-moe's heads; head dim
   80 in fp32 and ``BlockSparseAttention``'s gradients at D = 80. (b)
   fp32 sparse smoke models of deepseek-moe-16b, kimi-k2-1t-a32b,
   mamba2-130m and zamba2-2.7b: equal greedy streams on the CPU and the
   card (the engine for the MoE two, the ``Server`` for the SSM two) and
   one train step each, held as in 7b. (c) deepseek-moe-16b at full
   width, sparse: the engine serves as in 8c, then the Trainer steps as in
   8c, one step traced on the device only and one profiled (the MoE
   dispatch, expert products and combine by range). (d) zamba2-2.7b and
   mamba2-130m at full width, sparse: the ``Server`` greedily serves 8
   prompts of 1024 tokens (one prefill pass), 32 new each, then the same
   Trainer steps, traced and profiled steps (the SSD scan by range). The
   kernels' counts are set to 0 just before each of (c) and (d) and read
   just after: all three launch in deepseek-moe's serving,
   block_sparse_attention and bsr_matmul in zamba2's serving and
   training, bsr_matmul in mamba2's. kimi-k2 (344 GB sparse) does not
   fit the card: the CPU tests cover it. The three run at the depth of
   ``DEPTH_CUTS``, published widths.
13. The analysis instruments, the router and the tools, on full-width
   sparse qwen3-1.7b. (a) ``Engine(max_slots=8, max_len=2048)`` admits 8
   greedy requests; its next 16 decode steps run inside
   ``DispatchGuard(max_compiles=0)``: 0 kernel-library builds, 0
   implicit syncs, one explicit fetch a step; then a step with an
   ``.item()`` injected into the decode step must raise
   ``HostSyncError``. (b) ``Engine.roofline()`` beside the guarded steps'
   p50: the bound's share of the step. (c) One ``Trainer`` step at B = 4,
   S = 2048 under ``DispatchGuard(raise_on_sync=False,
   max_compiles=None)``: its implicit and explicit syncs, and its MFU from
   ``analysis.roofline.model_flops``. (d) ``ReplicaRouter(replicas=2)``
   on (a)'s weights serves 16 greedy requests; its streams equal one
   engine's bit for bit, 8 requests a replica. (e)
   ``repro_torch.examples.train_lm`` for 4 steps, and ``python -m
   repro_torch.bench.run --only roofline``. The kernels' counts are set to
   0 just before each of (a), (c), (d) and (e) and read just after.
14. Tensor-parallel serving of full-width sparse qwen3-1.7b (bf16,
   random weights from --seed) on (1, tp) meshes of the card (every shard
   on the one card: this measures what sharding costs, not a speedup).
   (a) Engines at tp 1, 2 and 4 (``max_slots=8, max_len=2048``, one state
   dict shared): the first prefill's and the first decode step's logits of
   4 fixed prompts held against tp 1's (``TP_LOGIT_TOL``), then 12
   requests of 257-512 prompt tokens, 16 new each, greedy and then
   seeded-sampled; each stream must equal tp 1's token for token (a
   divergence is printed with the top-2 gap of tp 1's decision at its
   step, then fails). At tp 2 the same logits under two planted shard
   faults (``TP_FAULTS``: shard 1 reading shard 0's rows of ``cols``; the
   shards' kv heads swapped) must read above ``TP_LOGIT_TOL``. (b) Each kernel at the shard shapes of tp 2 and
   4 against its plain version, timed as in phase 3: ``bsr_matmul`` on
   each rank's block rows of q, k/v, gate/up and down at M = 8 and 4096,
   the paged read at Hk = 4 and 2, ``block_sparse_attention`` at
   H = 8 / 4, Hk = 4 / 2. (c) ``ReplicaRouter(replicas=2, tp=2)`` (4
   shards on the card) serves 16 greedy requests: streams equal to one
   tp 2 engine's bit for bit. (d) ``repro_torch.bench.serve_mesh`` at
   full width on (a)'s weights, at tp 1 and 2 (its oracle and the
   smallest split; tp 8 is cut for the time budget) with its 2-replica
   router: its rows
   beside the card's name and power limit; then the serve CLI with ``--tp 2
   --strategy tp``. The kernels' counts are set to 0 just before each of
   (a), (c) and (d) and read just after: all three launch.
15. Training on a mesh (one card, every position on it): (a) full-width
   sparse qwen3-1.7b through ``Trainer(mesh=...)`` at B = 4, S = 2048, bf16,
   1 warm-up and 2 timed steps on the (1, 1) reference, fsdp (2, 1), tp
   (1, 2) and tp (2, 2) from one state dict: step ms, tokens/s, peak memory,
   positions and distinct devices; each step's loss and grad norm and the
   first step's gradient by parameter kind held against (1, 1)'s within
   ``MESH_TOL``, the parameters' difference relative to (1, 1)'s update
   printed; two planted faults (``MESH_FAULTS``: a tensor every model shard
   holds taking its gradient from shard 0 alone; a replica's rows left out
   of the global label count), one step each, must read above ``MESH_TOL``. (b)
   ``bsr_matmul`` forward and dX at an fsdp position's M = 4096 and a tp 2
   shard's block rows at M = 8192 (dX on the transposed pattern of a row
   slice), ``block_sparse_attention`` at H = 8, Hk = 4, B = 4 and H = 16,
   Hk = 8, B = 2, each against its plain version and timed as in phase 3.
   The kernels' counts are set to 0 after each run's warm-up step and read
   after its last.
16. The dry-run over the production meshes and the sharded contiguous
   prefill and decode. (a) ``launch.dryrun.run_cell`` on the meta 16 x 16
   mesh (host only, in a helper process started with the script, so its
   host seconds overlap phases 3-15) for full-width qwen3-1.7b ``train_4k``, ``prefill_32k``
   and ``decode_32k`` and musicgen-large ``train_4k``, each ``ok``, and a
   refused cell that must name its ROADMAP item: per-device bytes,
   argument bytes, the three roofline terms, the bottleneck and the useful
   ratio (counts at the data-sheet peaks, not times). (b) Full-width sparse
   qwen3-1.7b on the (1, 1) mesh, B = 4, S = 2048, one step: its meta count
   and ``roofline.count`` of the same step on the card give equal FLOPs
   and bytes, and the meta prediction (argument + temp bytes) is within
   ``DRYRUN_MEM_TOL`` of ``torch.cuda.max_memory_allocated()`` over the
   step. (c) ``Engine.roofline()`` of phase 14a's engines (built again on
   one state dict, run before (b)): the tp 2 record available, collective
   bytes above 0, FLOPs per device beside tp 1's. (d) Smoke
   (fp32) and full-width (bf16) qwen3-1.7b through ``transformer.prefill``
   and 8 ``decode_step`` calls on a ``MeshState`` at tp (1, 2) and fsdp
   (2, 1) against (1, 1): logits within ``TP_LOGIT_TOL`` (bf16) or
   ``SHARDED_FP32_TOL``, greedy tokens equal, and a planted "cols" shard
   fault at tp (1, 2) reading above the tolerance. The kernels' counts
   are set to 0 before (b) to (d) and read after: all three launch.
17. The kernels line (with each kernel's launches in phases 5 to 16, a
   row for the b = 32 tensor-core path at ViT-B/16's shapes and one for
   attention at head dim 80), the script's wall time, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

It imports nothing of JAX and nothing of the JAX package ``src/repro``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# record_function ranges of the port's plain-torch pieces: serving, and
# the training step's parts and backward pieces
RANGES = ("sampler", "prefix_flash_attention", "train_forward", "train_backward", "optimizer",
          "bsr_matmul_dx", "bsr_matmul_dblocks", "sparse_attention_vjp",
          "moe_dispatch", "moe_experts", "moe_combine", "ssd_scan")


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------------
# measurement helpers
# ----------------------------------------------------------------------


class Timer:
    """Kernel time by CUDA events around each launch, after flushing the
    50 MB L2 with a 256 MB write outside the timed window. Every launch is
    queued behind a ~20 ms device sleep, so the host's time in a wrapper
    never shows up as a gap between the events: the events time the
    device alone."""

    def __init__(self, iters=20, warmup=3):
        self.iters = iters
        self.warmup = warmup
        self.flush_buf = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at the H100's clocks
        pairs = []
        for _ in range(self.iters):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


def host_us(fn, n=200) -> float:
    """Host time of one call (wrapper checks, launch), from a loop of n
    calls that is not waited on: what a host-bound step pays per launch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def function_host_us(fn) -> float:
    """``host_us`` of fn under ``torch.no_grad()``, after one call that
    fills fn's caches."""
    with torch.no_grad():
        fn()
        return host_us(fn)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the FLOPs' at the
    dtype's peak, from ``analysis.roofline.HW`` (the H100 SXM data sheet),
    the constants the engine's roofline uses."""
    from repro_torch.analysis.roofline import HW

    hw = HW()
    t_bytes = nbytes / hw.hbm_bw * 1e3
    t_ops = flops / hw.flops_for(dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, tol) -> float:
    """Reference tolerance, assert_allclose style: |got - want| <= tol +
    tol * |want| everywhere. Returns the max abs error."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    worst = (err - tol * w.abs()).max().item()
    max_abs = err.max().item()
    if not (worst <= tol) or not math.isfinite(max_abs):
        raise AssertionError(f"{name}: max abs err {max_abs:.3e} beyond tol {tol:g} (rtol=atol)")
    return max_abs


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes: two runs
    on the same seeded inputs gave the same bits if their digests agree."""
    import hashlib

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def dev_us(e):
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def profiled(label, fn, cpu=True, tag="5"):
    """Wall time, device busy share and the top device kernels of one
    window around fn (which ends in a synchronise). With cpu=False only
    the device is traced (no host ops or ranges), which costs the host
    less. The port's record_function ranges (``RANGES``) are read apart:
    the device time of the kernels launched inside each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device-side events only: an aten op's row repeats its kernels' time
    # (the port's record_function ranges are read apart, not summed)
    averages = prof.key_averages()
    rows = sorted(
        (e for e in averages
         if getattr(e, "device_type", None) == DeviceType.CUDA and e.key not in RANGES),
        key=dev_us, reverse=True,
    )
    busy_us = sum(dev_us(e) for e in rows)
    # the port's kernels by name prefix (a kernel may launch several)
    ours = {}
    for name in ("bsr_matmul", "paged_decode", "block_sparse_attention"):
        hits = [e for e in rows if f"{name}_" in e.key]
        ours[name] = {"device_ms": sum(dev_us(e) for e in hits) / 1e3,
                      "launches": sum(e.count for e in hits),
                      "kernels": sorted({e.key[:60] for e in hits})}
    # device time of the kernels launched inside each named range: the
    # host-side range's total (its children's kernels), else the
    # device-side annotation's span
    ranges = {}
    for name in RANGES:
        host = [e for e in averages if e.key == name and getattr(e, "device_type", None) != DeviceType.CUDA]
        span = [e for e in averages if e.key == name and getattr(e, "device_type", None) == DeviceType.CUDA]
        us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) for e in host)
        if not us:
            us = sum(dev_us(e) for e in span)
        if host or span:
            ranges[name] = {"device_ms": us / 1e3, "calls": sum(e.count for e in host) or None}
    out = {
        "window_ms": window * 1e3,
        "ranges": ranges,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / window if busy_us else None,
        "top": [(e.key[:80], dev_us(e) / 1e3, e.count) for e in rows[:8] if dev_us(e) > 0],
        "ours": ours,
    }
    if busy_us:
        log(f"[{tag}] profiled {label}: {window * 1e3:.1f} ms wall, device busy "
            f"{busy_us / 1e3:.1f} ms, idle share {out['device_idle_share']:.2f}")
        for name, ms, n in out["top"]:
            log(f"[{tag}]   {ms:8.3f} ms  x{n:<5d} {name}")
        for name, o in ranges.items():
            log(f"[{tag}]   range {name}: {o['device_ms']:.3f} ms of device time over {o['calls']} calls")
        for name, o in ours.items():
            if o["launches"]:
                log(f"[{tag}]   port kernel {name}: {o['device_ms']:.3f} ms over {o['launches']} device "
                    f"launches ({1e3 * o['device_ms'] / o['launches']:.1f} us each) {o['kernels']}")
    else:
        log(f"[{tag}] profiler recorded no device time for {label}: device busy share not measured")
    return out


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------


def bsr_row(timer, x, blocks, cols, n_in, slots, tol, label, timed=True):
    """One ``bsr_matmul_cuda`` call against its plain version (its digest
    says whether two runs gave the same bits), and, if ``timed``, its time
    beside its bound, the plain version's and ``x @ bsr_to_dense``.
    ``slots`` is the number of b x b products the pattern needs per row
    (the forward's, also for dX)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_matmul import bsr_matmul_cuda

    m, b = x.shape[0], blocks.shape[-1]
    y = bsr_matmul_cuda(x, blocks, cols)
    torch.cuda.synchronize()
    dtype = str(x.dtype).split(".")[1]
    row = {"case": label, "shape": f"M={m} n_in={n_in} nb_out={blocks.shape[0]} r={blocks.shape[1]} b={b}",
           "dtype": dtype, "tol": tol,
           "max_abs_err": check_close(f"bsr_matmul {label} M={m} {dtype}", y, ref.bsr_matmul_gather(x, blocks, cols), tol),
           "out_sha256": digest(y)}
    if timed:
        from repro_torch.kernels.ops import bsr_matmul_cost

        dense = ref.bsr_to_dense(blocks, cols, n_in)
        flops, nbytes = bsr_matmul_cost(x, blocks, cols, slots=slots)
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        row.update(ms=timer.ms(lambda: bsr_matmul_cuda(x, blocks, cols)),
                   plain_ms=timer.ms(lambda: ref.bsr_matmul_gather(x, blocks, cols)),
                   library_ms=timer.ms(lambda: x @ dense), bound_ms=b_ms, bound_by=b_by)
    return row


def bsr_case(timer, lin_spec, m, dtype, seed, tol):
    """``bsr_row`` for one linear's pattern at M rows, on inputs drawn from
    ``seed``, with the host time of one call of the wrapper and of
    ``BsrMatmul`` (what a linear of the serving path pays on the host)."""
    from repro_torch.core.pixelfly import linear_tables
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels.bsr_matmul import bsr_matmul_cuda

    pat = lin_spec.pattern()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, lin_spec.in_features), generator=g, device="cuda").to(dtype)
    blocks = (
        torch.randn((pat.nb_out, pat.r, pat.block, pat.block), generator=g, device="cuda")
        / math.sqrt(pat.r * pat.block)
    ).to(dtype)
    cols = torch.as_tensor(pat.cols, device="cuda")
    row = bsr_row(timer, x, blocks, cols, lin_spec.in_features, pat.nb_out * pat.r, tol,
                  f"{lin_spec.in_features}->{lin_spec.out_features}")
    row["host_us"] = host_us(lambda: bsr_matmul_cuda(x, blocks, cols))
    row["function_host_us"] = function_host_us(
        lambda: AG.bsr_matmul(x, blocks, linear_tables(lin_spec, x.device)))
    return row


def paged_case(timer, *, b, hk, g, d, page, pps, dtype, seed, tol, full=False, schedule="sparse"):
    """Decode read at B slots with a poisoned page 0. By default ragged
    positions, an idle slot on the trash page and a partially allocated
    row; with ``full`` every slot sits at the last position of a fully
    allocated table (every scheduled page visible). ``schedule`` is the
    pixelfly "sparse" schedule or the "dense" one (every page of the
    table, w = pps)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(seed)
    n_pages = b * pps + 1
    k = torch.randn((n_pages, page, hk, d), generator=gen)
    v = torch.randn((n_pages, page, hk, d), generator=gen)
    k[0], v[0] = 1e4, -1e4
    table = torch.randperm(n_pages - 1, generator=gen)[: b * pps].reshape(b, pps).to(torch.int32) + 1
    pos = torch.randint(0, pps * page, (b,), generator=gen, dtype=torch.int32)
    if full:
        pos[:] = pps * page - 1
    else:
        table[1], pos[1] = 0, 0  # idle slot
        table[2, 3:] = 0  # partial row
        pos[2] = 3 * page - 5
    q = torch.randn((b, hk, g, d), generator=gen)
    q, k, v = (t.to("cuda", dtype) for t in (q, k, v))
    table, pos = table.to("cuda"), pos.to("cuda")
    if schedule == "sparse":
        logical, phys, keep = L.paged_sparse_schedule(table, pos, page, local_blocks=2, global_blocks=1)
    else:
        logical, phys, keep = L.paged_dense_schedule(table)
    scale = d ** -0.5
    args = (q, k, v, phys, logical, keep, pos)
    got = paged_decode_attention_cuda(*args, sm_scale=scale)
    torch.cuda.synchronize()
    err = check_close(f"paged_decode_attention B={b} {dtype}", got,
                      ref.paged_decode_attention_gather(*args, sm_scale=scale), tol)
    # what this schedule needs: the visible keys of every kept page
    from repro_torch.kernels.ops import paged_decode_attention_cost

    flops, nbytes = paged_decode_attention_cost(*args, sm_scale=scale)
    n_vis = round(flops / (4.0 * g * d * hk))
    b_ms, b_by = bound_ms(nbytes, flops, str(dtype).split(".")[1])
    # library yardstick: SDPA over the scheduled pages, gathered beforehand
    w = phys.shape[1]
    kg = k[phys.long()].reshape(b, w * page, hk, d).transpose(1, 2).contiguous()
    vg = v[phys.long()].reshape(b, w * page, hk, d).transpose(1, 2).contiguous()
    kpos = (logical.long()[:, :, None] * page + torch.arange(page, device="cuda")).reshape(b, -1)
    mask = ((kpos <= pos.long()[:, None]) & keep.bool().repeat_interleave(page, 1))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {
        "shape": f"B={b} Hk={hk} G={g} D={d} page={page} w={w}",
        "case": f"{schedule}, " + ("every slot at its last position" if full else "ragged positions"),
        "dtype": str(dtype).split(".")[1],
        "visible_keys": n_vis,
        "max_abs_err": err,
        "tol": tol,
        "ms": timer.ms(lambda: paged_decode_attention_cuda(*args, sm_scale=scale)),
        "host_us": host_us(lambda: paged_decode_attention_cuda(*args, sm_scale=scale)),
        "plain_ms": timer.ms(lambda: ref.paged_decode_attention_gather(*args, sm_scale=scale)),
        "library_ms": timer.ms(lambda: sdpa(q, kg, vg, attn_mask=mask, scale=scale)),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def attention_case(timer, *, b, s, h, hk, d, block, dtype, seed, tol):
    from repro_torch.core import attn_pattern as ap
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_attention import block_sparse_attention_cuda

    mask = ap.pixelfly_attention_block_mask(
        s, s, ap.AttentionPatternConfig(block=block, local_blocks=2, global_blocks=1), causal=True
    )
    sched = ap.block_schedule(mask, block, block)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dtype)
    kv_index = torch.as_tensor(sched.kv_index, device="cuda")
    valid = torch.as_tensor(sched.valid, device="cuda")
    scale = d ** -0.5
    kw = dict(block=block, causal=True, sm_scale=scale)
    got = block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw)
    torch.cuda.synchronize()
    g = h // hk

    def plain():
        return ref.sparse_attention(q.reshape(b, s, hk, g, d), k, v, kv_index, valid, **kw)

    err = check_close(f"block_sparse_attention B={b} S={s} H={h} Hk={hk} D={d} {dtype}", got,
                      plain().reshape(b, s, h, d), tol)
    # causal-visible (q, k) pairs of the schedule
    from repro_torch.kernels.ops import block_sparse_attention_cost

    flops, nbytes = block_sparse_attention_cost(q.reshape(b, s, hk, g, d), k, v, kv_index, valid, **kw)
    b_ms, b_by = bound_ms(nbytes, flops, str(dtype).split(".")[1])
    # library yardstick: SDPA with the block mask expanded, K/V repeated
    dense_mask = torch.as_tensor(ref.block_mask_to_dense(mask, block, block, s, s, True), device="cuda")
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {
        "shape": f"B={b} S={s} H={h} Hk={hk} D={d} block={block} nkv={sched.max_nkv}",
        "dtype": str(dtype).split(".")[1],
        "out_sha256": digest(got),
        "max_abs_err": err,
        "tol": tol,
        "ms": timer.ms(lambda: block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw)),
        "host_us": host_us(lambda: block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw)),
        "plain_ms": timer.ms(plain),
        "library_ms": timer.ms(lambda: sdpa(qt, kt, vt, attn_mask=dense_mask, scale=scale)),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


# ----------------------------------------------------------------------
# phase 4: the sampled, prefix-cache and preemption workloads
# ----------------------------------------------------------------------

KNOBS = dict(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1)


def smoke_workloads(smoke, seed):
    """Three smoke-width workloads, each ``fn(device) -> {"streams": ...,
    counters}``; the same seeded weights on every device."""
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.request import ScheduleParams
    from repro_torch.serving.sampling import SamplingParams

    page = smoke.attn_block
    rng = np.random.default_rng(seed + 1)
    sys_prompt = rng.integers(0, smoke.vocab_size, 2 * page).astype(np.int32)
    unrelated = [rng.integers(0, smoke.vocab_size, n).astype(np.int32) for n in (40, 3 * page + 7, 9, page)]
    shared = [np.concatenate([sys_prompt, rng.integers(0, smoke.vocab_size, n).astype(np.int32)])
              for n in (5, page + 3, 30, 17)]

    def sampling(i):  # half sampled with per-request seeds, half temperature 0
        return SamplingParams(seed=seed * 1000 + i, **KNOBS) if i % 2 else SamplingParams()

    def run(device, prompts, gen, ecfg, vip_after=None):
        eng = Engine(smoke, engine_cfg=EngineConfig(max_slots=2, max_len=8 * page, **ecfg),
                     seed=seed, device=device)
        uids = {}
        fins = []
        for i, p in enumerate(prompts):
            uids[eng.submit(p, gen, sampling=sampling(i))] = i
            if ecfg.get("prefix_cache") and i == 0:
                fins += eng.step()  # index the first prompt before the rest arrive
        if vip_after is not None:
            for _ in range(vip_after):
                fins += eng.step()
            uids[eng.submit(unrelated[2], 6, schedule=ScheduleParams(priority=1))] = -1
        fins += eng.drain(max_steps=500)
        return {"streams": {uids[f.uid]: f.tokens.tolist() for f in fins},
                "prefix_hits": eng.stats.prefix_hits, "preemptions": eng.stats.preemptions}

    def sampled(device):
        return run(device, unrelated + shared, 8, {})

    def prefix(device):
        out = run(device, shared + unrelated[:2], 6, {"prefix_cache": True})
        if out["prefix_hits"] < 3:
            raise AssertionError(f"prefix workload: {out['prefix_hits']} prefix hits, expected >= 3")
        return out

    def preemption(device):
        out = run(device, shared[:2] + unrelated[:2], 24, {"prefix_cache": True, "preempt_min_steps": 2},
                  vip_after=4)
        if out["preemptions"] < 1:
            raise AssertionError("preemption workload: the priority-1 request preempted nothing")
        return out

    return {"sampled mix": sampled, "shared-prefix mix": prefix, "priority preemption": preemption}


def smoke_greedy_streams(cfg, work, seed, device):
    """Greedy streams of a smoke-width engine (2 slots, 16 pages a slot)
    over ``work`` [(prompt, new tokens)], weights from ``seed``."""
    from repro_torch.serving.engine import Engine, EngineConfig

    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=16 * cfg.attn_block),
                 seed=seed, device=device)
    uids = {eng.submit(p, n): i for i, (p, n) in enumerate(work)}
    return {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=500)}


# ----------------------------------------------------------------------
# phase 6: sampling, the prefix cache and preemption at full width
# ----------------------------------------------------------------------


def p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def engine_stats(eng) -> dict:
    """What the phases read from an engine's stats: counts from
    ``stats_summary()`` and the raw per-step and per-request samples and
    sums of its metrics registry."""
    s, reg = eng.stats_summary(), eng.metrics
    return {
        **{k: s[k] for k in ("decode_steps", "prefill_calls", "prefill_tokens")},
        **{k: s["preemption"][k] for k in ("preemptions", "resumes")},
        "prefix_hits": s["prefix_cache"]["hits"],
        "prefix_hit_tokens": s["prefix_cache"]["hit_tokens"],
        "prefix_prompt_tokens": s["prefix_cache"]["prompt_tokens"],
        "prefill_s": reg["repro_serve_prefill_seconds_total"].value,
        "decode_tokens": reg["repro_serve_decode_tokens_total"].value,
        "decode_step_s": list(reg["repro_serve_step_latency_seconds"].samples),
        "ttft_s": list(reg["repro_serve_ttft_seconds"].samples),
    }


def full_width_features(full, state_dict, kernels, rng, seed, smi, timer):
    """Serve full-width qwen3-1.7b with the prefix cache on, on phase 5's
    weights (shared, not drawn again): 8 requests on one 1024-token system
    prompt (8 pages) with 64-256-token suffixes, 8 unrelated 200-1000-token
    prompts, half sampled, 48 new tokens each, and 2 priority-1 requests
    submitted after step 6 with all 8 slots busy. Checks: every request
    finishes, >= 7 admissions hit and prefilled only their suffixes, a
    preemption and a resume happened, every kernel launched. Then the
    sampler's and the partial-prefill attention's device time: profiled
    windows and CUDA-event times."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import sampling as S
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.request import ScheduleParams
    from repro_torch.serving.sampling import SamplingParams

    t0 = time.perf_counter()
    eng = Engine(full, engine_cfg=EngineConfig(max_slots=8, max_len=2048, prefix_cache=True),
                 params=state_dict, device="cuda")
    torch.cuda.synchronize()
    log(f"[6] engine on phase 5's weights in {time.perf_counter() - t0:.1f} s (prefix cache on)")
    v, page, gen = full.vocab_size, full.attn_block, 48

    def sp(i):
        return SamplingParams(seed=seed * 1000 + i, **KNOBS) if i % 2 else SamplingParams()

    # warm-up: one sampled request (the sampler's first calls), not counted
    eng.submit(rng.integers(0, v, 300).astype(np.int32), 4, sampling=sp(1))
    eng.drain(max_steps=50)
    eng.reset_stats()
    sys_prompt = rng.integers(0, v, 8 * page).astype(np.int32)
    shared = [np.concatenate([sys_prompt, rng.integers(0, v, int(n)).astype(np.int32)])
              for n in rng.integers(64, 257, 8)]
    unrelated = [rng.integers(0, v, int(n)).astype(np.int32) for n in rng.integers(200, 1001, 8)]
    vips = [rng.integers(0, v, int(n)).astype(np.int32) for n in rng.integers(200, 1001, 2)]
    prompts = shared + unrelated
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    uids = {eng.submit(prompts[0], gen, sampling=sp(0)): 0}
    fins = eng.step()  # the system prompt is prefilled and indexed
    for i in range(1, len(prompts)):
        uids[eng.submit(prompts[i], gen, sampling=sp(i))] = i
    steps = 1
    while not eng.scheduler.idle:
        fins += eng.step()
        steps += 1
        if steps == 6:
            if eng.scheduler.num_active != 8:
                raise AssertionError(f"{eng.scheduler.num_active} slots busy at step 6, expected 8")
            for j, p in enumerate(vips):
                uids[eng.submit(p, gen, sampling=sp(16 + j), schedule=ScheduleParams(priority=1))] = 16 + j
        if steps > 3000:
            raise AssertionError("phase 6 did not drain in 3000 steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    st, sw = engine_stats(eng), eng.swap.stats
    by = {uids[f.uid]: f for f in fins}
    if sorted(by) != list(range(18)) or any(f.finish_reason != "length" or len(f.tokens) != gen
                                            for f in by.values()):
        raise AssertionError(f"not every request finished with {gen} tokens: "
                             f"{[(uids[f.uid], f.finish_reason, len(f.tokens)) for f in fins]}")
    if any(not (0 <= t < v) for f in fins for t in f.tokens):
        raise AssertionError("token id out of the vocabulary")
    hit_ids = [i for i in range(1, 8) if by[i].prefix_hit_tokens >= 8 * page]
    if st["prefix_hits"] < 7 or len(hit_ids) < 7:
        raise AssertionError(f"{st['prefix_hits']} admissions hit the prefix cache, expected >= 7")
    if st["prefill_tokens"] != st["prefix_prompt_tokens"] - st["prefix_hit_tokens"]:
        raise AssertionError(f"prefilled {st['prefill_tokens']} tokens, not the prompts' "
                             f"{st['prefix_prompt_tokens']} less the {st['prefix_hit_tokens']} hit")
    if st["preemptions"] < 1 or st["resumes"] < 1 or sw.swap_ins != sw.swap_outs:
        raise AssertionError(f"preemptions {st['preemptions']}, resumes {st['resumes']}, "
                             f"swap outs {sw.swap_outs}, ins {sw.swap_ins}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the phase 6 path")
    miss_ids = [i for i in range(18) if i not in hit_ids]
    dsteps = st["decode_step_s"]
    out = {
        "requests": len(fins),
        "steps": steps,
        "wall_s": wall,
        "decode_tok_s": st["decode_tokens"] / sum(dsteps),
        "decode_step_ms_p50": 1e3 * p50(dsteps),
        "ttft_ms_p50_hit": 1e3 * p50([by[i].ttft_s for i in hit_ids]),
        "ttft_ms_p50_miss": 1e3 * p50([by[i].ttft_s for i in miss_ids]),
        "prefix_hits": st["prefix_hits"],
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "prefill_tokens": st["prefill_tokens"],
        "preemptions": st["preemptions"],
        "resumes": st["resumes"],
        "swap": {**sw.snapshot(), "out_mb": sw.out_bytes / 1e6, "in_mb": sw.in_bytes / 1e6,
                 "out_ms": 1e3 * sw.out_s, "in_ms": 1e3 * sw.in_s},
        "launches": launches,
        "card": smi,
    }
    log(f"[6] served 18 requests ({len(hit_ids)} prefix hits, {st['preemptions']} preemptions, "
        f"{st['resumes']} resumes) in {wall:.2f} s, {steps} steps, on {smi}: decode "
        f"{out['decode_tok_s']:.1f} tok/s, step p50 {out['decode_step_ms_p50']:.2f} ms; TTFT p50 "
        f"{out['ttft_ms_p50_hit']:.1f} ms for hits, {out['ttft_ms_p50_miss']:.1f} ms for misses; "
        f"prefilled {st['prefill_tokens']} of {st['prefix_prompt_tokens']} prompt tokens")
    log(f"[6] swap: {sw.swap_outs} out ({sw.out_pages} pages, {out['swap']['out_mb']:.1f} MB, "
        f"{out['swap']['out_ms']:.2f} ms host incl. finalize; {sw.pinned_pages} shared pages pinned), "
        f"{sw.swap_ins} in ({sw.in_pages} pages, {out['swap']['in_mb']:.1f} MB, {out['swap']['in_ms']:.2f} ms)")
    log(f"[6] launches on this path: {launches}")

    # the sampler's device time per step: 4 decode steps, 8 sampled slots
    for i in range(8):
        eng.submit(rng.integers(0, v, 128).astype(np.int32), 12, sampling=sp(2 * i + 1))
    eng.step()

    def four_steps():
        for _ in range(4):
            eng.step()

    out["decode_profile"] = {"window_steps": 4, **profiled("4 sampled decode steps", four_steps)}
    eng.drain(max_steps=50)
    # the partial-prefill attention: one prefill_paged call as the engine
    # makes it for 8 hits on an 8-page prefix with 256-token suffixes
    n_seq, s_suf, npre = 8, 256, 8
    per_seq = s_suf // page
    pcache = T.init_paged_cache(full, npre + n_seq * per_seq + 1, page, device="cuda")
    pargs = (
        torch.as_tensor(rng.integers(0, v, (n_seq, s_suf)), dtype=torch.int32, device="cuda"),
        torch.full((n_seq,), s_suf, dtype=torch.int32, device="cuda"),
    )
    prows = torch.arange(npre + 1, npre + 1 + per_seq * n_seq, dtype=torch.int32,
                         device="cuda").reshape(n_seq, per_seq)
    pre_rows = torch.arange(1, npre + 1, dtype=torch.int32, device="cuda")[None].expand(n_seq, npre).contiguous()
    pre_lens = torch.full((n_seq,), npre * page, dtype=torch.int32, device="cuda")

    def one_partial_prefill():
        nonlocal pcache
        logits, pcache = T.prefill_paged(full, eng.model, *pargs, pcache, prows,
                                         prefix_rows=pre_rows, prefix_lens=pre_lens)
        torch.argmax(logits, dim=-1).cpu()

    one_partial_prefill()
    out["partial_prefill_profile"] = {
        "shape": f"N={n_seq} prefix={npre * page} suffix={s_suf}",
        **profiled(f"one partial prefill call (N={n_seq}, prefix {npre * page}, suffix {s_suf})",
                   one_partial_prefill),
    }
    del pcache
    # a sampled decode step against a greedy one: the same 8 prompts, 20
    # decode steps a window, greedy / sampled / sampled / greedy
    window_prompts = [rng.integers(0, v, 128).astype(np.int32) for _ in range(8)]

    def decode_window(sampled):
        for i, p in enumerate(window_prompts):
            eng.submit(p, 21, sampling=sp(2 * i + 1) if sampled else None)
        eng.reset_stats()
        eng.drain(max_steps=50)
        return 1e3 * p50(engine_stats(eng)["decode_step_s"])

    pairs = {"greedy": [], "sampled": []}
    for kind in ("greedy", "sampled", "sampled", "greedy"):
        pairs[kind].append(decode_window(kind == "sampled"))
    out["decode_step_ms_p50_pairs"] = pairs
    log(f"[6] decode step p50 over 20 steps, 8 slots, same prompts (greedy, sampled, sampled, greedy): "
        f"{pairs['greedy'][0]:.2f} / {pairs['sampled'][0]:.2f} / {pairs['sampled'][1]:.2f} / "
        f"{pairs['greedy'][1]:.2f} ms")
    # one page's swap pieces: K and V of (page, Hk, D) in every layer
    pool = eng.kv.buffers[0]["k"]
    staging = pool[:, 1:2].contiguous()
    t0 = time.perf_counter()
    pinned = [torch.empty(staging.shape, dtype=staging.dtype, pin_memory=True) for _ in range(2)]
    alloc_ms = 1e3 * (time.perf_counter() - t0) / 2
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for t in pinned:
        t.copy_(staging, non_blocking=True)
    b.record()
    b.synchronize()
    d2h_ms = a.elapsed_time(b)
    a.record()
    for t in pinned:
        staging.copy_(t, non_blocking=True)
    b.record()
    b.synchronize()
    h2d_ms = a.elapsed_time(b)
    page_mb = 2 * staging.numel() * staging.element_size() / 1e6
    out["swap_page"] = {"page_mb": page_mb, "pinned_alloc_ms": 2 * alloc_ms, "d2h_ms": d2h_ms, "h2d_ms": h2d_ms}
    log(f"[6] one page ({page_mb:.1f} MB, K and V of {staging.shape[0]} layers): pinned allocation {2 * alloc_ms:.2f} ms, "
        f"device->pinned copy {d2h_ms:.3f} ms ({page_mb / d2h_ms:.1f} GB/s), pinned->device "
        f"{h2d_ms:.3f} ms ({page_mb / h2d_ms:.1f} GB/s)")
    # CUDA-event times of one call, on the same shapes
    gen_ = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((8, full.padded_vocab), generator=gen_, device="cuda") * 3
    samp = {k: t for k, t in eng._decode_sampler().items()}
    samp["idx"] = torch.arange(8, device="cuda")
    samp["presence"] = torch.zeros((8, full.padded_vocab + 1), dtype=torch.bool, device="cuda")
    hk, g, d = full.num_kv_heads, full.num_heads // full.num_kv_heads, full.head_dim
    q = torch.randn((n_seq, s_suf, hk, g, d), generator=gen_, device="cuda").to(full.torch_dtype)
    ks, vs = (torch.randn((n_seq, s_suf, hk, d), generator=gen_, device="cuda").to(full.torch_dtype)
              for _ in range(2))
    kp, vp = (torch.randn((n_seq, npre * page, hk, d), generator=gen_, device="cuda").to(full.torch_dtype)
              for _ in range(2))
    blk = (page, full.attn_local_blocks, full.attn_global_blocks, full.attn_max_stride)
    # the sampler's ~330 launches outrun the timer's queueing sleep, so
    # its cost is read as host time per call here and as device time in
    # the profiled window above
    out["sampler_host_us"] = host_us(lambda: S.sample_decode(
        logits, samp, valid_vocab=v, candidates=eng.ecfg.sampler_candidates), n=50)
    out["event_ms"] = {
        "sort_8x152064_stable": timer.ms(lambda: torch.sort(logits, dim=-1, descending=True, stable=True)),
        "prefix_flash_attention_one_layer": timer.ms(lambda: L.prefix_flash_attention(
            q, ks, vs, kp, vp, pre_lens, sm_scale=d ** -0.5, chunk=full.attn_chunk, block_cfg=blk)),
    }
    for name, prof in (("sampler", out["decode_profile"]), ("prefix_flash_attention",
                                                            out["partial_prefill_profile"])):
        r = prof["ranges"].get(name)
        per = "not measured" if not r else (
            f"{r['device_ms'] / 4:.3f} ms per step" if name == "sampler" else f"{r['device_ms']:.3f} ms per call")
        log(f"[6] {name} device time from the profiled window: {per}")
    log("[6] CUDA-event times (device only): " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in out["event_ms"].items())
        + f"; sampler host time {out['sampler_host_us']:.0f} us per call (8 x {full.padded_vocab})")
    return out


# ----------------------------------------------------------------------
# phase 7: training
# ----------------------------------------------------------------------


def dx_case(timer, x, blocks, dy, tables, pat):
    """bf16 times of one linear's backward pieces on the card: dX (the
    kernel on the transposed pattern) beside its bound, its plain version
    and ``dy @ W_dense^T``; the blocks' transpose; the dBlocks
    contraction."""
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels import ops, ref

    with torch.no_grad():
        (m, n_in), n_out = x.shape, dy.shape[1]
        bt = AG.transposed_blocks(blocks, tables)
        dense_t = ref.bsr_to_dense(blocks, tables.cols, n_in).t().contiguous()
        nb_in, w = tables.cols_t.shape
        nbytes = (m * n_out + blocks.numel() + m * n_in) * 2
        flops = 2.0 * m * pat.nb_out * pat.r * pat.block ** 2  # the slots the pattern has
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        return {
            "shape": f"dX: M={m} n_out={n_out} -> n_in={n_in}, transposed (nb_in, w)=({nb_in}, {w}), "
                     f"valid share {tables.valid.float().mean().item():.3f}",
            "ms": timer.ms(lambda: ops.bsr_matmul(dy, bt, tables.cols_t)),
            "transpose_blocks_ms": timer.ms(lambda: AG.transposed_blocks(blocks, tables)),
            "plain_ms": timer.ms(lambda: ref.bsr_matmul_gather(dy, bt, tables.cols_t)),
            "library_ms": timer.ms(lambda: dy @ dense_t),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "dblocks_ms": timer.ms(lambda: AG.bsr_dblocks(x, dy, tables, pat.block)),
        }


def grad_cases(timer, full, seed):
    """(a) The two training kernels under autograd on the card, against
    torch autograd of their plain versions on the same CUDA tensors.
    BsrMatmul at M = 8192 (B = 4 x S = 2048) for q, gate and down (down's
    transposed pattern is ragged), fp32 and bf16: y and dX within the
    phase-3 tolerance, dBlocks within it relative to its largest entry.
    BlockSparseAttention at B = 1, S = 2048, H = 16, Hk = 8, D = 128:
    the forward within the phase-3 tolerance, dq, dk, dv within it
    relative to their largest entry. Then, in bf16 at the training shapes,
    the time of each dX call (the kernel on the transposed pattern)
    beside its bound, the plain version and ``dy @ W_dense^T``, of the
    dBlocks contraction, and of the attention forward at B = 4 and its
    backward."""
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    m = 4 * 2048
    shapes = {"q": (full.d_model, full.q_dim), "gate": (full.d_model, full.d_ff),
              "down": (full.d_ff, full.d_model)}
    rows, dx_rows = [], []
    for label, (n_in, n_out) in shapes.items():
        pat = L.linear_spec(full, n_in, n_out, False).pattern()
        tables = AG.bsr_tables(pat.cols, pat.nb_in, "cuda")
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            g = torch.Generator(device="cuda").manual_seed(seed + n_out)
            x = torch.randn((m, n_in), generator=g, device="cuda").to(dtype).requires_grad_()
            blocks = (torch.randn((pat.nb_out, pat.r, pat.block, pat.block), generator=g, device="cuda")
                      / math.sqrt(pat.r * pat.block)).to(dtype).requires_grad_()
            dy = torch.randn((m, n_out), generator=g, device="cuda").to(dtype)
            y = AG.bsr_matmul(x, blocks, tables)
            dx, db = torch.autograd.grad(y, (x, blocks), dy)
            y_ref = ref.bsr_matmul_gather(x, blocks, tables.cols)
            dx_ref, db_ref = torch.autograd.grad(y_ref, (x, blocks), dy)
            torch.cuda.synchronize()
            name = f"BsrMatmul {label} M={m} {str(dtype).split('.')[1]}"
            errs = {"y": check_close(name + " y", y, y_ref, tol),
                    "dx": check_close(name + " dX", dx, dx_ref, tol)}
            scale = max(1.0, db_ref.float().abs().max().item())
            errs["dblocks"] = check_close(name + " dBlocks", db / scale, db_ref / scale, tol)
            rows.append({"case": name, "tol": tol, "max_abs_err": errs})
            if dtype != torch.bfloat16:
                continue
            dx_rows.append({"linear": label, **dx_case(timer, x.detach(), blocks.detach(), dy, tables, pat),
                            "forward": bsr_case(timer, L.linear_spec(full, n_in, n_out, False), m,
                                                torch.bfloat16, seed=seed + m, tol=tol)})
    for r in rows:
        log(f"[7a] {r['case']}: max abs err y {r['max_abs_err']['y']:.2e}, dX {r['max_abs_err']['dx']:.2e}, "
            f"dBlocks {r['max_abs_err']['dblocks']:.2e} (relative to its largest entry) (tol {r['tol']:g})")
    for r in dx_rows:
        log(f"[7a] bsr_matmul {r['linear']:4s} {r['shape']}: kernel {r['ms']:.4f} ms (+ transposed blocks "
            f"{r['transpose_blocks_ms']:.4f} ms) plain {r['plain_ms']:.4f} ms dy@W_dense^T {r['library_ms']:.4f} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); dBlocks (batched matmul) {r['dblocks_ms']:.4f} ms")
        f = r["forward"]
        log(f"[7a] bsr_matmul {r['linear']:4s} forward {f['shape']}: err {f['max_abs_err']:.2e} kernel {f['ms']:.4f} ms "
            f"plain {f['plain_ms']:.4f} ms x@dense {f['library_ms']:.4f} ms bound {f['bound_ms']:.4f} ms ({f['bound_by']})")

    attn = []
    hk, g_, d, block = full.num_kv_heads, full.num_heads // full.num_kv_heads, full.head_dim, full.attn_block
    for b, s in ((1, 2048), (4, 2048)):
        kv_index, valid = L._schedule_tensors(s, block, full.attn_local_blocks, full.attn_max_stride,
                                              full.attn_global_blocks, "cuda")
        kw = dict(block=block, causal=True, sm_scale=d ** -0.5)
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            if b == 4 and dtype == torch.float32:
                continue  # the training shape is timed in bf16 only
            gen = torch.Generator(device="cuda").manual_seed(seed + b)
            q = torch.randn((b, s, hk, g_, d), generator=gen, device="cuda").to(dtype).requires_grad_()
            k, v = (torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dtype).requires_grad_()
                    for _ in range(2))
            do = torch.randn((b, s, hk, g_, d), generator=gen, device="cuda").to(dtype)
            o = AG.block_sparse_attention(q, k, v, kv_index, valid, **kw)
            got = torch.autograd.grad(o, (q, k, v), do)
            o_ref = ref.sparse_attention(q, k, v, kv_index, valid, **kw)
            want = torch.autograd.grad(o_ref, (q, k, v), do)
            torch.cuda.synchronize()
            name = f"BlockSparseAttention B={b} S={s} {str(dtype).split('.')[1]}"
            errs = {"o": check_close(name + " o", o, o_ref, tol)}
            for key, a, w in zip(("dq", "dk", "dv"), got, want):
                sc = max(1.0, w.float().abs().max().item())
                errs[key] = check_close(f"{name} {key}", a / sc, w / sc, tol)
            row = {"case": name, "tol": tol, "max_abs_err": errs}
            if dtype == torch.bfloat16:
                qd, kd, vd = (t.detach() for t in (q, k, v))
                row["forward_ms"] = timer.ms(lambda: ops.block_sparse_attention(qd, kd, vd, kv_index, valid, **kw))
                row["backward_ms"] = timer.ms(lambda: AG.sparse_attention_vjp(qd, kd, vd, kv_index, valid, do, **kw))
            attn.append(row)
            log(f"[7a] {name}: max abs err o {errs['o']:.2e}, dq {errs['dq']:.2e}, dk {errs['dk']:.2e}, "
                f"dv {errs['dv']:.2e} (gradients relative to their largest entry) (tol {tol:g})"
                + (f"; kernel forward {row['forward_ms']:.4f} ms, backward (plain, recomputed) "
                   f"{row['backward_ms']:.4f} ms" if "forward_ms" in row else ""))
            del q, k, v, o, got, o_ref, want
    # the forward kernel at the training shape, as phase 3 times it
    attn_train = attention_case(timer, b=4, s=2048, h=full.num_heads, hk=hk, d=d, block=block,
                                dtype=torch.bfloat16, seed=seed + 4, tol=2e-2)
    log(f"[7a] block_sparse_attention bfloat16 {attn_train['shape']}: err {attn_train['max_abs_err']:.2e} "
        f"kernel {attn_train['ms']:.4f} ms plain {attn_train['plain_ms']:.4f} ms sdpa {attn_train['library_ms']:.4f} ms "
        f"bound {attn_train['bound_ms']:.4f} ms ({attn_train['bound_by']})")
    return {"bsr_grads": rows, "dx": dx_rows, "attention": attn, "attention_forward_train_shape": attn_train}


def smoke_step_cpu_vs_card(smoke, tag="7b", batch=None):
    """(b) One fp32 ``make_train_step`` step of the smoke model, seed 0, on
    the CPU (plain versions) and on the card (kernels): loss and grad_norm
    within 1e-4 relative; every parameter within 1e-6 where the CPU
    gradient exceeds 1e-5 in magnitude and within 2 * lr elsewhere (a
    gradient near 0 takes a sign-like first Adam step on either side).
    ``batch`` defaults to 4 x 128 tokens of ``SyntheticLM``; a parameter
    the loss does not reach has a zero gradient."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import MeshState, make_train_step
    from repro_torch.training.optimizer import OptConfig, init_opt_state

    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    if batch is None:
        batch = SyntheticLM(smoke.vocab_size, 128, 4, seed=0).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = T.init_model(smoke, seed=0, device=dev)
        if dev == "cpu":
            params = dict(model.named_parameters())
            loss, _ = T.forward_train(smoke, model, batch)
            g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if x is None else x for (n, p), x in zip(params.items(), g)}
        ms = MeshState(smoke, make_local_mesh(devices=[dev]), "fsdp", model.state_dict())
        m = make_train_step(smoke, opt)(ms, init_opt_state(opt, ms.shards), batch)
        out[dev] = ({k: float(v) for k, v in m.items()}, ms.state_dict())
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    for key in ("loss", "grad_norm"):
        if not abs(mg[key] - mc[key]) <= 1e-4 * abs(mc[key]):
            raise AssertionError(f"smoke train step {key}: card {mg[key]} cpu {mc[key]}")
    worst_big = worst = 0.0
    for n, p in pc.items():
        err = (pg[n].float() - p.float()).abs()
        big = grads[n].abs() > 1e-5
        if big.any():
            worst_big = max(worst_big, err[big].max().item())
        worst = max(worst, err.max().item())
    if worst_big > 1e-6 or worst > 2 * opt.lr:
        raise AssertionError(f"smoke train step parameters: max err {worst_big:.2e} where |g| > 1e-5 "
                             f"(tol 1e-6), {worst:.2e} elsewhere (tol {2 * opt.lr:g})")
    log(f"[{tag}] {smoke.name} smoke fp32 train step, CPU vs card: loss {mc['loss']:.6f} / {mg['loss']:.6f}, grad_norm "
        f"{mc['grad_norm']:.6f} / {mg['grad_norm']:.6f}; parameters max err {worst_big:.2e} where |g| > 1e-5, "
        f"{worst:.2e} anywhere")
    return {"cpu": mc, "card": mg, "param_err_big_grad": worst_big, "param_err_max": worst}


def full_width_training(full, seed, smi, kernels):
    """(c) Full-width sparse qwen3-1.7b through ``Trainer`` at B = 4,
    S = 2048 (SyntheticLM over the full vocab): 1 warm-up step and 3 timed
    steps with every kernel's count reset before them, then one profiled
    step whose forward is marked, to split the launches between forward
    and backward, and one step traced on the device only for the busy
    share."""
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import TrainConfig, Trainer
    from repro_torch.training.optimizer import OptConfig

    import shutil

    b, s = 4, 2048
    ckpt = ROOT / "build" / "chip_smoke_full_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)  # nothing to restore: start from the seed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(
        full, OptConfig(lr=3e-4, warmup_steps=2, total_steps=100),
        SyntheticLM(full.vocab_size, s, b, seed=seed),
        TrainConfig(steps=4, ckpt_dir=str(ckpt), ckpt_every=10 ** 9,
                    log_every=1, seed=seed),
        device="cuda",
    )
    torch.cuda.synchronize()
    n_params = trainer.model.n_params
    log(f"[7c] full-width trainer: {n_params / 1e6:.1f} M parameters, weights and AdamW state in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    warm = trainer.run(1)
    for k in kernels.values():
        k.launches = 0
    hist = trainer.run(3)
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    for h in warm + hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"full-width training step {h['step']}: loss {h['loss']}, grad_norm {h['grad_norm']}")
    for name in ("bsr_matmul", "block_sparse_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched in the training steps")
    if launches["paged_decode_attention"]:
        raise AssertionError("paged_decode_attention launched in training")
    step_ms = [1e3 * h["step_time_s"] for h in hist]
    med = sorted(step_ms)[1]
    # one profiled step, with the end of its forward marked
    marks = []
    forward_train = T.forward_train

    def marked_forward(*a, **kw):
        out = forward_train(*a, **kw)
        marks.append({n: k.launches for n, k in kernels.items()})
        return out

    for k in kernels.values():
        k.launches = 0
    T.forward_train = marked_forward
    try:
        prof = profiled("one full-width training step (B=4, S=2048)", lambda: trainer.run(1))
    finally:
        T.forward_train = forward_train
    total = {n: k.launches for n, k in kernels.items()}
    split = {n: {"forward": marks[0][n], "backward": total[n] - marks[0][n]} for n in total}
    dx = prof["ranges"].get("bsr_matmul_dx", {}).get("calls")
    # the busy share of a step from a trace of that step alone: the device
    # only, so the host pays less for the tracing than in the step above
    busy = profiled("one full-width training step, device only", lambda: trainer.run(1), cpu=False)
    out = {
        "shape": f"B={b} S={s} tokens={b * s}",
        "parameters": n_params,
        "loss": [h["loss"] for h in warm + hist],
        "grad_norm": [h["grad_norm"] for h in warm + hist],
        "warmup_step_ms": 1e3 * warm[0]["step_time_s"],
        "step_ms": step_ms,
        "step_ms_median": med,
        "train_tok_s": b * s / (med / 1e3),
        "max_memory_allocated_gb": peak,
        "launches": launches,
        "profiled_step": {**prof, "launch_split": split, "bsr_matmul_dx_calls": dx},
        "device_only_trace": {k: busy[k] for k in ("window_ms", "device_busy_ms", "device_idle_share")},
        "card": smi,
    }
    log(f"[7c] full width, B={b} S={s}, on {smi}: losses {', '.join(f'{x:.4f}' for x in out['loss'])}; "
        f"grad norms {', '.join(f'{x:.3f}' for x in out['grad_norm'])}")
    log(f"[7c] warm-up step {out['warmup_step_ms']:.0f} ms; timed steps {', '.join(f'{x:.1f}' for x in step_ms)} ms "
        f"(median {med:.1f} ms, {out['train_tok_s']:.0f} train tokens/s); peak memory {peak:.2f} GB")
    log(f"[7c] launches over the 3 timed steps: {launches}")
    if busy["device_idle_share"] is not None:
        log(f"[7c] device-only trace of one step: {busy['window_ms']:.1f} ms wall, device busy "
            f"{busy['device_busy_ms']:.1f} ms, idle share {busy['device_idle_share']:.2f}")
    log(f"[7c] profiled step, launches in forward / backward (the backward recomputes each layer's "
        f"forward): bsr_matmul {split['bsr_matmul']['forward']} / {split['bsr_matmul']['backward']} (dX "
        f"{dx} of them), block_sparse_attention {split['block_sparse_attention']['forward']} / "
        f"{split['block_sparse_attention']['backward']}")
    del trainer
    torch.cuda.empty_cache()
    return out


def smoke_checkpoint_round_trip(smoke):
    """(d) A smoke-width Trainer on the card: 2 steps, a checkpoint, 1 more
    step; a new Trainer restores step 2 with every parameter and moment
    equal bit for bit, and its next step's loss equals the first one's."""
    import shutil

    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import TrainConfig, Trainer
    from repro_torch.training.optimizer import OptConfig

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def trainer():
        return Trainer(smoke, OptConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                       SyntheticLM(smoke.vocab_size, 128, 4, seed=0),
                       TrainConfig(ckpt_dir=str(ckpt), ckpt_every=1000, log_every=1000), device="cuda")

    a = trainer()
    a.run(2)
    a.checkpoint()
    snap = a.state()
    loss3 = a.run(1)[0]["loss"]
    b = trainer()
    if (b.step, b.opt["step"]) != (2, 2):
        raise AssertionError(f"restored step {b.step}, optimizer step {b.opt['step']}, expected 2")
    got = b.state()
    for n, p in got["params"].items():
        if not (torch.equal(p, snap["params"][n])
                and all(torch.equal(got["opt"][k][n], snap["opt"][k][n]) for k in ("mu", "nu"))):
            raise AssertionError(f"checkpoint round trip on the card changed {n}")
    loss3_b = b.run(1)[0]["loss"]
    if loss3_b != loss3:
        raise AssertionError(f"step 3 after restore: loss {loss3_b} != {loss3}")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[7d] smoke checkpoint round trip on the card: step 2 restored bit for bit "
        f"({len(snap['params'])} parameters and their moments), step 3 loss {loss3:.6f} on both")
    return {"loss3": loss3}


# ----------------------------------------------------------------------
# phase 8: the rest of the dense family, and dense against pixelfly
# ----------------------------------------------------------------------

# the two full-width models of phase 8 and the batch each trains at in (d)
FAMILY = {"smollm-360m": 8, "qwen2-1.5b": 4}


def family_kernels(timer, seed):
    """(a) The three kernels at the shapes of smollm-360m (G = 3, D = 64,
    linears at block 64) and qwen2-1.5b (G = 6, D = 128, block 128)
    against their plain versions, timed as in phase 3: bf16 attention at
    B = 1 and at the training batch, S = 2048; the paged decode read at
    B = 8, page 128; bsr_matmul forward at M = 8 and the training M, and
    dX on the transposed patterns at the training M. Then the G in
    {1, 2, 4} outputs at phase 3's main shape: their digests, and each
    equal bit for bit to the G = 1 launch on K/V repeated to every query
    head (the layout untouched by the new sub-group axis). Then the dense
    baseline's attention (PyTorch's flash kernel) against the chunked
    plain version at qwen3-1.7b's training shape."""
    from repro_torch.configs import registry
    from repro_torch.kernels.bsr_attention import block_sparse_attention_cuda
    from repro_torch.models import layers as L

    out = arch_kernels(timer, seed, FAMILY, "8a")

    # G in {1, 2, 4} at phase 3's main shape: digests, and the G = 1 bits
    bits = []
    for g in (1, 2, 4):
        q, k, v, kv_index, valid = attention_inputs(1, 2048, 8, g, 128, 128, seed + g)
        kw = dict(block=128, causal=True, sm_scale=128 ** -0.5)
        got = block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw)
        k1, v1 = (t.repeat_interleave(g, dim=2).contiguous() for t in (k, v))
        same = torch.equal(got, block_sparse_attention_cuda(q, k1, v1, kv_index, valid, **kw))
        if not same:
            raise AssertionError(f"block_sparse_attention G={g}: the grouped launch differs from the "
                                 "G = 1 launch on repeated K/V")
        bits.append({"g": g, "shape": f"B=1 S=2048 H={8 * g} Hk=8 D=128 block=128", "out_sha256": digest(got),
                     "equals_one_head_blocks": same})
    out["gqa_bits"] = bits
    log("[8a] block_sparse_attention bf16 G in {1, 2, 4} at B=1 S=2048 Hk=8 D=128: equal bit for bit to the "
        "G = 1 launch on repeated K/V; digests " + ", ".join(f"G={r['g']} {r['out_sha256']}" for r in bits))

    # the dense baseline's attention: library flash against the chunked plain version
    qwen3 = registry.get("qwen3-1.7b")
    b, s, hk, g, d = 4, 2048, qwen3.num_kv_heads, qwen3.num_heads // qwen3.num_kv_heads, qwen3.head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, hk, g, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, s, hk, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    kw = dict(sm_scale=d ** -0.5, chunk=qwen3.attn_chunk)
    got = L.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = check_close("dense attention (flash) vs chunked", got, L.chunked_attention(q, k, v, **kw), 2e-2)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4.0 * d * b * hk * g * s * (s + 1) / 2  # the causal (q, k) pairs
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    out["dense_attention"] = {
        "shape": f"B={b} S={s} H={hk * g} Hk={hk} D={d} causal", "dtype": "bfloat16", "max_abs_err": err,
        "tol": 2e-2, "ms": timer.ms(lambda: L.flash_attention(q, k, v, **kw)),
        "plain_ms": timer.ms(lambda: L.chunked_attention(q, k, v, **kw)),
        "bound_ms": b_ms, "bound_by": b_by, "library": "torch scaled_dot_product_attention, flash backend",
    }
    r = out["dense_attention"]
    log(f"[8a] dense attention (library flash; no TPU kernel) bf16 {r['shape']}: err vs chunked {err:.2e} "
        f"(tol 2e-2) flash {r['ms']:.4f} ms chunked plain {r['plain_ms']:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    return out


def arch_kernels(timer, seed, archs, tag):
    """The three kernels at the shapes of each full-width sparse arch in
    ``archs`` (name -> training batch) against their plain versions,
    timed as in phase 3: bf16 attention at B = 1 and at the training
    batch, S = 2048; the paged decode read at B = 8, page = the attention
    block; bsr_matmul forward at M = 8 and the training M for each
    distinct linear shape, and dX on its transposed pattern at the
    training M."""
    from repro_torch.configs import registry
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L

    out = {"block_sparse_attention": [], "paged_decode_attention": [], "bsr_matmul": [], "bsr_matmul_dx": []}
    for arch, b_train in archs.items():
        full = registry.get(arch, sparse=True)
        h, hk, d = full.num_heads, full.num_kv_heads, full.head_dim
        for b in (1, b_train):
            row = attention_case(timer, b=b, s=2048, h=h, hk=hk, d=d, block=full.attn_block,
                                 dtype=torch.bfloat16, seed=seed + b, tol=2e-2)
            out["block_sparse_attention"].append({"arch": arch, **row})
        row = paged_case(timer, b=8, hk=hk, g=h // hk, d=d, page=full.attn_block, pps=16,
                         dtype=torch.bfloat16, seed=seed + 9, tol=1e-2)
        out["paged_decode_attention"].append({"arch": arch, **row})
        m_train = b_train * 2048
        shapes = {}  # (n_in, n_out) -> labels: one case a distinct shape
        for label, shape in {"q": (full.d_model, full.q_dim), "kv": (full.d_model, full.kv_dim),
                             "gate/up": (full.d_model, full.d_ff), "down": (full.d_ff, full.d_model)}.items():
            shapes.setdefault(shape, []).append(label)
        for (n_in, n_out), labels in shapes.items():
            label = "/".join(labels)
            spec = L.linear_spec(full, n_in, n_out, False)
            for m in (8, m_train):
                row = bsr_case(timer, spec, m, torch.bfloat16, seed=seed + m, tol=2e-2)
                out["bsr_matmul"].append({"arch": arch, "linear": label, **row})
            pat = spec.pattern()
            tables = AG.bsr_tables(pat.cols, pat.nb_in, "cuda")
            g = torch.Generator(device="cuda").manual_seed(seed + n_out)
            x = torch.randn((m_train, n_in), generator=g, device="cuda").to(torch.bfloat16)
            blocks = (torch.randn((pat.nb_out, pat.r, pat.block, pat.block), generator=g, device="cuda")
                      / math.sqrt(pat.r * pat.block)).to(torch.bfloat16)
            dy = torch.randn((m_train, n_out), generator=g, device="cuda").to(torch.bfloat16)
            xr, br = x.clone().requires_grad_(), blocks.clone().requires_grad_()
            dx = torch.autograd.grad(AG.bsr_matmul(xr, br, tables), xr, dy)[0]
            dx_ref = torch.autograd.grad(ref.bsr_matmul_gather(xr, br, tables.cols), xr, dy)[0]
            err = check_close(f"{arch} {label} dX M={m_train}", dx, dx_ref, 2e-2)
            out["bsr_matmul_dx"].append({"arch": arch, "linear": label, "max_abs_err": err, "tol": 2e-2,
                                         **dx_case(timer, x, blocks, dy, tables, pat)})
    for r in out["block_sparse_attention"]:
        log(f"[{tag}] {r['arch']} block_sparse_attention bf16 {r['shape']}: err {r['max_abs_err']:.2e} (tol 2e-2) "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for r in out["paged_decode_attention"]:
        log(f"[{tag}] {r['arch']} paged_decode_attention bf16 {r['shape']}: err {r['max_abs_err']:.2e} (tol 1e-2) "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    for r in out["bsr_matmul"]:
        log(f"[{tag}] {r['arch']} bsr_matmul {r['linear']:7s} {r['shape']}: err {r['max_abs_err']:.2e} kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms x@dense {r['library_ms']:.4f} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for r in out["bsr_matmul_dx"]:
        log(f"[{tag}] {r['arch']} bsr_matmul {r['linear']:7s} {r['shape']}: err {r['max_abs_err']:.2e} kernel "
            f"{r['ms']:.4f} ms (+ transposed blocks {r['transpose_blocks_ms']:.4f} ms) plain {r['plain_ms']:.4f} ms "
            f"dy@W_dense^T {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"dBlocks {r['dblocks_ms']:.4f} ms")
    return out


def attention_inputs(b, s, hk, g, d, block, seed):
    """bf16 q (B, S, Hk * G, D), k, v (B, S, Hk, D) on the card from
    ``seed``, and the causal pixelfly schedule (2 local, 1 global)."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, hk * g, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, s, hk, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    kv_index, valid = L._schedule_tensors(s, block, 2, 0, 1, "cuda")
    return q, k, v, kv_index, valid


def family_smoke(seed):
    """(b) fp32 sparse smoke models of smollm-360m and qwen2-1.5b, the same
    seeded weights on both devices: equal greedy streams on the CPU and
    the card; then one qwen2-1.5b smoke train step, CPU against card, held
    as phase 7b holds qwen3's."""
    from repro_torch.configs import registry

    out = {}
    for arch in FAMILY:
        cfg = registry.get_smoke(arch, sparse=True)
        page = cfg.attn_block
        rng = np.random.default_rng(seed + 8)
        work = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
                for n in (9 * page + 20, 2 * page + 1, 40, 14 * page + 3)]
        got = {dev: smoke_greedy_streams(cfg, work, seed, dev) for dev in ("cpu", "cuda")}
        if got["cpu"] != got["cuda"]:
            raise AssertionError(f"{arch} smoke streams differ: cpu {got['cpu']} cuda {got['cuda']}")
        out[arch] = {"requests": len(work), "tokens": sum(len(t) for t in got["cpu"].values())}
        log(f"[8b] {arch} smoke-width sparse fp32: CPU and card greedy streams equal over {len(work)} requests")
    out["train_step"] = smoke_step_cpu_vs_card(registry.get_smoke("qwen2-1.5b", sparse=True), tag="8b")
    return out


# The layers kept of each family path's published depth (32, 28, 28, 48
# in 8c, 11c and 11d; 28, 54, 24 in 12c and 12d): the widths stay
# published, the depth is cut to keep the whole script inside its time
# budget, 12c/d's the most (the kernels run at these models' shapes in 8a,
# 11a and 12a whatever the depth).
DEPTH_CUTS = {"smollm-360m": 16, "qwen2-1.5b": 14, "qwen2-vl-7b": 7, "musicgen-large": 12,
              "deepseek-moe-16b": 4, "zamba2-2.7b": 6, "mamba2-130m": 6}


def family_full_width(arch, seed, smi, kernels, tag="8c", traced=False):
    """(c) Full-width sparse ``arch`` at the depth of ``DEPTH_CUTS``:
    ``Engine(max_slots=8, max_len=2048)``
    serves 8 requests of 200-1000 prompt tokens from ``seed``, 32 new
    tokens each; then a ``Trainer`` takes 1 warm-up and 2 timed steps at
    B = 4, S = 2048 (on ``EmbedsWrapper`` batches for a backbone that
    reads embeddings; at B = 2 if B = 4 runs out of memory or peaks above
    72 GB, and the report says so). The kernels' counts are set to 0 just
    before each of the two and read just after: all three must launch in
    serving, the two training kernels in training; every request
    finishes, loss and grad norm are finite. ``traced``: one more step
    traced on the device only gives the step's busy share."""
    from repro_torch.configs import registry

    full = registry.get(arch, sparse=True)
    depth = {"published": full.num_layers, "run": DEPTH_CUTS.get(arch, full.num_layers)}
    full = full.replace(num_layers=depth["run"])
    log(f"[{tag}] {arch}: {depth['run']} of its {depth['published']} layers (DEPTH_CUTS), published widths")
    serving = engine_serving(full, seed, smi, kernels, tag)
    training = trainer_steps(full, seed, smi, kernels, tag, traced=traced)
    return {"serving": serving, "training": training, "depth": depth, "card": smi}


def engine_serving(full, seed, smi, kernels, tag):
    """``Engine(max_slots=8, max_len=2048)`` on ``full`` serves 8 requests of
    200-1000 prompt tokens from ``seed``, 32 new each, the kernels' counts
    set to 0 just before and read just after: every request finishes and
    all three kernels launch."""
    from repro_torch.serving.engine import Engine, EngineConfig

    arch = full.name
    rng = np.random.default_rng(seed + 8)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(full, engine_cfg=EngineConfig(max_slots=8, max_len=2048), seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng.submit(rng.integers(0, full.vocab_size, 300).astype(np.int32), 4)  # warm-up, not counted
    eng.drain(max_steps=50)
    eng.reset_stats()
    plens = rng.integers(200, 1001, 8)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    for n in plens:
        eng.submit(rng.integers(0, full.vocab_size, int(n)).astype(np.int32), 32)
    fins = eng.drain(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = {name: k.launches for name, k in kernels.items()}
    st = engine_stats(eng)
    if len(fins) != 8 or any(f.finish_reason != "length" or len(f.tokens) != 32 for f in fins):
        raise AssertionError(f"{arch}: not every request finished with 32 tokens: "
                             f"{[(f.finish_reason, len(f.tokens)) for f in fins]}")
    if any(not (0 <= t < full.vocab_size) for f in fins for t in f.tokens):
        raise AssertionError(f"{arch}: token id out of the vocabulary")
    for name, n in serve_launches.items():
        if n <= 0:
            raise AssertionError(f"{arch}: kernel {name} was never launched in serving")
    steps = st["decode_step_s"]
    serving = {
        "weights_s": init_s,
        "requests": len(fins),
        "prompt_tokens": int(plens.sum()),
        "wall_s": wall,
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "decode_tok_s": st["decode_tokens"] / sum(steps),
        "decode_step_ms_p50": 1e3 * p50(steps),
        "ttft_ms_p50": 1e3 * p50(st["ttft_s"]),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": serve_launches,
    }
    del eng, fins
    log(f"[{tag}] {arch} sparse, full width: served 8 requests ({int(plens.sum())} prompt tokens, 32 new each) in "
        f"{wall:.2f} s on {smi}: decode {serving['decode_tok_s']:.1f} tok/s, step p50 "
        f"{serving['decode_step_ms_p50']:.2f} ms, prefill {serving['prefill_tok_s']:.0f} tok/s, TTFT p50 "
        f"{serving['ttft_ms_p50']:.1f} ms, peak memory {serving['max_memory_allocated_gb']:.2f} GB; launches "
        f"{serve_launches}")
    return serving


def trainer_steps(full, seed, smi, kernels, tag, traced=False, must_launch=("bsr_matmul", "block_sparse_attention"),
                  profile=False):
    """A ``Trainer`` on ``full`` takes 1 warm-up and 2 timed steps at B = 4,
    S = 2048 (on ``EmbedsWrapper`` batches for a backbone that reads
    embeddings; at B = 2 if B = 4 runs out of memory or peaks above 72 GB,
    and the report says so), the kernels' counts set to 0 just before the
    timed steps and read just after: each of ``must_launch`` must launch,
    loss and grad norm are finite. ``traced``: one more step traced on the
    device only gives the step's busy share; ``profile``: one more step
    profiled with its ranges."""
    import shutil

    from repro_torch.bench.common import device_trace
    from repro_torch.training.data import EmbedsWrapper, SyntheticLM
    from repro_torch.training.loop import TrainConfig, Trainer
    from repro_torch.training.optimizer import OptConfig

    arch = full.name
    s = 2048
    ckpt = ROOT / "build" / "chip_smoke_family_ckpt"
    fallback = None
    for b in (4, 2):
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        data = SyntheticLM(full.vocab_size, s, b, seed=seed)
        if not full.embed_inputs:
            data = EmbedsWrapper(data, full.d_model, n_pos_streams=len(full.mrope_sections))
        trainer = Trainer(full, OptConfig(lr=3e-4, warmup_steps=2, total_steps=100), data,
                          TrainConfig(ckpt_dir=str(ckpt), ckpt_every=10 ** 9, log_every=10 ** 9, seed=seed),
                          device="cuda")
        try:
            warm = trainer.run(1)
            for k in kernels.values():
                k.launches = 0
            hist = trainer.run(2)
        except torch.cuda.OutOfMemoryError as e:
            if b == 2:
                raise
            fallback = f"B=4 ran out of memory ({str(e).splitlines()[0]})"
        else:
            peak = torch.cuda.max_memory_allocated() / 1e9
            if peak <= 72.0 or b == 2:
                break
            fallback = f"B=4 peaked at {peak:.2f} GB, above 72 GB"
        del trainer
        log(f"[{tag}] {arch}: {fallback}; training at B=2")
    train_launches = {name: k.launches for name, k in kernels.items()}
    for h in warm + hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"{arch} training step {h['step']}: loss {h['loss']}, grad_norm {h['grad_norm']}")
    for name in must_launch:
        if train_launches[name] <= 0:
            raise AssertionError(f"{arch}: kernel {name} was never launched in the training steps")
    step_ms = [1e3 * h["step_time_s"] for h in hist]
    med = statistics.median(step_ms)
    training = {
        "shape": f"B={b} S={s}",
        "parameters": trainer.model.n_params,
        "loss": [h["loss"] for h in warm + hist],
        "grad_norm": [h["grad_norm"] for h in warm + hist],
        "step_ms": step_ms,
        "step_ms_median": med,
        "train_tok_s": b * s / (med / 1e3),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": train_launches,
        "batch_fallback": fallback,
    }
    if traced:
        tr = device_trace(lambda: trainer.run(1))
        training["device_trace"] = {k: tr[k] for k in ("window_ms", "device_busy_ms", "device_idle_share", "top")}
        busy = ("the profiler recorded no device time: busy share not measured" if tr["device_busy_ms"] is None
                else f"device busy {tr['device_busy_ms']:.1f} ms, idle share {tr['device_idle_share']:.3f}")
        log(f"[{tag}] {arch} one more step traced on the device: {tr['window_ms']:.1f} ms, {busy}")
        for name, ms, n in tr["top"][:6]:
            log(f"[{tag}]   {ms:8.3f} ms  x{n:<5d} {name}")
    if profile:
        training["profiled_step"] = profiled(f"{arch}: one full-width training step (B={b}, S={s})",
                                             lambda: trainer.run(1), tag=tag)
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[{tag}] {arch} sparse, full width: Trainer B={b} S={s}: steps {', '.join(f'{x:.1f}' for x in step_ms)} ms "
        f"(median {med:.1f} ms, {training['train_tok_s']:.0f} train tokens/s), losses "
        f"{', '.join(f'{x:.4f}' for x in training['loss'])}, grad norms "
        f"{', '.join(f'{x:.3f}' for x in training['grad_norm'])}, peak memory "
        f"{training['max_memory_allocated_gb']:.2f} GB; launches {train_launches}")
    return training


def dense_vs_pixelfly(seed):
    """(d) ``repro_torch.bench.lm_speedup`` for qwen3-1.7b at B = 4 and
    smollm-360m at B = 8, S = 2048: the dense model and its pixelfly twin,
    2 warm-up, 3 timed and 1 device-traced step each."""
    from repro_torch.bench import lm_speedup

    out = {}
    for arch, b in (("qwen3-1.7b", 4), ("smollm-360m", 8)):
        res = lm_speedup.compare(arch, batch=b, seq=2048, steps=3, seed=seed, device="cuda")
        out[arch] = res
        for arm in ("dense", "sparse"):
            a = res[arm]
            tr = a["device_trace"]
            busy = ("the profiler recorded no device time: busy share not measured" if tr["device_busy_ms"] is None
                    else f"device busy {tr['device_busy_ms']:.1f} ms, idle share {tr['device_idle_share']:.3f}")
            log(f"[8d] {arch} {arm}, B={b} S=2048: {a['parameters'] / 1e6:.1f} M parameters, step "
                f"{', '.join(f'{x:.1f}' for x in a['step_ms'])} ms (median {a['step_ms_median']:.1f} ms, "
                f"{a['train_tok_s']:.0f} train tokens/s), loss (last 5) {a['loss_last5_mean']:.4f}, peak memory "
                f"{a['max_memory_allocated_gb']:.2f} GB; traced step {tr['window_ms']:.1f} ms, {busy}")
            for name, ms, n in tr["top"][:6]:
                log(f"[8d]   {ms:8.3f} ms  x{n:<5d} {name}")
        log(f"[8d] {arch}: dense {res['dense']['step_ms_median']:.1f} ms, pixelfly {res['sparse']['step_ms_median']:.1f} "
            f"ms a step: speedup {res['speedup']:.3f}x, parameter ratio {res['param_ratio']:.3f} ({res['card']})")
    return out


# ----------------------------------------------------------------------
# phase 9: the serve CLI, the Server oracle, and what observability costs
# ----------------------------------------------------------------------

CLI_FULL = ["--arch", "qwen3-1.7b", "--sparse"]


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def serve_cli_full_width(full, kernels, smi):
    """(a) ``repro_torch.launch.serve.main`` at full width with every
    observability output on, while a thread scrapes the four routes. The
    kernels' counts are set to 0 just before and read just after."""
    import shutil
    import threading
    import urllib.error

    from repro_torch.launch import serve
    from repro_torch.obs import validate_trace_file
    from repro_torch.obs.prom import parse

    out_dir = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    trace, prom, flight = out_dir / "trace.json", out_dir / "metrics.prom", out_dir / "incidents"
    argv = CLI_FULL + [
        "--batch", "24", "--slots", "8", "--prompt-len", "512", "--gen", "64",
        "--prefix-cache", "--shared-prefix", "256", "--temperature", "0.7", "--top-p", "0.9",
        "--deadline", "60", "--slo-target", "0.99", "--monitor", "30",
        "--trace-out", str(trace), "--metrics-out", str(prom), "--flight-dir", str(flight),
        "--listen", "127.0.0.1:0",
    ]
    statuses = {r: [] for r in ("/metrics", "/healthz", "/vars", "/slo")}
    errors, threads = [], []
    real_listen = serve._maybe_listen

    def scrape(url, engine):
        # host objects only: the registry, the window and the SLO monitor
        while not engine.scheduler.idle:
            for route in statuses:
                try:
                    code, body = _get(url + route)
                except (urllib.error.URLError, ConnectionError) as e:
                    if not engine.scheduler.idle:  # the server stops after the drain
                        errors.append(f"{route}: {e!r}")
                    return
                statuses[route].append(code)
                if route == "/metrics":
                    parse(body)
                elif route != "/healthz":
                    json.loads(body)
            time.sleep(0.25)

    def listen_and_scrape(engine, args):
        srv = real_listen(engine, args)
        t = threading.Thread(target=scrape, args=(srv.url, engine), daemon=True)
        t.start()
        threads.append(t)
        return srv

    for k in kernels.values():
        k.launches = 0
    serve._maybe_listen = listen_and_scrape
    try:
        t0 = time.perf_counter()
        served = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serve._maybe_listen = real_listen
        for t in threads:
            t.join(timeout=60)
    launches = {name: k.launches for name, k in kernels.items()}
    eng = served.engine
    s = eng.stats_summary()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"scrape thread: {errors}")
    if not all(codes and set(codes) == {200} for codes in statuses.values()):
        raise AssertionError(f"not every route answered 200: {statuses}")
    rep = validate_trace_file(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    tracks = {(e["pid"], e["tid"]): e["args"]["name"] for e in events if e["ph"] == "M"}
    ends = collections.Counter(
        (tracks[(e["pid"], e["tid"])], e["name"]) for e in events if e["ph"] == "E"
    )
    if ends[("engine:decode", "decode_step")] != s["decode_steps"] or \
            ends[("engine:prefill", "prefill")] != s["prefill_calls"]:
        raise AssertionError(f"trace spans {ends} disagree with decode steps {s['decode_steps']}, "
                             f"prefill calls {s['prefill_calls']}")
    got = parse(prom.read_text())
    pairs = {
        "repro_serve_requests_finished_total": s["requests_finished"],
        "repro_serve_generated_tokens_total": s["generated_tokens"],
        "repro_serve_decode_steps_total": s["decode_steps"],
        "repro_serve_prefill_tokens_total": s["prefill_tokens"],
        "repro_serve_step_latency_seconds_count": s["decode_steps"],
        "repro_serve_host_syncs_total": s["dispatch_guard"]["host_syncs"],
        "repro_serve_prefix_hit_tokens_total": s["prefix_cache"]["hit_tokens"],
        "repro_serve_slo_met_total": s["slo"]["met"],
    }
    wrong = {k: (got.get(k), v) for k, v in pairs.items() if got.get(k) != v}
    if wrong:
        raise AssertionError(f"Prometheus snapshot disagrees with stats_summary(): {wrong}")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in itertools.chain(eng.model.parameters(), eng.model.buffers()))
    in_use = eng.metrics["repro_mem_device_bytes_in_use"].value
    if in_use < param_bytes + eng.kv.memory_bytes():
        raise AssertionError(f"device_bytes_in_use {in_use} below parameters {param_bytes} + "
                             f"KV pool {eng.kv.memory_bytes()}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched through the serve CLI")
    if len(served.tokens) != 24 or any(len(t) != 64 for t in served.tokens):
        raise AssertionError(f"not every request finished with 64 tokens: {[len(t) for t in served.tokens]}")
    out = {
        "argv": " ".join(argv),
        "wall_s": wall,
        "drain_s": served.wall_s,
        "served_tok_s": sum(len(t) for t in served.tokens) / served.wall_s,
        "decode_steps": s["decode_steps"],
        "prefill_calls": s["prefill_calls"],
        "decode_step_ms": {"p50": s["p50_token_latency_ms"], "p95": s["p95_token_latency_ms"]},
        "ttft_ms_p95": s["ttft_ms"]["p95_ms"],
        "prefix_hit_rate": s["prefix_cache"]["hit_rate"],
        "slo_attainment": s["slo"]["attainment"],
        "slo_state": eng.slo_state()["state"],
        "bundles": serve.incident_kinds(eng),
        "trace": rep,
        "scrapes": {r: len(c) for r, c in statuses.items()},
        "device_bytes_in_use": in_use,
        "param_bytes": param_bytes,
        "kv_bytes": eng.kv.memory_bytes(),
        "step_compiles": s["dispatch_guard"]["step_compiles"],
        "launches": launches,
        "card": smi,
    }
    del served, eng
    torch.cuda.empty_cache()
    log(f"[9a] serve CLI, full-width qwen3-1.7b sparse (24 requests, prompt 512 with a 256-token shared "
        f"prefix, 64 new, temperature 0.7, top-p 0.9, 8 slots) on {smi}: served {out['served_tok_s']:.1f} "
        f"tok/s over the {out['drain_s']:.2f} s drain ({out['wall_s']:.2f} s with the build), decode step "
        f"p50 {out['decode_step_ms']['p50']:.2f} ms p95 {out['decode_step_ms']['p95']:.2f} ms, TTFT p95 "
        f"{out['ttft_ms_p95']:.1f} ms, prefix hit rate {out['prefix_hit_rate']:.4f}, SLO attainment "
        f"{out['slo_attainment']:.4f}, burn-rate state {out['slo_state']}, bundles {out['bundles']}")
    log(f"[9a] trace {rep}; scrapes {out['scrapes']} all 200; device bytes in use {in_use / 1e9:.3f} GB "
        f">= parameters {param_bytes / 1e9:.3f} GB + KV pool {out['kv_bytes'] / 1e9:.3f} GB; step "
        f"compiles {out['step_compiles']}; launches {launches}")
    return out


def legacy_server(kernels, smi):
    """(b) ``--legacy-server``: at smoke width (fp32) its grid equals the
    engine's on the card; at full width (8 x prompt 128 x 16 new) it runs
    ``bsr_matmul``, and the share of tokens equal to the engine's is
    reported (bf16 argmax ties may part)."""
    from repro_torch.launch import serve

    smoke = ["--arch", "qwen3-1.7b", "--sparse", "--smoke", "--batch", "4", "--prompt-len", "32",
             "--gen", "16"]
    eng_grid = np.stack(serve.main(smoke).tokens)
    legacy_grid = np.stack(serve.main(smoke + ["--legacy-server"]).tokens)
    if not np.array_equal(eng_grid, legacy_grid):
        raise AssertionError(f"smoke legacy grid differs from the engine's:\n{legacy_grid}\n{eng_grid}")
    full = CLI_FULL + ["--batch", "8", "--prompt-len", "128", "--gen", "16"]
    for k in kernels.values():
        k.launches = 0
    legacy = serve.main(full + ["--legacy-server"])
    launches = {name: k.launches for name, k in kernels.items()}
    if launches["bsr_matmul"] <= 0:
        raise AssertionError("bsr_matmul was never launched by the full-width Server")
    engine = serve.main(full)
    a, b = np.stack(legacy.tokens), np.stack(engine.tokens)
    del engine
    torch.cuda.empty_cache()
    out = {"smoke_grids_equal": True, "full_equal_share": float((a == b).mean()),
           "full_first_token_equal_share": float((a[:, 0] == b[:, 0]).mean()),
           "server_generate_s": legacy.wall_s, "server_tok_s": a.size / legacy.wall_s,
           "launches": launches, "card": smi}
    log(f"[9b] --legacy-server: smoke-width fp32 grid (4 x 16) equal to the engine's on the card; full width "
        f"8 x 16 tokens in {legacy.wall_s:.2f} s ({out['server_tok_s']:.1f} tok/s), equal to the engine's "
        f"on {out['full_equal_share']:.3f} of tokens ({out['full_first_token_equal_share']:.3f} of first "
        f"tokens; reported, not gated); launches {launches}")
    return out


def observability_cost(full, seed, smi):
    """(c) Two full-width engines on one state dict, one with trace,
    monitor, SLO and flight recorder on, the other bare, serve the same 8
    greedy requests (prompt 256, 32 new) in turns off, on, on, off. Per
    turn: decode-step p50; on the traced engine: host us per
    ``_observe_step`` and the p50 of host_sync's share of decode_step from
    its trace; and the tracer's ns per event. (d) uses the traced engine."""
    from repro_torch.obs import SloConfig, Tracer
    from repro_torch.serving.engine import Engine, EngineConfig

    flight = ROOT / "build" / "chip_smoke_obs" / "incidents"
    obs = dict(trace=True, monitor=30.0, slo=SloConfig(target=0.99), flight_dir=str(flight))
    engines = {False: Engine(full, engine_cfg=EngineConfig(max_slots=8, max_len=2048), seed=seed,
                             device="cuda")}
    engines[True] = Engine(full, engine_cfg=EngineConfig(max_slots=8, max_len=2048, **obs),
                           params=engines[False].model.state_dict(), device="cuda")
    observe = {"n": 0, "s": 0.0}
    on_eng = engines[True]
    real_observe = on_eng._observe_step

    def timed_observe(*a):
        t0 = time.perf_counter()
        real_observe(*a)
        observe["s"] += time.perf_counter() - t0
        observe["n"] += 1

    on_eng._observe_step = timed_observe
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, full.vocab_size, 256).astype(np.int32) for _ in range(8)]
    for eng in engines.values():  # warm-up, not counted
        eng.submit(prompts[0], 4)
        eng.drain(max_steps=50)
    turns = []
    for on in (False, True, True, False):
        eng = engines[on]
        eng.reset_stats()
        observe.update(n=0, s=0.0)
        for p in prompts:
            eng.submit(p, 32)
        eng.drain(max_steps=200)
        turn = {"traced": on, "decode_step_ms_p50": eng.stats_summary()["p50_token_latency_ms"]}
        if on:
            turn["observe_step_us"] = 1e6 * observe["s"] / observe["n"]
            ev = eng.tracer.events()
            begins = {}
            spans = {"decode_step": [], "host_sync": []}
            for e in ev:
                if e["name"] in spans:
                    if e["kind"] == 0:
                        begins[e["name"]] = e["ts_ns"]
                    elif e["kind"] == 1:
                        spans[e["name"]].append(e["ts_ns"] - begins.pop(e["name"]))
            shares = [h / d for h, d in zip(spans["host_sync"], spans["decode_step"])]
            turn["host_sync_share_p50"] = statistics.median(shares)
            turn["trace_events"] = eng.tracer.n_recorded
        turns.append(turn)
    tr = Tracer(capacity=1 << 16)
    tk, nm = tr.track("t"), tr.name("n")
    n = 200_000
    t0 = time.perf_counter_ns()
    for i in range(n):
        tr.instant(tk, nm, i)
    instant_ns = (time.perf_counter_ns() - t0) / n
    t0 = time.perf_counter_ns()
    for i in range(n // 2):
        tr.begin(tk, nm, i)
        tr.end(tk, nm, i)
    span_ns = (time.perf_counter_ns() - t0) / n
    del engines[False]
    torch.cuda.empty_cache()
    out = {"turns": turns, "tracer_ns_per_instant": instant_ns, "tracer_ns_per_span_event": span_ns,
           "card": smi}
    log(f"[9c] observability cost, 8 greedy requests (prompt 256, 32 new), on {smi}: decode step p50 "
        + " / ".join(f"{t['decode_step_ms_p50']:.2f} ms ({'on' if t['traced'] else 'off'})" for t in turns)
        + "; _observe_step " + " / ".join(f"{t['observe_step_us']:.1f}" for t in turns if t["traced"])
        + f" us; tracer {instant_ns:.0f} ns per instant, {span_ns:.0f} ns per B/E event; host_sync / "
        f"decode_step p50 " + " / ".join(f"{t['host_sync_share_p50']:.3f}" for t in turns if t["traced"]))
    return out, on_eng


def burst_replay(full, eng, step_s, smi):
    """(d) A ``poisson_burst`` trace replayed through the traced, monitored
    engine: 8 background requests fill the slots, then 4 priority-5
    requests with a deadline of 24 steps land; ``step_s`` turns steps
    into seconds. Prints goodput and the SLO state after each step."""
    from repro_torch.serving import workloads

    items = workloads.poisson_burst(
        np.random.default_rng(10), vocab=full.vocab_size, page=full.attn_block, n_background=8,
        n_burst=4, burst_step=8, background_gen=64, burst_gen=8, deadline_steps=24,
    )
    eng.reset_stats()
    trail = []
    real_step = eng.step

    def step():
        fins = real_step()
        trail.append(eng.slo_state()["state"])
        return fins

    eng.step = step
    fins, wall, steps = workloads.replay(eng, items, step_s=step_s)
    eng.step = real_step
    g = workloads.goodput(fins, eng.stats_summary())
    runs = [[k, len(list(grp))] for k, grp in itertools.groupby(trail)]
    if len(fins) != len(items):
        raise AssertionError(f"replay finished {len(fins)} of {len(items)} requests")
    out = {"goodput": g, "wall_s": wall, "steps": steps, "step_s": step_s, "slo_trail": runs, "card": smi}
    log(f"[9d] poisson_burst replay ({len(items)} requests, {steps} steps, {wall:.2f} s, step_s "
        f"{step_s * 1e3:.1f} ms) on {smi}: goodput {g}; SLO state trail {runs}")
    return out



# ----------------------------------------------------------------------
# phase 10: vision, the paper's other benchmarks, bsr_matmul at b = 8, 16, 32
# ----------------------------------------------------------------------

def small_block_linears():
    """{block: ({label: spec}, Ms)} of the sparse linears at each new block,
    built from the configs that run them: ViT-B/16's four at b = 32 and
    the B/16 training M (128 x 197 rows); the ablation example's at b = 16
    and its M (8 x 64); ViT-B/16's MLP at block 8 (where the block halves
    that far) at the B/16 M. Each is checked at M in {1, 8, 16, 17} too."""
    import dataclasses

    from repro_torch.bench import vision_speedup as VS
    from repro_torch.examples import sparsity_ablation as SA
    from repro_torch.models.layers import linear_spec

    vit = VS.b16_config("vit", True)
    d, f = vit.d_model, vit.d_ff
    vit8 = dataclasses.replace(vit, sparse_block=8)
    ab = SA.config(0.4, 0.25)
    vit_m, ab_m = VS.BATCH["b16"] * (vit.num_patches + 1), SA.BATCH * SA.SEQ
    return {
        32: ({"qkv": vit.lin(d, 3 * d), "proj": vit.lin(d, d), "fc1": vit.lin(d, f), "fc2": vit.lin(f, d)},
             (1, 8, 16, 17, vit_m)),
        16: ({label: linear_spec(ab, n_in, n_out, False) for label, (n_in, n_out) in
              {"q/o": (ab.d_model, ab.q_dim), "k/v": (ab.d_model, ab.kv_dim), "gate/up": (ab.d_model, ab.d_ff),
               "down": (ab.d_ff, ab.d_model)}.items()},
             (1, 8, 16, 17, ab_m)),
        8: ({"fc1": vit8.lin(d, f), "fc2": vit8.lin(f, d)}, (1, 8, 16, 17, vit_m)),
    }


def small_block_kernels(timer, seed):
    """(a) ``bsr_matmul`` at b = 32, 16 and 8 against its plain version on
    the card, fp32 (1e-4) and bf16 (2e-2), at M in {1, 8, 16, 17} and the
    path's M (ViT-B/16 training: 128 x 197 rows; the ablation: 8 x 64):
    each linear's forward, and its dX (the kernel on the transposed
    pattern, as ``BsrMatmul`` runs it). bf16 at b = 16, 32 and M > 16 is the
    tensor-core kernel; the rest at these blocks is SIMT. The rows at
    M = 8 and the path's M are timed."""
    from repro_torch.kernels import autograd as AG

    rows = []
    for block, (specs, ms) in small_block_linears().items():
        for label, spec in specs.items():
            n_in, n_out = spec.in_features, spec.out_features
            pat = spec.pattern()
            if pat.block != block:
                raise AssertionError(f"{label}: LinearSpec gave block {pat.block}, not {block}")
            tables = AG.bsr_tables(pat.cols, pat.nb_in, "cuda")
            gen = torch.Generator(device="cuda").manual_seed(seed + block)
            w32 = torch.randn((pat.nb_out, pat.r, block, block), generator=gen, device="cuda") / math.sqrt(pat.r * block)
            for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
                blocks = w32.to(dtype)
                bt = AG.transposed_blocks(blocks, tables)
                for m in ms:
                    x = torch.randn((m, n_in), generator=gen, device="cuda").to(dtype)
                    dy = torch.randn((m, n_out), generator=gen, device="cuda").to(dtype)
                    for kind, args in (("forward", (x, blocks, tables.cols, n_in)),
                                       ("dX", (dy, bt, tables.cols_t, n_out))):
                        row = bsr_row(timer, *args, pat.nb_out * pat.r, tol, f"b{block} {label} {kind}",
                                      timed=m in (8, ms[-1]))
                        row.update({"block": block, "linear": label, "pass": kind, "m": m})
                        rows.append(row)
                        if "ms" in row:
                            log(f"[10a] bsr_matmul {row['case']:22s} {row['dtype']:8s} {row['shape']}: err "
                                f"{row['max_abs_err']:.2e} (tol {tol:g}) kernel {row['ms']:.4f} ms plain "
                                f"{row['plain_ms']:.4f} ms x@dense {row['library_ms']:.4f} ms bound "
                                f"{row['bound_ms']:.4f} ms ({row['bound_by']}) digest {row['out_sha256']}")
    log(f"[10a] bsr_matmul at b = 32, 16, 8: {len(rows)} calls within tolerance of the plain version")
    return rows


def vision_smoke(seed):
    """(b) ViT and Mixer at the JAX script's bench width, sparse, fp32: the
    same seeded weights (a random head for the ViT, whose own starts at
    zero) and data on the CPU and the card; the logits within 1e-4, every
    parameter's gradient within 1e-4 of its largest entry, then one SGD
    step's loss within 1e-5 relative and every parameter after it within
    1e-6 (the tolerances of the CPU tests and the card tests)."""
    from repro_torch.bench import vision_speedup as VS
    from repro_torch.models import vision as V

    out = {}
    for kind in ("vit", "mixer"):
        cfg = VS.bench_config(kind, True)
        cpu = V.init_vision(cfg, seed=seed, device="cpu")
        if kind == "vit":
            with torch.no_grad():
                cpu.head.w.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(seed))
        card = V.init_vision(cfg, device="cuda", params=cpu.state_dict())
        (xc, yc), (xg, yg) = (VS.make_data(cfg, 8, seed, torch.device(d)) for d in ("cpu", "cuda"))
        logits, grads = {}, {}
        for name, model, x, y in (("cpu", cpu, xc, yc), ("card", card, xg, yg)):
            lg = model(x)
            grads[name] = torch.autograd.grad(torch.nn.functional.cross_entropy(lg, y), list(model.parameters()))
            logits[name] = lg.detach().cpu()
        err = check_close(f"{kind} smoke logits", logits["card"], logits["cpu"], 1e-4)
        grad_err = 0.0
        for pname, gg, gc in zip(dict(cpu.named_parameters()), grads["card"], grads["cpu"]):
            rel = (gg.cpu() - gc).abs().max().item() / gc.abs().max().item()
            if not rel <= 1e-4:
                raise AssertionError(f"{kind} smoke gradient of {pname}: card differs by {rel:.3e} "
                                     "of its largest entry")
            grad_err = max(grad_err, rel)
        loss_c, loss_g = float(VS.sgd_step(cpu, xc, yc)), float(VS.sgd_step(card, xg, yg))
        if not abs(loss_g - loss_c) <= 1e-5 * abs(loss_c):
            raise AssertionError(f"{kind} smoke loss: card {loss_g} cpu {loss_c}")
        sd = card.state_dict()
        worst = max((sd[k].cpu() - v).abs().max().item() for k, v in cpu.state_dict().items())
        if not worst <= 1e-6:
            raise AssertionError(f"{kind} smoke SGD step: parameters differ by {worst:.3e}")
        out[kind] = {"logits_max_abs_err": err, "grads_max_rel_err": grad_err, "loss_cpu": loss_c,
                     "loss_card": loss_g, "params_max_abs_err": worst}
        log(f"[10b] {kind} bench width, sparse fp32: card logits within {err:.2e} of the CPU's, gradients within "
            f"{grad_err:.2e} of their largest entries, SGD step loss {loss_g:.6f} (CPU {loss_c:.6f}), "
            f"parameters within {worst:.2e}")
    return out


def vision_b16(seed, smi, kernels):
    """(c) ``repro_torch.bench.vision_speedup`` at the B/16 widths, bf16,
    B = 128: dense and pixelfly ViT and Mixer, 2 warm-up, 3 timed and 1
    device-traced step each, with every kernel's count set to 0 just before
    and read just after. The losses must be finite, and the pixelfly arm
    must launch ``bsr_matmul`` twice a step for each of its sparse linears
    (the forward and the dX of every one)."""
    from repro_torch.bench import vision_speedup as VS

    for k in kernels.values():
        k.launches = 0
    out = {kind: VS.compare(kind, width="b16", batch=VS.BATCH["b16"], steps=3, warmup=2, seed=seed, device="cuda")
           for kind in ("vit", "mixer")}
    out["launches"] = {name: k.launches for name, k in kernels.items()}
    for kind in ("vit", "mixer"):
        res = out[kind]
        for arm in ("dense", "sparse"):
            a = res[arm]
            if not np.isfinite(a["loss"]).all():
                raise AssertionError(f"{kind} B/16 {arm}: loss not finite: {a['loss']}")
            tr = a["device_trace"]
            busy = ("the profiler recorded no device time: busy share not measured" if tr["device_busy_ms"] is None
                    else f"device busy {tr['device_busy_ms']:.1f} ms, idle share {tr['device_idle_share']:.3f}")
            log(f"[10c] {kind}-B/16 {arm}, B=128 bf16: {a['parameters'] / 1e6:.2f} M parameters, step "
                f"{', '.join(f'{x:.1f}' for x in a['step_ms'])} ms (median {a['step_ms_median']:.1f} ms, "
                f"{a['images_s']:.0f} images/s), loss {a['loss'][0]:.4f} -> {a['loss'][-1]:.4f}, peak memory "
                f"{a['max_memory_allocated_gb']:.2f} GB, bsr_matmul {a['bsr_matmul_launches_per_step']:.0f} "
                f"launches a step; traced step {tr['window_ms']:.1f} ms, {busy}")
            for name, ms, n in tr["top"][:6]:
                log(f"[10c]   {ms:8.3f} ms  x{n:<5d} {name}")
        sp = res["sparse"]
        if sp["bsr_matmul_launches_per_step"] != 2 * sp["sparse_linears"]:
            raise AssertionError(f"{kind} B/16 pixelfly: {sp['bsr_matmul_launches_per_step']} bsr_matmul launches "
                                 f"a step for {sp['sparse_linears']} sparse linears (want 2 each)")
        log(f"[10c] {kind}-B/16: dense {res['dense']['step_ms_median']:.1f} ms, pixelfly "
            f"{sp['step_ms_median']:.1f} ms a step: speedup {res['speedup']:.3f}x, parameter ratio "
            f"{res['param_ratio']:.3f} ({smi})")
    if out["launches"]["bsr_matmul"] <= 0:
        raise AssertionError("bsr_matmul was never launched on the vision path")
    return out


def vision_benches(seed):
    """(d) The paper's other benchmarks at their defaults on the card:
    flat vs product, the block microbenchmark, LRA attention (each kernel
    arm also held against its plain version), and the NTK distances (the
    card's within 1e-5 of the CPU's)."""
    from repro_torch.bench import block_microbench, flat_vs_product, lra_attention, ntk_distance
    from repro_torch.kernels import ops, ref

    out = {}
    dev = torch.device("cuda")
    x, arms = flat_vs_product.inputs(1024, 32, 512, dev)
    for k, _, blocks, cols in arms:
        check_close(f"flat_vs_product k={k}", ops.bsr_matmul(x, blocks, cols),
                    ref.bsr_matmul_gather(x, blocks, cols), 1e-4)
    out["flat_vs_product"] = flat_vs_product.run(device=dev)
    for r in out["flat_vs_product"]["rows"]:
        log(f"[10d] flat_vs_product k={r['max_stride']} (n=1024, b=32, batch 512, fp32): flat {r['flat_ms']:.4f} ms "
            f"(r = {r['r']}), product {r['product_ms']:.4f} ms ({r['factors']} factors), speedup {r['speedup']:.2f}x")
    out["block_microbench"] = mb = block_microbench.run(device=dev)
    for r in mb["densities"]:
        log(f"[10d] block_microbench {r['pattern']} b={r['block']}: expected density {r['expected_density']:.4f}, "
            f"actual (32-block cover) {r['actual_density']:.4f}")
    lat = mb["latency"]
    log(f"[10d] block_microbench latency (n=4096, b=32, batch 256, fp32, density {lat['density']:.4f}): bsr "
        f"{lat['bsr_ms']:.4f} ms, x @ w {lat['dense_ms']:.4f} ms, bsr speedup {lat['bsr_speedup']:.2f}x")
    q, k, v = lra_attention.inputs(1024, np.random.default_rng(seed), dev, torch.bfloat16)
    _, sched = lra_attention.schedule(1024)
    kv_index, valid = (torch.as_tensor(a, device=dev) for a in (sched.kv_index, sched.valid))
    check_close("lra_attention sparse S=1024", lra_attention.sparse(q, k, v, kv_index, valid),
                ref.sparse_attention(q, k, v, kv_index, valid, block=lra_attention.BLOCK, causal=True,
                                     sm_scale=lra_attention.D ** -0.5), 2e-2)
    out["lra_attention"] = lra_attention.run(device=dev)
    for r in out["lra_attention"]["rows"]:
        log(f"[10d] lra_attention S={r['seq']} (B=2, H=4, D=64, block 128, causal, bf16): sparse kernel "
            f"{r['sparse_ms']:.4f} ms, flash SDPA {r['dense_ms']:.4f} ms, speedup {r['speedup']:.2f}x, "
            f"keys per query {r['keys_per_query']:.0f}/{r['seq']}")
    got, want = ntk_distance.run(seed, dev), ntk_distance.run(seed, "cpu")
    for name, d in want["rel_ntk_dist"].items():
        if not abs(got["rel_ntk_dist"][name] - d) <= 1e-5:
            raise AssertionError(f"ntk_distance {name}: card {got['rel_ntk_dist'][name]} cpu {d}")
    out["ntk_distance"] = got
    log("[10d] ntk_distance (card == CPU within 1e-5): " + ", ".join(
        f"{n} {v:.4f}" for n, v in sorted(got["rel_ntk_dist"].items(), key=lambda kv: kv[1]))
        + f"; closest to dense: {got['closest_to_dense']}")
    return out


def ablation_smoke(kernels):
    """(e) ``repro_torch.examples.sparsity_ablation --smoke`` on the card:
    the Trainer at linear block 16, attention block 64, with the kernels'
    counts set to 0 just before and read just after; bsr_matmul and
    block_sparse_attention must launch and the loss be finite."""
    from repro_torch.examples import sparsity_ablation

    for k in kernels.values():
        k.launches = 0
    rows = sparsity_ablation.main(["--smoke", "--device", "cuda"])
    launches = {name: k.launches for name, k in kernels.items()}
    if not (launches["bsr_matmul"] > 0 and launches["block_sparse_attention"] > 0):
        raise AssertionError(f"the ablation did not run both training kernels: {launches}")
    if not all(np.isfinite(r[2]) for r in rows):
        raise AssertionError(f"ablation loss not finite: {rows}")
    log(f"[10e] sparsity_ablation --smoke on the card (block 16): density {rows[0][0]}, split {rows[0][1]}, "
        f"loss {rows[0][2]:.4f}, {rows[0][3]} parameters; launches {launches}")
    return {"rows": rows, "launches": launches}


# ----------------------------------------------------------------------
# phase 11: the vlm and audio backbones, the serving bench twin, the example
# ----------------------------------------------------------------------

# the two backbones of phase 11 and the batch each trains at
VLM_AUDIO = {"qwen2-vl-7b": 4, "musicgen-large": 4}


def embeds_batch(cfg, b, s, seed):
    """``EmbedsWrapper``'s batch over seeded synthetic tokens; for M-RoPE,
    distinct t/h/w streams (the token index, and the row and column of an
    8-wide grid), so a wrong section split would show."""
    from repro_torch.training.data import EmbedsWrapper, SyntheticLM

    batch = EmbedsWrapper(SyntheticLM(cfg.vocab_size, s, b, seed=seed), cfg.d_model,
                          n_pos_streams=len(cfg.mrope_sections)).batch(0)
    if cfg.mrope_sections:
        t = np.arange(s, dtype=np.int32)
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(np.stack([t, t // 8, t % 8], -1), (b, s, 3)))
    return batch


def vlm_audio_smoke(seed):
    """(b) fp32 sparse smoke models of both backbones, the same seeded
    weights on both devices: equal greedy paged streams (token inputs) on
    the CPU and the card; ``forward_train`` on embeddings and position
    streams, loss within 1e-5 relative and every gradient within 1e-4 of
    its leaf's largest entry (the token table, which the loss does not
    reach, has none on either device); then one train step held as phase
    7b holds qwen3's."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    out = {}
    for arch in VLM_AUDIO:
        cfg = registry.get_smoke(arch, sparse=True)
        page = cfg.attn_block
        rng = np.random.default_rng(seed + 11)
        work = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
                for n in (9 * page + 20, 2 * page + 1, 40, 14 * page + 3)]
        got = {dev: smoke_greedy_streams(cfg, work, seed, dev) for dev in ("cpu", "cuda")}
        if got["cpu"] != got["cuda"]:
            raise AssertionError(f"{arch} smoke streams differ: cpu {got['cpu']} cuda {got['cuda']}")
        batch = embeds_batch(cfg, 2, 4 * page, seed)
        res = {}
        for dev in ("cpu", "cuda"):
            model = T.init_model(cfg, seed=seed, device=dev)
            named = dict(model.named_parameters())
            loss, _ = T.forward_train(cfg, model, batch)
            grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
            res[dev] = (loss.item(), {n: None if g is None else g.detach().cpu() for n, g in zip(named, grads)})
        (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
        if not abs(lg - lc) <= 1e-5 * abs(lc):
            raise AssertionError(f"{arch} smoke forward_train on embeddings: loss card {lg} cpu {lc}")
        worst = 0.0
        for n, g in gc.items():
            if (g is None) != (gg[n] is None):
                raise AssertionError(f"{arch} smoke gradient of {n}: present on one device only")
            if g is not None:
                worst = max(worst, ((gg[n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item())
        if worst > 1e-4:
            raise AssertionError(f"{arch} smoke gradients: worst relative error {worst:.2e} (tol 1e-4)")
        unused = sorted(n for n, g in gc.items() if g is None)
        log(f"[11b] {arch} smoke-width sparse fp32: CPU and card greedy streams equal over {len(work)} requests; "
            f"forward_train on embeddings and position streams: loss {lc:.6f} / {lg:.6f}, gradients within "
            f"{worst:.2e} of each leaf's largest entry; no gradient for {unused}")
        out[arch] = {"requests": len(work), "loss": [lc, lg], "grad_rel_err": worst, "unused": unused,
                     "train_step": smoke_step_cpu_vs_card(cfg, tag="11b", batch=embeds_batch(cfg, 4, 2 * page, seed))}
    return out


def serve_bench_full_width(kernels, smi):
    """(e) ``repro_torch.bench.serve_engine`` at full width on the card,
    three repeats (its own cuts are listed under ``config.reduced``): the
    overhead floors take the median of three paired ratios; its stream
    assertions must pass. The kernels'
    counts are set to 0 just before and read just after: all three must
    launch."""
    from repro_torch.bench import serve_engine

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = serve_engine.run(device="cuda", out=str(ROOT / "build" / "bench_serve_torch.json"))
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched by the serving benchmark")
    good, live = res["goodput"], res["observability_live"]
    log(f"[11e] bench.serve_engine, full-width qwen3-1.7b sparse, {wall:.1f} s on {smi}: uniform "
        f"{res['engine_uniform']['tok_s']} tok/s (decode {res['engine_uniform']['decode_tok_s']}), Server "
        f"{res['server']['tok_s']} tok/s (x{res['speedup_vs_server']}); prefill-heavy x{res['prefill_heavy_speedup']}; "
        f"sampled/greedy {res['decode_by_sampler']['sampled_vs_greedy']}; prefix admission "
        f"x{res['prefix_cache']['admission_speedup']} (hit rate {res['prefix_cache']['on']['hit_rate']}); burst SLO "
        f"{good['burst']['on']['slo_attainment']} on / {good['burst']['off']['slo_attainment']} off, long tail "
        f"{good['long_tail']['on']['slo_attainment']} / {good['long_tail']['off']['slo_attainment']}, chat turn 2+ hit "
        f"rate {good['chat']['turn2plus_hit_rate']}; traced/off {res['observability']['traced_vs_off']}, "
        f"monitored/off {live['monitored_vs_off']}; shed hi attainment {live['slo_shed']['on']['hi_attainment']} on / "
        f"{live['slo_shed']['off']['hi_attainment']} off; launches {launches}")
    log(f"[11e]   cuts: {json.dumps(res['config']['reduced'])}")
    return {"wall_s": wall, "launches": launches, "result": res}


def serve_example(kernels):
    """(f) ``repro_torch.examples.serve_lm`` on the card: six requests of
    four samplers, two of them late, each to its full length; the three
    kernels launch (counts set to 0 just before)."""
    from repro_torch.examples import serve_lm

    for k in kernels.values():
        k.launches = 0
    fins = serve_lm.main([])
    launches = {name: k.launches for name, k in kernels.items()}
    if [len(f.tokens) for f in fins] != [12, 6, 10, 8, 5, 9]:
        raise AssertionError(f"serve example: {[(f.finish_reason, len(f.tokens)) for f in fins]}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched by the serve example")
    log(f"[11f] examples.serve_lm on the card: {len(fins)} requests, {sum(len(f.tokens) for f in fins)} tokens; "
        f"launches {launches}")
    return {"requests": len(fins), "launches": launches}


# ----------------------------------------------------------------------
# phase 12: the MoE, SSM and hybrid families
# ----------------------------------------------------------------------

# the full-width models of phase 12 and the batch each trains at
MOE_SSM = {"deepseek-moe-16b": 4, "zamba2-2.7b": 4, "mamba2-130m": 4}


def moe_ssm_linears(full):
    """The distinct pixelfly linear shapes of one layer of each kind of
    ``full``: label -> LinearSpec, as the model builds them (attention and
    MLP linears through ``layers.linear_spec``, with the block halved where
    the width asks; the SSM's ``out_proj`` at the config's block, its
    ``in_proj`` dense)."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as ssm_lib

    c = full
    shapes = {}
    if c.num_heads:
        shapes["q/k/v/o" if c.q_dim == c.kv_dim == c.d_model else "q/o"] = (c.d_model, c.q_dim)
        if c.kv_dim != c.q_dim:
            shapes["k/v"] = (c.d_model, c.kv_dim)
    if c.family == "moe":
        shapes["dense gate/up"] = (c.d_model, c.moe_dense_ff)
        shapes["dense down"] = (c.moe_dense_ff, c.d_model)
        shared = c.moe_num_shared * c.moe_d_ff
        shapes["shared gate/up"] = (c.d_model, shared)
        shapes["shared down"] = (shared, c.d_model)
    elif c.family == "hybrid":
        shapes["gate/up"] = (c.d_model, c.d_ff)
        shapes["down"] = (c.d_ff, c.d_model)
    specs = {label: L.linear_spec(c, n_in, n_out, False) for label, (n_in, n_out) in shapes.items()}
    if c.family in ("ssm", "hybrid"):
        specs["out_proj"] = ssm_lib.SsmSpec(c).out_proj
    return specs


def moe_ssm_kernels(timer, seed):
    """(a) The three kernels at the new shapes against their plain versions,
    timed as in phase 8a: bsr_matmul forward at M = 8 and the training M
    (4 x 2048) and dX on each transposed pattern at the training M, for
    every linear shape of deepseek-moe-16b, zamba2-2.7b and mamba2-130m;
    bf16 attention at deepseek-moe (H = Hk = 16, D = 128) and zamba2
    (H = Hk = 32, D = 80), B = 1 and 4, S = 2048, with SDPA beside it; the
    paged decode read at deepseek-moe's heads. Then head dim 80 in fp32 at
    zamba2's B = 1 shape, and ``BlockSparseAttention``'s output and
    gradients (the kernel forward, the plain gradient backward) at D = 80
    in fp32 and bf16 against autograd of the plain version, the gradients
    relative to their largest entry."""
    from repro_torch.configs import registry
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L

    out = {"block_sparse_attention": [], "paged_decode_attention": [], "bsr_matmul": [], "bsr_matmul_dx": []}
    for arch, b_train in MOE_SSM.items():
        full = registry.get(arch, sparse=True)
        if full.num_heads:
            h, hk, d = full.num_heads, full.num_kv_heads, full.head_dim
            for b in (1, b_train):
                row = attention_case(timer, b=b, s=2048, h=h, hk=hk, d=d, block=full.attn_block,
                                     dtype=torch.bfloat16, seed=seed + b, tol=2e-2)
                out["block_sparse_attention"].append({"arch": arch, **row})
        if full.family == "moe":
            row = paged_case(timer, b=8, hk=full.num_kv_heads, g=full.num_heads // full.num_kv_heads,
                             d=full.head_dim, page=full.attn_block, pps=16, dtype=torch.bfloat16,
                             seed=seed + 9, tol=1e-2)
            out["paged_decode_attention"].append({"arch": arch, **row})
        m_train = b_train * 2048
        for label, spec in moe_ssm_linears(full).items():
            for m in (8, m_train):
                row = bsr_case(timer, spec, m, torch.bfloat16, seed=seed + m, tol=2e-2)
                out["bsr_matmul"].append({"arch": arch, "linear": label, **row})
            pat = spec.pattern()
            n_in, n_out = spec.in_features, spec.out_features
            tables = AG.bsr_tables(pat.cols, pat.nb_in, "cuda")
            g = torch.Generator(device="cuda").manual_seed(seed + n_out)
            x = torch.randn((m_train, n_in), generator=g, device="cuda").to(torch.bfloat16)
            blocks = (torch.randn((pat.nb_out, pat.r, pat.block, pat.block), generator=g, device="cuda")
                      / math.sqrt(pat.r * pat.block)).to(torch.bfloat16)
            dy = torch.randn((m_train, n_out), generator=g, device="cuda").to(torch.bfloat16)
            xr, br = x.clone().requires_grad_(), blocks.clone().requires_grad_()
            dx = torch.autograd.grad(AG.bsr_matmul(xr, br, tables), xr, dy)[0]
            dx_ref = torch.autograd.grad(ref.bsr_matmul_gather(xr, br, tables.cols), xr, dy)[0]
            err = check_close(f"{arch} {label} dX M={m_train}", dx, dx_ref, 2e-2)
            out["bsr_matmul_dx"].append({"arch": arch, "linear": label, "max_abs_err": err, "tol": 2e-2,
                                         **dx_case(timer, x, blocks, dy, tables, pat)})
    for r in out["block_sparse_attention"]:
        log(f"[12a] {r['arch']} block_sparse_attention bf16 {r['shape']}: err {r['max_abs_err']:.2e} (tol 2e-2) "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) digest {r['out_sha256']}")
    for r in out["paged_decode_attention"]:
        log(f"[12a] {r['arch']} paged_decode_attention bf16 {r['shape']}: err {r['max_abs_err']:.2e} (tol 1e-2) "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    for r in out["bsr_matmul"]:
        log(f"[12a] {r['arch']} bsr_matmul {r['linear']:14s} {r['shape']}: err {r['max_abs_err']:.2e} kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms x@dense {r['library_ms']:.4f} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for r in out["bsr_matmul_dx"]:
        log(f"[12a] {r['arch']} bsr_matmul {r['linear']:14s} {r['shape']}: err {r['max_abs_err']:.2e} kernel "
            f"{r['ms']:.4f} ms (+ transposed blocks {r['transpose_blocks_ms']:.4f} ms) plain {r['plain_ms']:.4f} ms "
            f"dy@W_dense^T {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"dBlocks {r['dblocks_ms']:.4f} ms")

    # head dim 80: fp32 (the SIMT kernel) at zamba2's B = 1 shape, untimed
    zamba = registry.get("zamba2-2.7b", sparse=True)
    q, k, v, kv_index, valid = attention_inputs(1, 2048, zamba.num_kv_heads, 1, zamba.head_dim, 128, seed)
    q, k, v = (t.float() for t in (q, k, v))
    kw = dict(block=128, causal=True, sm_scale=zamba.head_dim ** -0.5)
    from repro_torch.kernels.bsr_attention import block_sparse_attention_cuda

    got = block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw)
    torch.cuda.synchronize()
    b, s, h, d = q.shape
    want = ref.sparse_attention(q.reshape(b, s, h, 1, d), k, v, kv_index, valid, **kw).reshape(b, s, h, d)
    out["d80_fp32"] = {"shape": f"B=1 S=2048 H=32 Hk=32 D=80 block=128", "tol": 2e-4,
                       "max_abs_err": check_close("block_sparse_attention fp32 D=80", got, want, 2e-4)}
    log(f"[12a] block_sparse_attention fp32 {out['d80_fp32']['shape']}: err {out['d80_fp32']['max_abs_err']:.2e} "
        f"(tol 2e-4)")
    # BlockSparseAttention at D = 80: kernel forward, plain gradient backward
    out["d80_grads"] = []
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        gen = torch.Generator(device="cuda").manual_seed(seed + 80)
        shape = (1, 1024, 32, 1, 80)
        qg = torch.randn(shape, generator=gen, device="cuda").to(dtype).requires_grad_()
        kg, vg = (torch.randn((1, 1024, 32, 80), generator=gen, device="cuda").to(dtype).requires_grad_()
                  for _ in range(2))
        do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        kvi, vld = L._schedule_tensors(1024, 128, 2, 0, 1, "cuda")
        kw = dict(block=128, causal=True, sm_scale=80 ** -0.5)
        o = AG.block_sparse_attention(qg, kg, vg, kvi, vld, **kw)
        grads = torch.autograd.grad(o, (qg, kg, vg), do)
        o_ref = ref.sparse_attention(qg, kg, vg, kvi, vld, **kw)
        want = torch.autograd.grad(o_ref, (qg, kg, vg), do)
        err = check_close(f"BlockSparseAttention D=80 {dtype} output", o, o_ref, tol)
        rel = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item() for a, w in zip(grads, want))
        if not rel <= tol:
            raise AssertionError(f"BlockSparseAttention D=80 {dtype}: gradient error {rel:.2e} of the largest "
                                 f"entry, beyond {tol:g}")
        dt = str(dtype).split(".")[1]
        out["d80_grads"].append({"dtype": dt, "shape": "B=1 S=1024 H=Hk=32 D=80 block=128", "tol": tol,
                                 "max_abs_err": err, "grad_rel_err": rel})
        log(f"[12a] BlockSparseAttention {dt} B=1 S=1024 H=Hk=32 D=80: output err {err:.2e}, dq/dk/dv within "
            f"{rel:.2e} of their largest entry (tol {tol:g})")
    return out


def server_streams(cfg, prompts, gen, seed, device):
    """Greedy tokens of the fixed-batch ``Server`` (weights from ``seed``)."""
    from repro_torch.launch.serve import Server

    return Server(cfg, seed=seed, device=device).generate(prompts, gen)


def moe_ssm_smoke(seed):
    """(b) fp32 sparse smoke models of deepseek-moe-16b, kimi-k2-1t-a32b,
    mamba2-130m and zamba2-2.7b, the same seeded weights on both devices:
    equal greedy streams on the CPU and the card (the paged engine for the
    MoE two, ragged prompts whose padding reaches the router; the
    ``Server`` for the SSM two, which prefills them in one pass);
    then one train step each, held as phase 7b holds qwen3's."""
    from repro_torch.configs import registry

    out = {}
    for arch in ("deepseek-moe-16b", "kimi-k2-1t-a32b", "mamba2-130m", "zamba2-2.7b"):
        cfg = registry.get_smoke(arch, sparse=True)
        rng = np.random.default_rng(seed + 12)
        if cfg.family == "moe":
            page = cfg.attn_block
            work = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
                    for n in (9 * page + 20, 2 * page + 1, 40, 14 * page + 3)]
            got = {dev: smoke_greedy_streams(cfg, work, seed, dev) for dev in ("cpu", "cuda")}
            n_req = len(work)
        else:
            prompts = rng.integers(0, cfg.vocab_size, (3, 2 * 64 + 5)).astype(np.int32)
            got = {dev: server_streams(cfg, prompts, 8, seed, dev).tolist() for dev in ("cpu", "cuda")}
            n_req = len(prompts)
        if got["cpu"] != got["cuda"]:
            raise AssertionError(f"{arch} smoke streams differ: cpu {got['cpu']} cuda {got['cuda']}")
        log(f"[12b] {arch} smoke-width sparse fp32: CPU and card greedy streams equal over {n_req} requests "
            f"({'paged engine' if cfg.family == 'moe' else 'Server, one prefill pass'})")
        out[arch] = {"requests": n_req, "train_step": smoke_step_cpu_vs_card(cfg, tag="12b")}
    return out


def server_serving(full, seed, smi, kernels, tag, must_launch):
    """The fixed-batch ``Server`` on ``full`` greedily serves 8 prompts of
    1024 tokens from ``seed``, 32 new each, as the serve CLI builds and
    runs it (an SSM or hybrid config prefills in one pass); the kernels' counts set to 0 just before and read just after:
    each of ``must_launch`` must launch. Tokens in the vocabulary."""
    from repro_torch.launch.serve import Server

    arch = full.name
    rng = np.random.default_rng(seed + 12)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = Server(full, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv.generate(rng.integers(0, full.vocab_size, (8, 128)).astype(np.int32), 2)  # warm-up, not counted
    prompts = rng.integers(0, full.vocab_size, (8, 1024)).astype(np.int32)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = srv.generate(prompts, 32)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    if toks.shape != (8, 32) or not ((toks >= 0) & (toks < full.vocab_size)).all():
        raise AssertionError(f"{arch}: Server tokens of shape {toks.shape} or out of the vocabulary")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"{arch}: kernel {name} was never launched by the Server")
    serving = {"weights_s": init_s, "requests": 8, "prompt_tokens": int(prompts.size), "new_tokens": 32,
               "wall_s": wall, "tok_s": 8 * 32 / wall,
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
               "streams_sha256": digest(torch.as_tensor(toks.astype(np.int64)))}
    del srv
    log(f"[{tag}] {arch} sparse, full width: the Server served 8 prompts of 1024 tokens (one prefill pass), 32 new "
        f"each, in {wall:.2f} s on {smi} ({serving['tok_s']:.1f} new tok/s with the prefill), peak memory "
        f"{serving['max_memory_allocated_gb']:.2f} GB; launches {launches}")
    return serving


def moe_ssm_full_width(arch, seed, smi, kernels):
    """(c) deepseek-moe-16b: ``Engine`` serving and ``Trainer`` steps as in
    phase 8c; (d) zamba2-2.7b and mamba2-130m: ``server_serving`` and the
    same ``Trainer`` steps. Each then takes one training step traced on
    the device only (busy share) and one profiled with its ranges (the
    MoE dispatch, expert products and combine; the SSD scan)."""
    from repro_torch.configs import registry

    full = registry.get(arch, sparse=True)
    tag = "12c" if full.family == "moe" else "12d"
    depth = {"published": full.num_layers, "run": DEPTH_CUTS.get(arch, full.num_layers)}
    full = full.replace(num_layers=depth["run"])
    log(f"[{tag}] {arch}: {depth['run']} of its {depth['published']} layers (DEPTH_CUTS), published widths")
    if full.family == "moe":
        serving = engine_serving(full, seed, smi, kernels, tag)
        must = ("bsr_matmul", "block_sparse_attention")
    else:
        must = ("bsr_matmul", "block_sparse_attention") if full.num_heads else ("bsr_matmul",)
        serving = server_serving(full, seed, smi, kernels, tag, must)
    training = trainer_steps(full, seed, smi, kernels, tag, traced=True, must_launch=must, profile=True)
    # shares of the step's device time: the profiler's host-side work
    # stretches the profiled window, not the kernels
    prof = training["profiled_step"]
    busy = prof["device_busy_ms"]
    shares = {name: r["device_ms"] / busy for name, r in prof["ranges"].items() if busy}
    training["device_shares"] = shares
    for name in ("moe_dispatch", "moe_experts", "moe_combine", "ssd_scan", "sparse_attention_vjp",
                 "bsr_matmul_dblocks", "optimizer"):
        if name in shares:
            log(f"[{tag}] {arch} profiled step: {name} {prof['ranges'][name]['device_ms']:.1f} ms, "
                f"{shares[name]:.3f} of the step's {busy:.1f} ms of device time")
    torch.cuda.empty_cache()
    return {"serving": serving, "training": training, "depth": depth, "card": smi}


# ----------------------------------------------------------------------
# main
# ----------------------------------------------------------------------


# ----------------------------------------------------------------------
# phase 13: the analysis instruments, the router, the tools
# ----------------------------------------------------------------------


def guarded_decode(full, seed, smi, kernels):
    """(a) ``Engine(max_slots=8, max_len=2048)`` of full-width sparse
    qwen3-1.7b admits 8 greedy requests of 200-1000 prompt tokens; its
    next 16 decode steps run inside ``DispatchGuard(max_compiles=0)``:
    no kernel-library build, no implicit sync, one explicit fetch a step
    (the kernels' counts set to 0 just before the admission and read
    after the guarded steps). Then one step with an ``.item()`` injected
    into the decode step must raise ``HostSyncError``. (b) The engine's
    ``roofline()`` beside the guarded steps' p50. Returns (the record,
    the engine)."""
    from repro_torch.analysis.guards import DispatchGuard, HostSyncError
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig

    rng = np.random.default_rng(seed + 13)
    t0 = time.perf_counter()
    eng = Engine(full, engine_cfg=EngineConfig(max_slots=8, max_len=2048), seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng.submit(rng.integers(0, full.vocab_size, 300).astype(np.int32), 4)  # warm-up, not counted
    eng.drain(max_steps=50)
    for k in kernels.values():
        k.launches = 0
    for n in rng.integers(200, 1001, 8):
        eng.submit(rng.integers(0, full.vocab_size, int(n)).astype(np.int32), 40)
    eng.step()  # admission and the first decode step
    if len(eng.scheduler.active()) != 8:
        raise AssertionError(f"13a: {len(eng.scheduler.active())} of 8 requests admitted in the first step")
    eng.reset_stats()
    n_steps = 16
    with DispatchGuard(max_compiles=0) as g:
        for _ in range(n_steps):
            if eng.step():
                raise AssertionError("13a: a request finished inside the guarded steps")
    launches = {name: k.launches for name, k in kernels.items()}
    if g.compiles or g.implicit_syncs or g.explicit_syncs != n_steps:
        raise AssertionError(f"13a: guarded decode: {g.compiles} builds, {g.implicit_syncs} implicit syncs, "
                             f"{g.explicit_syncs} explicit syncs over {n_steps} steps")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"13a: kernel {name} was never launched")
    t0 = time.perf_counter()
    roof = eng.roofline()
    roof_s = time.perf_counter() - t0
    steps = engine_stats(eng)["decode_step_s"]
    decode_step = T.decode_step_paged

    def leaky(*a, **kw):
        out = decode_step(*a, **kw)
        out[0][0, 0].item()  # the classic per-step scalar pull
        return out

    T.decode_step_paged = leaky
    try:
        with DispatchGuard(max_compiles=0):
            eng.step()
    except HostSyncError as e:
        raised = str(e).splitlines()[0]
    else:
        raise AssertionError("13a: an injected .item() in the decode step did not raise HostSyncError")
    finally:
        T.decode_step_paged = decode_step
    guard = {"steps": n_steps, "compiles": g.compiles, "implicit_syncs": g.implicit_syncs,
             "explicit_syncs": g.explicit_syncs, "injected_item": raised, "weights_s": init_s,
             "decode_step_ms_p50": 1e3 * p50(steps), "decode_step_ms": [1e3 * x for x in steps],
             "launches": launches, "card": smi}
    log(f"[13a] guarded decode, full-width qwen3-1.7b sparse, 8 slots, greedy, on {smi}: {n_steps} steps, "
        f"{g.compiles} kernel-library builds, {g.implicit_syncs} implicit syncs, {g.explicit_syncs} explicit "
        f"syncs; step p50 {guard['decode_step_ms_p50']:.2f} ms; launches {launches}")
    log(f"[13a] an injected .item() raised HostSyncError: {raised}")
    bound_s = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    step_s = guard["decode_step_ms_p50"] / 1e3
    from repro_torch.analysis.roofline import model_flops

    guard["roofline"] = {**roof, "count_s": roof_s, "bound_ms": 1e3 * bound_s,
                         "share_of_step": bound_s / step_s,
                         "model_flops_2nd": model_flops(full, 8, backward=False)}
    log(f"[13b] Engine.roofline() (counted in {roof_s:.2f} s): {roof['flops'] / 1e9:.3f} GFLOP, "
        f"{roof['bytes_accessed'] / 1e9:.3f} GB a decode step of 8 slots, intensity "
        f"{roof['arithmetic_intensity']}, {roof['bottleneck']} bound: {1e3 * bound_s:.3f} ms "
        f"(compute {1e3 * roof['compute_s']:.4f} ms, memory {1e3 * roof['memory_s']:.4f} ms) against the "
        f"guarded steps' p50 {guard['decode_step_ms_p50']:.2f} ms: the bound is "
        f"{guard['roofline']['share_of_step']:.4f} of the step; 2 N D for 8 tokens "
        f"{guard['roofline']['model_flops_2nd'] / 1e9:.3f} GFLOP (no logits)")
    return guard, eng


def router_streams(full, eng, seed, smi, kernels):
    """(d) ``ReplicaRouter(replicas=2)`` of full-width sparse qwen3-1.7b on
    the card, on ``eng``'s weights (shared), serves 16 greedy requests of
    257-512 prompt tokens, 16 new each; one engine (``eng``, drained)
    serves the same requests: the streams must be equal bit for bit, by
    router uid. The kernels' counts are set to 0 just before the router's
    drain and read just after: all three must launch."""
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.router import ReplicaRouter

    rng = np.random.default_rng(seed + 14)
    # one prefill bucket (3-4 pages): the single engine's two waves and
    # each replica's one wave prefill groups of 8 at the same shapes
    work = [rng.integers(0, full.vocab_size, int(n)).astype(np.int32) for n in rng.integers(257, 513, 16)]
    eng.drain(max_steps=200)
    uids = {eng.submit(p, 16): i for i, p in enumerate(work)}
    one = {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=400)}
    t0 = time.perf_counter()
    router = ReplicaRouter(full, replicas=2, engine_cfg=EngineConfig(max_slots=8, max_len=2048),
                           params=eng.model.state_dict(), devices=["cuda", "cuda"])
    router.submit(rng.integers(0, full.vocab_size, 300).astype(np.int32), 4)  # warm-up, both replicas
    router.submit(rng.integers(0, full.vocab_size, 300).astype(np.int32), 4)
    router.drain(max_steps=50)
    init_s = time.perf_counter() - t0
    router.reset_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    ruids = {router.submit(p, 16): i for i, p in enumerate(work)}
    fins = router.drain(max_steps=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    got = {ruids[f.uid]: f.tokens.tolist() for f in fins}
    if got != one:
        bad = sorted(i for i in one if got.get(i) != one[i])
        raise AssertionError(f"13d: router streams differ from one engine's for requests {bad}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"13d: kernel {name} was never launched by the router")
    s = router.stats_summary()
    per = [int(r["requests_finished"]) for r in s["per_replica"]]
    if per != [8, 8]:
        raise AssertionError(f"13d: least-loaded routing gave {per}, not 8 and 8")
    out = {"requests": len(fins), "replicas": 2, "per_replica_finished": per, "wall_s": wall,
           "setup_s": init_s, "decode_tok_s": s["decode_tok_s"], "p50_token_latency_ms": s["p50_token_latency_ms"],
           "streams_sha256": digest(torch.as_tensor(np.concatenate([np.asarray(got[i]) for i in sorted(got)]))),
           "launches": launches, "card": smi}
    del router
    torch.cuda.empty_cache()
    log(f"[13d] ReplicaRouter(replicas=2) on {smi}: 16 greedy requests (257-512 prompt tokens, 16 new) in "
        f"{wall:.2f} s, {per} finished a replica, fleet decode {out['decode_tok_s']:.1f} tok/s, p50 "
        f"{out['p50_token_latency_ms']:.1f} ms; streams equal to one engine's bit for bit (digest "
        f"{out['streams_sha256']}); launches {launches}")
    return out


def guarded_training_step(full, seed, smi, kernels):
    """(c) One full-width sparse qwen3-1.7b ``Trainer`` step at B = 4,
    S = 2048 after a warm-up step, inside ``DispatchGuard(raise_on_sync=
    False, max_compiles=None)``: its implicit and explicit syncs counted,
    its MFU from ``analysis.roofline.model_flops`` at the H100's bf16
    peak. The kernels' counts are set to 0 just before the step."""
    import shutil

    from repro_torch.analysis.guards import DispatchGuard
    from repro_torch.analysis.roofline import HW, model_flops
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import TrainConfig, Trainer
    from repro_torch.training.optimizer import OptConfig

    b, s = 4, 2048
    ckpt = ROOT / "build" / "chip_smoke_guard_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    trainer = Trainer(full, OptConfig(lr=3e-4, warmup_steps=2, total_steps=100),
                      SyntheticLM(full.vocab_size, s, b, seed=seed),
                      TrainConfig(ckpt_dir=str(ckpt), ckpt_every=10 ** 9, log_every=10 ** 9, seed=seed),
                      device="cuda")
    warm = trainer.run(1)
    for k in kernels.values():
        k.launches = 0
    with DispatchGuard(raise_on_sync=False, max_compiles=None) as g:
        hist = trainer.run(1)
    launches = {name: k.launches for name, k in kernels.items()}
    h = hist[0]
    if not (math.isfinite(warm[0]["loss"]) and math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
        raise AssertionError(f"13c: training step loss {h['loss']}, grad_norm {h['grad_norm']}")
    for name in ("bsr_matmul", "block_sparse_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"13c: kernel {name} was never launched in the training step")
    flops = model_flops(full, b * s)
    out = {"shape": f"B={b} S={s}", "step_ms": 1e3 * h["step_time_s"], "loss": h["loss"],
           "implicit_syncs": g.implicit_syncs, "explicit_syncs": g.explicit_syncs, "compiles": g.compiles,
           "sync_sites": dict(g.sites), "model_flops": flops, "mfu": flops / h["step_time_s"] / HW().flops_for(full.dtype),
           "launches": launches, "card": smi}
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[13c] one full-width training step (B={b}, S={s}) under DispatchGuard(raise_on_sync=False) on {smi}: "
        f"{out['step_ms']:.1f} ms, {g.implicit_syncs} implicit syncs, {g.explicit_syncs} explicit, "
        f"{g.compiles} builds; model FLOPs 6 N D {flops / 1e12:.2f} TFLOP, MFU {out['mfu']:.4f} at "
        f"{HW().flops_for(full.dtype) / 1e12:.0f} TFLOP/s; launches {launches}")
    for site, n in g.sites.most_common():
        log(f"[13c]   {n} implicit sync(s) at {site.replace(str(ROOT) + '/', '')}")
    return out


def tools_on_card(kernels):
    """(e) ``repro_torch.examples.train_lm`` for 4 steps on the card (the
    kernels' counts set to 0 just before: both training kernels launch,
    the losses are finite), then ``python -m repro_torch.bench.run --only
    roofline`` in a process of its own: its CSV header and rows."""
    import shutil

    from repro_torch.examples import train_lm

    ckpt = ROOT / "build" / "chip_smoke_example_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    for k in kernels.values():
        k.launches = 0
    hist = train_lm.main(["--steps", "4", "--ckpt-dir", str(ckpt)])
    launches = {name: k.launches for name, k in kernels.items()}
    shutil.rmtree(ckpt, ignore_errors=True)
    if len(hist) != 4 or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"13e: train_lm history {hist}")
    for name in ("bsr_matmul", "block_sparse_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"13e: kernel {name} was never launched by examples.train_lm")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.bench.run", "--only", "roofline"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or lines[0] != "name,us_per_call,derived" or len(lines) < 2:
        raise AssertionError(f"13e: bench.run --only roofline: rc {proc.returncode}, {proc.stdout!r} {proc.stderr[-2000:]}")
    losses = [h["loss"] for h in hist]
    log(f"[13e] examples.train_lm, 4 steps on the card: losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"launches {launches}")
    log(f"[13e] python -m repro_torch.bench.run --only roofline: {' | '.join(lines)}")
    return {"losses": losses, "launches": launches, "bench_run": lines}


# ----------------------------------------------------------------------
# phase 14: tensor-parallel serving of the dense family
# ----------------------------------------------------------------------

# the tensor-parallel degrees of 14a, and of 14d's bench: its tp 1 oracle
# and tp 2 (its tp 8 row is cut for the script's time budget since phase
# 15 joined it; 14a runs tp 2 and 4)
TP_DEGREES = (1, 2, 4)
TP_BENCH = (1, 2)
# bf16 logits of a tp engine against tp 1's, absolute, for logits whose
# largest magnitude is ~4.4 here: a column-parallel shard computes its
# output slice from the whole input, so the prefill's logits come out
# equal, but the decode step's products (the M <= 16 bsr kernel's
# reduction, the low-rank GEMMs at another width) round differently and
# 28 bf16 layers carry it to the logits (0.137 at most at tp 2, 4 and 8
# on an H100). Each planted shard fault (``planted_fault``) must read
# above it: the phase fails if one does not.
TP_LOGIT_TOL = 0.25
# the shard faults 14a plants at tp 2 to show that TP_LOGIT_TOL catches them
TP_FAULTS = ("cols", "kv heads")
TP_SAMPLING = dict(temperature=0.8, top_k=40)


def decision_gap(cfg, model, prompt, prefix, sp, sample_idx, candidates=64) -> float:
    """The top-2 gap, in logits, of the decision the engine makes after
    ``prompt + prefix`` on ``model``: the greedy argmax over the padded
    vocabulary, or (``sp``) the sampler's Gumbel-max over its top
    ``candidates`` scaled by the temperature, with the request's noise at
    ``sample_idx`` (``serving.sampling``'s derivation). The logits come
    from one ``prefill_paged`` pass over the whole sequence."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import sampling as S

    seq = np.concatenate([prompt, np.asarray(prefix, np.int32)]).astype(np.int32)
    page = cfg.attn_block
    n_pages = -(-len(seq) // page)
    toks = np.zeros((1, n_pages * page), np.int32)
    toks[0, : len(seq)] = seq
    cache = T.init_paged_cache(cfg, n_pages + 1, page, device="cuda")
    with torch.no_grad():
        logits, _ = T.prefill_paged(
            cfg, model, torch.as_tensor(toks, device="cuda"), torch.tensor([len(seq)], device="cuda"),
            cache, torch.arange(1, n_pages + 1, dtype=torch.int32, device="cuda")[None],
        )
    x = logits[0].float().cpu().numpy()
    if sp is None:
        top = np.sort(x)[-2:]
        return float(top[1] - top[0])
    scaled = x / np.float32(sp.temperature)
    scaled[cfg.vocab_size:] = -np.inf
    order = np.argsort(-scaled, kind="stable")[:candidates]
    sx = scaled[order]
    sx[sp.top_k:] = -np.inf
    key = torch.from_numpy(S.base_key_data(sp.seed).astype(np.int64))[None]
    noise = S.gumbel(S.fold_in(key, torch.tensor([sample_idx])), candidates)[0].numpy()
    top = np.sort(sx + noise)[-2:]
    return float((top[1] - top[0]) * sp.temperature)


@contextlib.contextmanager
def planted_fault(model, kind):
    """A shard fault in the tp 2 ``model`` (a ``transformer.ShardedLM``)
    for the length of the block. "cols": shard 1's pixelfly linears read
    shard 0's block rows of the pattern's ``cols`` (the fault of a shard
    built from a narrower pattern of its own). "kv heads": the two shards'
    k and v projections swapped, so each shard's q heads read the other
    shard's kv heads."""
    from repro_torch.models import layers as L

    s0, s1 = model.shards[0], model.shards[1]
    undo = []
    if kind == "cols":
        for mod in s1.modules():
            if isinstance(mod, L.Linear) and mod.rows is not None:
                undo.append((mod, "rows", mod.rows))
                mod.rows = (0, mod.rows[1] - mod.rows[0])
    elif kind == "kv heads":
        for b0, b1 in zip(s0.layers, s1.layers):
            for name in ("wk", "wv"):
                a0, a1 = getattr(b0.attn, name), getattr(b1.attn, name)
                undo += [(b0.attn, name, a0), (b1.attn, name, a1)]
                setattr(b0.attn, name, a1)
                setattr(b1.attn, name, a0)
    else:
        raise ValueError(kind)
    try:
        yield
    finally:
        for obj, name, val in undo:
            setattr(obj, name, val)


def first_logits(full, eng, fixed, fixed_lens):
    """The logits of one prefill call of ``fixed`` (4 prompts) and of the
    decode step after it on ``eng``'s model and pools (the first pages,
    which its requests overwrite before reading), as fp32."""
    from repro_torch.models import transformer as T

    npp = fixed.shape[1] // full.attn_block
    rows = torch.arange(1, 4 * npp + 1, dtype=torch.int32, device="cuda").reshape(4, npp)
    table = torch.zeros((8, eng.kv.pages_per_seq), dtype=torch.int32, device="cuda")
    table[:4, :npp] = rows
    with torch.no_grad():
        lp, _ = T.prefill_paged(full, eng.model, fixed, fixed_lens, eng.kv.buffers, rows)
        nxt = torch.zeros(8, dtype=torch.int32, device="cuda")
        nxt[:4] = lp.argmax(-1).int()
        pos = torch.zeros(8, dtype=torch.int32, device="cuda")
        pos[:4] = fixed_lens
        ld, _ = T.decode_step_paged(full, eng.model, eng.kv.buffers, nxt, pos, table)
    return lp.float(), ld[:4].float()


def tp_serving(full, seed, smi, kernels):
    """(a) Engines at tp 1, 2 and 4 on one state dict: first the logits of
    one prefill call (4 prompts of 512, 400, 300, 257 tokens) and of the
    decode step after it against tp 1's within ``TP_LOGIT_TOL``, and at
    tp 2 the same logits under each planted shard fault
    (``planted_fault``), which must read above it; then 12 requests of
    257-512 prompt tokens, 16 new each, greedy and then sampled
    (``TP_SAMPLING``, seed 100 + i), each stream equal to tp 1's token for
    token. A divergence is printed with tp 1's top-2 gap at its step
    (``decision_gap``), then fails the phase. The kernels' counts are set
    to 0 before each tp's requests and read after: all three must launch.
    Returns the report, the state dict and the engines."""
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.sampling import SamplingParams

    t0 = time.perf_counter()
    sd = T.init_model(full, seed=seed, device="cuda").state_dict()
    log(f"[14a] full-width qwen3-1.7b sparse weights in {time.perf_counter() - t0:.1f} s (shared by every tp)")
    rng = np.random.default_rng(seed + 15)
    work = [rng.integers(0, full.vocab_size, int(n)).astype(np.int32) for n in rng.integers(257, 513, 12)]
    fixed = torch.as_tensor(rng.integers(0, full.vocab_size, (4, 512)), dtype=torch.int32, device="cuda")
    fixed_lens = torch.tensor([512, 400, 300, 257], dtype=torch.int32, device="cuda")
    out, engines, ref = {}, {}, None
    for tp in TP_DEGREES:
        t0 = time.perf_counter()
        eng = Engine(full, engine_cfg=EngineConfig(max_slots=8, max_len=2048), params=sd,
                     mesh=make_tp_mesh(tp))
        engines[tp] = eng
        build_s = time.perf_counter() - t0
        lp, ld = first_logits(full, eng, fixed, fixed_lens)
        if lp.shape != (4, full.padded_vocab) or not (torch.isfinite(lp).all() and torch.isfinite(ld).all()):
            raise AssertionError(f"14a: tp {tp} logits not finite or of the wrong shape")
        if ref is None:
            ref = (lp, ld)
        err = {"prefill": (lp - ref[0]).abs().max().item(), "decode": (ld - ref[1]).abs().max().item()}
        if max(err.values()) > TP_LOGIT_TOL:
            raise AssertionError(f"14a: tp {tp} logits off tp 1's by {err} (tol {TP_LOGIT_TOL})")
        faults = {}
        for kind in TP_FAULTS if tp == 2 else ():
            with planted_fault(eng.model, kind):
                fp, fd = first_logits(full, eng, fixed, fixed_lens)
            faults[kind] = {"prefill": (fp - ref[0]).abs().max().item(), "decode": (fd - ref[1]).abs().max().item()}
            log(f"[14a] tp 2 with a planted {kind} fault: logits vs tp 1 prefill {faults[kind]['prefill']:.4g} "
                f"decode {faults[kind]['decode']:.4g} (tol {TP_LOGIT_TOL})")
            if max(faults[kind].values()) <= TP_LOGIT_TOL:
                raise AssertionError(f"14a: a planted {kind} fault reads {faults[kind]}, within {TP_LOGIT_TOL}")
        eng.submit(rng.integers(0, full.vocab_size, 300).astype(np.int32), 4)  # warm-up
        eng.drain(max_steps=50)
        eng.reset_stats()
        for k in kernels.values():
            k.launches = 0
        row = {"tp": tp, "mesh_positions": eng.mesh.size, "distinct_devices": eng.distinct_devices,
               "paged_impl": eng.paged_impl, "build_s": build_s, "logit_max_abs_err": err,
               "kv_pool_gb": eng.kv.memory_bytes() / 1e9, "planted_faults": faults}
        t0 = time.perf_counter()
        for mode in ("greedy", "sampled"):
            uids = {}
            for i, p in enumerate(work):
                sp = SamplingParams(**TP_SAMPLING, seed=100 + i) if mode == "sampled" else None
                uids[eng.submit(p, 16, sampling=sp)] = i
            fins = eng.drain(max_steps=400)
            if len(fins) != 12 or any(f.finish_reason != "length" or len(f.tokens) != 16 for f in fins):
                raise AssertionError(f"14a: tp {tp} {mode}: {[(f.finish_reason, len(f.tokens)) for f in fins]}")
            row[mode] = {uids[f.uid]: f.tokens.tolist() for f in fins}
        torch.cuda.synchronize()
        row["wall_s"] = time.perf_counter() - t0
        row["launches"] = {name: k.launches for name, k in kernels.items()}
        for name, n in row["launches"].items():
            if n <= 0:
                raise AssertionError(f"14a: kernel {name} was never launched at tp {tp}")
        st = engine_stats(eng)
        steps = sorted(st["decode_step_s"])
        row.update(decode_steps=st["decode_steps"], decode_tok_s=st["decode_tokens"] / sum(steps),
                   decode_step_ms_p50=1e3 * steps[len(steps) // 2], card=smi)
        # every divergence from tp 1, with tp 1's decision gap at its step
        row["divergences"] = []
        for mode in ("greedy", "sampled") if tp != 1 else ():
            for i in range(len(work)):
                a, b = out[1][mode][i], row[mode][i]
                if a == b:
                    continue
                j = next(j for j in range(len(a)) if a[j] != b[j])
                sp = SamplingParams(**TP_SAMPLING, seed=100 + i) if mode == "sampled" else None
                gap = decision_gap(full, engines[1].model, work[i], a[:j], sp, j)
                row["divergences"].append({"mode": mode, "request": i, "step": j, "tp1": a[j], "tp": b[j],
                                           "top2_gap": gap})
                log(f"[14a] tp {tp} {mode} request {i} diverges from tp 1 at token {j} ({a[j]} vs {b[j]}): "
                    f"tp 1's top-2 gap there {gap:.4f}")
        if row["divergences"]:
            raise AssertionError(f"14a: tp {tp} streams differ from tp 1's: {row['divergences']}")
        row["streams_equal"] = True
        out[tp] = row
        log(f"[14a] tp {tp} ({eng.mesh.size} shard(s) on {eng.distinct_devices} device(s); {smi}): logits vs tp 1 "
            f"prefill {err['prefill']:.4g} decode {err['decode']:.4g} (tol {TP_LOGIT_TOL}); 24 requests "
            f"(12 greedy, 12 sampled) in {row['wall_s']:.2f} s, decode {row['decode_tok_s']:.1f} tok/s, step p50 "
            f"{row['decode_step_ms_p50']:.2f} ms; streams equal to tp 1's: {row['streams_equal']} "
            f"({len(row['divergences'])} divergences); launches {row['launches']}")
    report = {str(tp): {k: v for k, v in r.items() if k not in ("greedy", "sampled")} for tp, r in out.items()}
    return report, sd, engines, work


def tp_kernels(timer, full, seed):
    """(b) The three kernels at the shard shapes of tp 2 and tp 4 against
    their plain versions, timed as phase 3 times them: ``bsr_matmul`` on
    each rank's block rows of the global pattern (the first rank timed, the
    others checked), the paged read on a shard's kv heads, the prefill
    attention on its heads."""
    from repro_torch.models import layers as L

    specs = {
        "q": L.linear_spec(full, full.d_model, full.q_dim, False),
        "k/v": L.linear_spec(full, full.d_model, full.kv_dim, False),
        "gate/up": L.linear_spec(full, full.d_model, full.d_ff, False),
        "down": L.linear_spec(full, full.d_ff, full.d_model, False),
    }
    out = {"bsr_matmul": [], "paged_decode_attention": [], "block_sparse_attention": []}
    for tp in (2, 4):
        for label, spec in specs.items():
            pat = spec.pattern()
            nb = pat.nb_out // tp
            g = torch.Generator(device="cuda").manual_seed(seed + 100 * tp)
            for m in (8, 4096):
                x = torch.randn((m, spec.in_features), generator=g, device="cuda").to(torch.bfloat16)
                for r in range(tp):
                    blocks = (torch.randn((nb, pat.r, pat.block, pat.block), generator=g, device="cuda")
                              / math.sqrt(pat.r * pat.block)).to(torch.bfloat16)
                    cols = torch.as_tensor(pat.cols[r * nb : (r + 1) * nb], device="cuda")
                    row = bsr_row(timer, x, blocks, cols, spec.in_features, nb * pat.r, 2e-2,
                                  f"tp{tp} {label} rank {r}", timed=r == 0)
                    if r == 0:
                        row.update(tp=tp, linear=label)
                        out["bsr_matmul"].append(row)
                        log(f"[14b] bsr_matmul tp {tp} {label:7s} {row['shape']} (rank 0 of {tp}; every rank "
                            f"checked): err {row['max_abs_err']:.2e} kernel {row['ms']:.4f} ms plain "
                            f"{row['plain_ms']:.4f} ms x@dense {row['library_ms']:.4f} ms bound "
                            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        paged = paged_case(timer, b=8, hk=8 // tp, g=2, d=128, page=128, pps=16, dtype=torch.bfloat16,
                           seed=seed + 20 + tp, tol=1e-2)
        attn = attention_case(timer, b=1, s=2048, h=16 // tp, hk=8 // tp, d=128, block=128,
                              dtype=torch.bfloat16, seed=seed + 30 + tp, tol=2e-2)
        for name, row in (("paged_decode_attention", paged), ("block_sparse_attention", attn)):
            row["tp"] = tp
            out[name].append(row)
            log(f"[14b] {name} tp {tp} {row['shape']}: err {row['max_abs_err']:.2e} (tol {row['tol']:g}) "
                f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms sdpa {row['library_ms']:.4f} ms "
                f"bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return out


def tp_router(full, sd, eng, seed, smi, kernels):
    """(c) ``ReplicaRouter(replicas=2, tp=2)`` on the card (two (1, 2)
    meshes, 4 shards on one device) on ``sd`` serves 16 greedy requests of
    257-512 prompt tokens (one prefill bucket), 16 new each; ``eng`` (a tp
    2 engine on the same weights, drained) serves the same requests: the
    streams must be equal bit for bit, by router uid, 8 a replica. The
    kernels' counts are set to 0 just before the router's drain and read
    just after: all three must launch."""
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.router import ReplicaRouter

    rng = np.random.default_rng(seed + 16)
    work = [rng.integers(0, full.vocab_size, int(n)).astype(np.int32) for n in rng.integers(257, 513, 16)]
    eng.drain(max_steps=200)
    uids = {eng.submit(p, 16): i for i, p in enumerate(work)}
    one = {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=400)}
    router = ReplicaRouter(full, replicas=2, tp=2, engine_cfg=EngineConfig(max_slots=8, max_len=2048),
                           params=sd, devices=["cuda"] * 4)
    for _ in range(2):  # warm-up, both replicas
        router.submit(rng.integers(0, full.vocab_size, 300).astype(np.int32), 4)
    router.drain(max_steps=50)
    router.reset_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    ruids = {router.submit(p, 16): i for i, p in enumerate(work)}
    fins = router.drain(max_steps=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    got = {ruids[f.uid]: f.tokens.tolist() for f in fins}
    if got != one:
        bad = sorted(i for i in one if got.get(i) != one[i])
        raise AssertionError(f"14c: tp 2 router streams differ from one tp 2 engine's for requests {bad}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"14c: kernel {name} was never launched by the tp 2 router")
    s = router.stats_summary()
    per = [int(r["requests_finished"]) for r in s["per_replica"]]
    if per != [8, 8] or s["tp"] != 2:
        raise AssertionError(f"14c: routing gave {per} at tp {s['tp']}, not 8 and 8 at tp 2")
    out = {"requests": len(fins), "replicas": 2, "tp": 2, "mesh_positions": 4,
           "distinct_devices": s["distinct_devices"], "per_replica_finished": per, "wall_s": wall,
           "decode_tok_s": s["decode_tok_s"], "p50_token_latency_ms": s["p50_token_latency_ms"],
           "streams_sha256": digest(torch.as_tensor(np.concatenate([np.asarray(got[i]) for i in sorted(got)]))),
           "launches": launches, "card": smi}
    del router
    torch.cuda.empty_cache()
    log(f"[14c] ReplicaRouter(replicas=2, tp=2) on {smi} (4 shards on {out['distinct_devices']} device): 16 greedy "
        f"requests in {wall:.2f} s, {per} a replica, fleet decode {out['decode_tok_s']:.1f} tok/s; streams equal "
        f"to one tp 2 engine's bit for bit (digest {out['streams_sha256']}); launches {launches}")
    return out


def tp_bench(sd, smi, kernels):
    """(d) ``repro_torch.bench.serve_mesh`` at full width on the card, on
    (a)'s weights, at ``TP_BENCH``: tp 1 (its oracle) and tp 2, and its
    2-replica router, streams asserted equal; its
    payload line goes to the report, its rows to the log beside the card. Then the serve CLI at full width with
    ``--tp 2 --strategy tp``: 8 requests of 512 tokens, 16 new each. The
    kernels' counts are set to 0 just before each and read just after:
    all three must launch."""
    import contextlib
    import io

    from repro_torch.bench import serve_mesh
    from repro_torch.launch import serve

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its payload line is not this script's
        res = serve_mesh.run(device="cuda", params=sd, tps=TP_BENCH)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"14d: kernel {name} was never launched by bench.serve_mesh")
    if not res["streams_equal"] or set(res["by_tp"]) != {str(t) for t in TP_BENCH}:
        raise AssertionError(f"14d: bench.serve_mesh streams_equal {res['streams_equal']}, tps {sorted(res['by_tp'])}")
    for tp, row in res["by_tp"].items():
        log(f"[14d] serve_mesh tp {tp} ({row['devices']} shard(s) on {row['distinct_devices']} device(s); {smi}): "
            f"decode {row['decode_tok_s']} tok/s, wall {row['wall_tok_s']:.2f} tok/s ({row['wall_s']:.3f} s), "
            f"p95 token {row['p95_token_latency_ms']} ms, paged {row['paged_impl']}")
    log(f"[14d] serve_mesh router replicas=2: {res['router']['wall_tok_s']:.2f} tok/s, streams equal "
        f"{res['router']['streams_equal']}; {wall:.1f} s in all; launches {launches}")
    for k in kernels.values():
        k.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        served = serve.main(["--arch", "qwen3-1.7b", "--sparse", "--batch", "8", "--prompt-len", "512",
                             "--gen", "16", "--tp", "2", "--strategy", "tp"])
    cli_launches = {name: k.launches for name, k in kernels.items()}
    lines = buf.getvalue().splitlines()
    if served.engine.tp != 2 or len(served.tokens) != 8 or any(len(t) != 16 for t in served.tokens):
        raise AssertionError(f"14d: serve --tp 2 --strategy tp: {lines}")
    for name, n in cli_launches.items():
        if n <= 0:
            raise AssertionError(f"14d: kernel {name} was never launched by serve --tp 2")
    log(f"[14d] serve --tp 2 --strategy tp at full width: {lines[0]}; {lines[1]}; launches {cli_launches}")
    for name in launches:
        launches[name] += cli_launches[name]
    return {"wall_s": wall, "launches": launches, "result": res, "cli": lines[:2], "card": smi}


# ----------------------------------------------------------------------
# phase 15: training on a mesh
# ----------------------------------------------------------------------

# the meshes of 15a, every position the card: (1, 1) is the reference
MESH_TRAIN = (("fsdp", (1, 1)), ("fsdp", (2, 1)), ("tp", (1, 2)), ("tp", (2, 2)))
# a mesh against (1, 1), bf16 at full width: each step's loss (relative),
# each step's grad norm (relative), and the first step's gradient (the
# first moment after it) by parameter kind (``tok``, ``blocks``, ``U``, ...:
# 1 - the cosine of the whole kind's gradient with (1, 1)'s). The first
# step starts from the same weights, so only rounding separates the meshes
# there; later steps also carry the sign flips of AdamW's first update
# where a gradient is near 0. Each planted fault (``planted_train_fault``)
# must read above one of them: the phase fails if one does not.
MESH_TOL = {"loss": 1e-3, "grad_norm": 1e-2, "grad_direction": 2e-3}
# the faults 15a plants, each on the mesh it needs
MESH_FAULTS = (("replicated grad", "tp", (1, 2)), ("global count", "fsdp", (2, 1)))


@contextlib.contextmanager
def planted_train_fault(kind):
    """A fault in the mesh trainer for the length of the block. "replicated
    grad": a tensor every model shard holds (the norm scales, U, γ) takes
    its gradient from shard 0 alone, where the sum over the shards is
    right. "global count": the second data replica's rows are left out of
    the global count of labels that divides every replica's NLL sum."""
    from repro_torch.training import loop

    if kind == "replicated grad":
        name, orig = "accumulate", loop.MeshState.accumulate

        def faulty(self, acc, param, m, grad, *rest):
            if m and self.model_dim[param] is None:
                return None
            return orig(self, acc, param, m, grad, *rest)

        owner = loop.MeshState
    elif kind == "global count":
        name, orig, owner = "_global_count", loop._global_count, loop

        def faulty(labels, device):
            return orig(labels[:1] + labels[2:], device)
    else:
        raise ValueError(kind)
    setattr(owner, name, faulty)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _kind_of(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def mesh_run(full, sd, data, opt, strategy, shape, device, kernels, *, ref=None, fault=None, steps=3):
    """One ``Trainer`` on a mesh of ``shape`` whose every position is
    ``device``, from the state dict ``sd``: ``steps`` steps (the first a
    warm-up, the kernels' counts set to 0 after it and read after the
    last), each step's loss and grad norm; with ``ref`` (the (1, 1) run's)
    the comparison of ``MESH_TOL`` and each step's parameter difference
    relative to the (1, 1) update, else the snapshots and first moments a
    comparison needs."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.loop import TrainConfig, Trainer

    import shutil

    ckpt = ROOT / "build" / "chip_smoke_mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    n = shape[0] * shape[1]
    mesh = make_local_mesh(*shape, devices=[device] * n)
    t0 = time.perf_counter()
    tr = Trainer(full, opt, data, TrainConfig(ckpt_dir=str(ckpt), ckpt_every=10 ** 9, log_every=10 ** 9),
                 mesh=mesh, strategy=strategy, params=sd)
    build_s = time.perf_counter() - t0
    ms = tr.model
    out = {"strategy": strategy, "mesh": list(shape), "positions": n, "distinct_devices": mesh.distinct_devices,
           "build_s": build_s, "fault": fault}
    snaps = [ms.state_dict(device)] if ref is None else None
    hist, param_rel, launches = [], [], {}
    with planted_train_fault(fault) if fault else contextlib.nullcontext():
        for i in range(steps):
            if i == 1:
                for k in kernels.values():
                    k.launches = 0
            hist += tr.run(1)
            if i == 0:
                # the first step's gradient by kind: its first moment
                mu = {name: ms.unshard({name: tr.opt["mu"][name]}, device)[name] for name in ms.shapes}
                if ref is None:
                    out["mu"] = mu
                else:
                    sums = {}
                    for name, m in mu.items():
                        r = ref["mu"][name]
                        a, b, c = sums.get(_kind_of(name), (0.0, 0.0, 0.0))
                        sums[_kind_of(name)] = (a + float((m * r).sum()), b + float((m * m).sum()),
                                                c + float((r * r).sum()))
                    out["grad_direction"] = {k: 1.0 - a / math.sqrt(b * c) if b * c > 0 else 0.0
                                             for k, (a, b, c) in sums.items()}
                del mu
            if ref is None:
                snaps.append(ms.state_dict(device))
            else:
                worst = upd = num = den = 0.0
                for name in ms.shapes:
                    p = ms.unshard({name: ms.shards[name]}, device)[name].float()
                    r1, r0 = ref["snaps"][i + 1][name].float(), ref["snaps"][i][name].float()
                    worst, upd = max(worst, float((p - r1).abs().max())), max(upd, float((r1 - r0).abs().max()))
                    num, den = num + float((p - r1).square().sum()), den + float((r1 - r0).square().sum())
                param_rel.append({"max": worst / upd if upd else 0.0,
                                  "l2": math.sqrt(num / den) if den else 0.0})
    if device == "cuda":
        torch.cuda.synchronize()
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = {name: k.launches for name, k in kernels.items()}
    out["loss"] = [h["loss"] for h in hist]
    out["grad_norm"] = [h["grad_norm"] for h in hist]
    out["step_ms"] = [1e3 * h["step_time_s"] for h in hist[1:]]
    med = statistics.median(out["step_ms"]) if out["step_ms"] else float("nan")
    out["step_ms_median"] = med
    out["train_tok_s"] = data.batch_size * data.seq_len / (med / 1e3)
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"15a {strategy} {shape}: step {h['step']} loss {h['loss']} grad_norm {h['grad_norm']}")
    if ref is None:
        out["snaps"] = snaps
    else:
        out["param_update_rel"] = param_rel
        out["read"] = {
            "loss": max(abs(a - b) / abs(b) for a, b in zip(out["loss"], ref["loss"])),
            "grad_norm": max(abs(a - b) / abs(b) for a, b in zip(out["grad_norm"], ref["grad_norm"])),
            "grad_direction": max(out["grad_direction"].values()),
        }
    shutil.rmtree(ckpt, ignore_errors=True)
    del tr, ms
    return out


def mesh_training(full, seed, smi, kernels, device="cuda"):
    """(a) Full-width sparse qwen3-1.7b (bf16, seed 0) through ``Trainer`` on
    the meshes of ``MESH_TRAIN``, every position the card, at B = 4, S =
    2048: 1 warm-up and 2 timed steps each, from one state dict. Each mesh
    against (1, 1): its losses, grad norms and first-step gradient by
    parameter kind within ``MESH_TOL``, its parameters after each step
    beside (1, 1)'s update (printed, not held: bf16 rounding and AdamW's
    sign-like first step flip near-zero updates), its step ms, tokens/s,
    peak memory, positions and distinct devices. Then each of
    ``MESH_FAULTS`` for one step (its first step reads both faults): it
    must read above ``MESH_TOL``. The kernels' counts are set to 0 after each run's warm-up step and read
    after its last: both training kernels must launch, the paged read
    never."""
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import OptConfig

    t0 = time.perf_counter()
    sd = T.init_model(full, seed=seed, device=device).state_dict()
    log(f"[15a] full-width qwen3-1.7b sparse weights in {time.perf_counter() - t0:.1f} s (shared by every mesh)")
    data = SyntheticLM(full.vocab_size, 2048, 4, seed=seed)
    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    runs, ref = {}, None
    for strategy, shape in MESH_TRAIN:
        row = mesh_run(full, sd, data, opt, strategy, shape, device, kernels, ref=ref)
        key = f"{strategy} {tuple(shape)}"
        if ref is None:
            ref = row
        for name in ("bsr_matmul", "block_sparse_attention"):
            if device == "cuda" and row["launches"][name] <= 0:
                raise AssertionError(f"15a: kernel {name} was never launched at {key}")
        if row["launches"]["paged_decode_attention"]:
            raise AssertionError(f"15a: paged_decode_attention launched in training at {key}")
        read = row.get("read", {})
        log(f"[15a] {key} ({row['positions']} position(s) on {row['distinct_devices']} device(s); {smi}): "
            f"steps {', '.join(f'{x:.1f}' for x in row['step_ms'])} ms (median {row['step_ms_median']:.1f}, "
            f"{row['train_tok_s']:.0f} train tokens/s), peak memory {row.get('max_memory_allocated_gb', 0):.2f} GB; "
            f"losses {', '.join(f'{x:.6f}' for x in row['loss'])}, grad norms "
            f"{', '.join(f'{x:.6f}' for x in row['grad_norm'])}; launches {row['launches']}")
        if read:
            log(f"[15a] {key} vs (1, 1): loss {read['loss']:.3e} (tol {MESH_TOL['loss']:g}), grad norm "
                f"{read['grad_norm']:.3e} (tol {MESH_TOL['grad_norm']:g}), first-step gradient direction "
                f"{read['grad_direction']:.3e} (tol {MESH_TOL['grad_direction']:g}; by kind "
                + ", ".join(f"{k} {v:.2e}" for k, v in row["grad_direction"].items())
                + "); parameters after each step vs (1, 1)'s, relative to its update: max "
                + ", ".join(f"{x['max']:.3f}" for x in row["param_update_rel"]) + "; l2 "
                + ", ".join(f"{x['l2']:.4f}" for x in row["param_update_rel"]))
            bad = {k: v for k, v in read.items() if v > MESH_TOL[k]}
            if bad:
                raise AssertionError(f"15a: {key} off (1, 1) by {bad} (tol {MESH_TOL})")
        runs[key] = {k: v for k, v in row.items() if k not in ("snaps", "mu")}
    faults = {}
    for kind, strategy, shape in MESH_FAULTS:
        row = mesh_run(full, sd, data, opt, strategy, shape, device, kernels, ref=ref, fault=kind, steps=1)
        read = row["read"]
        over = {k: v / MESH_TOL[k] for k, v in read.items()}
        log(f"[15a] a planted {kind} fault at {strategy} {tuple(shape)}: vs (1, 1) loss {read['loss']:.3e}, grad "
            f"norm {read['grad_norm']:.3e}, gradient direction {read['grad_direction']:.3e} ("
            + ", ".join(f"{k} {v:.1f}x" for k, v in over.items()) + " its tolerance)")
        if max(over.values()) <= 1.0:
            raise AssertionError(f"15a: a planted {kind} fault reads {read}, within {MESH_TOL}")
        faults[kind] = {k: v for k, v in row.items() if k not in ("snaps", "mu")}
    del ref, sd
    if device == "cuda":
        torch.cuda.empty_cache()
    launches = {name: sum(r["launches"][name] for r in runs.values()) for name in kernels}
    return {"runs": runs, "faults": faults, "tol": MESH_TOL, "launches": launches, "card": smi}


def mesh_kernels(timer, full, seed):
    """(b) The two training kernels at the shard shapes 15a adds, against
    their plain versions and timed as phase 3 times them: ``bsr_matmul``
    forward and dX (on the transposed pattern, its padding share reported)
    for q, k/v, gate/up and down at an fsdp (2, 1) position's M = 4096 and
    at a tp 2 shard's block rows (rank 0 timed, rank 1 checked) at M =
    8192, where dX runs on the transposed pattern of a row slice over all
    input blocks; ``block_sparse_attention`` at H = 8, Hk = 4, B = 4 (tp 2)
    and H = 16, Hk = 8, B = 2 (fsdp 2)."""
    from repro_torch.kernels import autograd as AG
    from repro_torch.models import layers as L

    specs = {
        "q": L.linear_spec(full, full.d_model, full.q_dim, False),
        "k/v": L.linear_spec(full, full.d_model, full.kv_dim, False),
        "gate/up": L.linear_spec(full, full.d_model, full.d_ff, False),
        "down": L.linear_spec(full, full.d_ff, full.d_model, False),
    }
    out = {"bsr_matmul": [], "block_sparse_attention": []}
    for label, spec in specs.items():
        pat = spec.pattern()
        nb_in = spec.in_features // pat.block
        for where, m, tp in (("fsdp (2, 1) position", 4096, 1), ("tp 2 shard", 8192, 2)):
            nb = pat.nb_out // tp
            g = torch.Generator(device="cuda").manual_seed(seed + 150 + m + tp)
            x = torch.randn((m, spec.in_features), generator=g, device="cuda").to(torch.bfloat16)
            dy = torch.randn((m, nb * pat.block), generator=g, device="cuda").to(torch.bfloat16)
            for r in range(tp):
                blocks = (torch.randn((nb, pat.r, pat.block, pat.block), generator=g, device="cuda")
                          / math.sqrt(pat.r * pat.block)).to(torch.bfloat16)
                tables = AG.bsr_tables(pat.cols[r * nb : (r + 1) * nb], nb_in, "cuda")
                fwd = bsr_row(timer, x, blocks, tables.cols, spec.in_features, nb * pat.r, 2e-2,
                              f"{where} {label} rank {r}", timed=r == 0)
                bt = AG.transposed_blocks(blocks, tables)
                dx = bsr_row(timer, dy, bt, tables.cols_t, nb * pat.block, nb * pat.r, 2e-2,
                             f"{where} {label} dX rank {r}", timed=r == 0)
                if r:
                    continue
                real = float(tables.valid.float().mean())
                fwd.update(where=where, linear=label)
                dx.update(where=where, linear=label, transposed=list(tables.cols_t.shape), real_slot_share=real)
                fwd["pass"], dx["pass"] = "forward", "dX"
                out["bsr_matmul"] += [fwd, dx]
                for row in (fwd, dx):
                    log(f"[15b] bsr_matmul {where} {label:7s} {row['pass']:7s} {row['shape']}"
                        + (f" (transposed {tuple(tables.cols_t.shape)}, {real:.0%} real slots)" if row is dx else "")
                        + f": err {row['max_abs_err']:.2e} kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
                        f"x@dense {row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    for where, b, h, hk in (("tp 2 shard", 4, 8, 4), ("fsdp (2, 1) position", 2, 16, 8)):
        row = attention_case(timer, b=b, s=2048, h=h, hk=hk, d=128, block=128, dtype=torch.bfloat16,
                             seed=seed + 160 + b, tol=2e-2)
        row["where"] = where
        out["block_sparse_attention"].append(row)
        log(f"[15b] block_sparse_attention {where} {row['shape']}: err {row['max_abs_err']:.2e} (tol {row['tol']:g}) "
            f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms sdpa {row['library_ms']:.4f} ms "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return out


# ----------------------------------------------------------------------
# phase 16: the dry-run, and sharded contiguous prefill and decode
# ----------------------------------------------------------------------

DRYRUN_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"), ("qwen3-1.7b", "decode_32k"),
                ("musicgen-large", "train_4k"))
DRYRUN_REFUSED = ("deepseek-moe-16b", "train_4k", "item 17")
DRYRUN_MEM_TOL = 0.10  # |predicted / max_memory_allocated - 1|
SHARDED_MESHES = (("fsdp", (1, 1)), ("tp", (1, 2)), ("fsdp", (2, 1)))
SHARDED_FP32_TOL = 1e-4


def dryrun_rows():
    """(a) The dry-run's rows of ``DRYRUN_CELLS`` on the meta 16 x 16 mesh
    (counted on the host; nothing runs on the card), and the refusal of
    ``DRYRUN_REFUSED``. Run in a helper process from the script's start
    (``main``), beside the card's phases."""
    from repro_torch.launch import dryrun as D

    rows = {}
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = D.run_cell(arch, shape, verbose=False)
        r["wall_s"] = time.perf_counter() - t0
        rows[f"{arch} {shape}"] = r
    arch, shape, _ = DRYRUN_REFUSED
    try:
        D.run_cell(arch, shape, verbose=False)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"rows": rows, "refused": {"arch": arch, "shape": shape, "error": refusal}}


def check_dryrun_rows(out, smi):
    """(a)'s checks: every row ``ok`` with finite terms, and the refused cell
    naming its item."""
    for key, r in out["rows"].items():
        if not r["ok"] or not all(math.isfinite(r[k]) for k in ("compute_s", "memory_s", "collective_s")):
            raise AssertionError(f"16a: {key}: {r}")
        log(f"[16a] {key} on 16x16 ({r['strategy']}; counts, not times): bytes/device "
            f"{r['bytes_per_device'] / 1e9:.3f} GB temp + {r['argument_bytes_per_device'] / 1e9:.3f} GB arguments; "
            f"compute {r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} ms, collective "
            f"{r['collective_s'] * 1e3:.3f} ms -> {r['bottleneck']}; useful {r['useful_flops_ratio']:.4f}; "
            f"{r['wall_s']:.1f} s on the host")
    ref = out["refused"]
    if ref["error"] is None or DRYRUN_REFUSED[2] not in ref["error"]:
        raise AssertionError(f"16a: {ref['arch']} {ref['shape']} was not refused naming {DRYRUN_REFUSED[2]}: {ref}")
    log(f"[16a] {ref['arch']} {ref['shape']} refused: {ref['error']}")
    out["card"] = smi
    return out


def start_dryrun_rows():
    """(a) in a helper process (spawned: it never touches the card), started
    at the top of ``main`` so its host seconds overlap the card's phases.
    Returns (executor, future); phase 16 reads the future and shuts the
    executor down."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(dryrun_rows)


def dryrun_on_card(full, seed, smi):
    """(b) One full-width training step on the (1, 1) mesh, B = 4, S =
    2048, built by ``launch.dryrun.build_cell``: counted on the meta device
    and counted as it runs on the card (``roofline.counting``), FLOPs and
    bytes equal; and the meta prediction of its memory, argument + temp
    bytes, against ``max_memory_allocated`` after ``reset_peak_memory_stats``
    with only the step's state alive."""
    from repro_torch.analysis import roofline as R
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    from repro_torch.models import transformer as T

    shape = ShapeSpec("train_2k", 2048, 4, "train")
    t0 = time.perf_counter()
    meta = D.count_cell(full, shape, Mesh(("data", "model"), (1, 1), ["meta"]), strategy="fsdp", microbatches=1)
    meta_s = time.perf_counter() - t0
    gc_collect()
    sd = T.init_model(full, seed=seed, device="cuda").state_dict()
    cell = D.build_cell(full, shape, make_local_mesh(1, 1, ["cuda"]), strategy="fsdp", params=sd, microbatches=1)
    del sd
    gc_collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with R.counting() as tally:
        cell.run()
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    card = tally.cost()
    predicted = meta["argument_bytes"] + meta["temp_bytes"]
    row = {"meta_flops": meta["cost"].flops, "card_flops": card.flops, "meta_bytes": meta["cost"].bytes_accessed,
           "card_bytes": card.bytes_accessed, "argument_bytes": meta["argument_bytes"],
           "temp_bytes": meta["temp_bytes"], "card_temp_bytes": tally.peak_bytes, "resident_bytes": resident,
           "predicted_bytes": predicted, "max_memory_allocated": peak, "ratio": predicted / peak,
           "meta_s": meta_s, "card_count_s": card_s, "card": smi}
    del cell
    gc_collect()
    log(f"[16b] full-width qwen3-1.7b train step (1, 1), B=4 S=2048 ({smi}): FLOPs meta {row['meta_flops']:.6e} "
        f"card {row['card_flops']:.6e}; bytes meta {row['meta_bytes']:.6e} card {row['card_bytes']:.6e}; memory "
        f"predicted {predicted / 1e9:.3f} GB (arguments {row['argument_bytes'] / 1e9:.3f} + temp "
        f"{row['temp_bytes'] / 1e9:.3f}; the card's count of temp {row['card_temp_bytes'] / 1e9:.3f}) vs "
        f"max_memory_allocated {peak / 1e9:.3f} GB (resident before the step {resident / 1e9:.3f}): ratio "
        f"{row['ratio']:.4f} (tol {DRYRUN_MEM_TOL}); meta count {meta_s:.1f} s, card count {card_s:.1f} s")
    if (row["meta_flops"], row["meta_bytes"]) != (row["card_flops"], row["card_bytes"]):
        raise AssertionError(f"16b: the meta count differs from the card's: {row}")
    if abs(row["ratio"] - 1) > DRYRUN_MEM_TOL:
        raise AssertionError(f"16b: predicted memory {predicted} vs max_memory_allocated {peak}")
    return row


def gc_collect():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def sharded_contiguous(cfg, sd, seed, smi, tol, tag):
    """(d) ``transformer.prefill`` of 4 prompts of 512 tokens (max_len
    1024) then 8 greedy ``decode_step`` calls on a ``MeshState`` of each
    of ``SHARDED_MESHES`` (every position the card) against (1, 1): the
    prefill and every decode step's logits within ``tol``, the greedy
    tokens equal; then a planted "cols" shard fault at tp (1, 2)
    (``planted_fault`` on the replica's ``ShardedLM``), which must read
    above ``tol``."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training.loop import MeshState

    rng = np.random.default_rng(seed + 16)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 512)), dtype=torch.int32, device="cuda")

    def run(state):
        lp, caches = T.prefill(cfg, state, {"tokens": toks}, max_len=1024)
        logits, greedy, nxt = [lp.float()], [], lp.argmax(-1)
        for i in range(8):
            greedy.append(nxt.tolist())
            ld, _ = T.decode_step(cfg, state, caches, nxt, 512 + i)
            logits.append(ld.float())
            nxt = ld.argmax(-1)
        return logits, greedy

    rows, ref = {}, None
    for strategy, shape in SHARDED_MESHES:
        n = shape[0] * shape[1]
        state = MeshState(cfg, make_local_mesh(*shape, ["cuda"] * n), strategy, sd, copy=n > 1)
        t0 = time.perf_counter()
        logits, greedy = run(state)
        torch.cuda.synchronize()
        row = {"wall_s": time.perf_counter() - t0}
        if not all(torch.isfinite(x).all() and x.shape == (4, cfg.padded_vocab) for x in logits):
            raise AssertionError(f"{tag}: {strategy} {shape}: logits not finite or of the wrong shape")
        if ref is None:
            ref = (logits, greedy)
        row["max_abs_err"] = max((a - b).abs().max().item() for a, b in zip(logits, ref[0]))
        row["greedy_equal"] = greedy == ref[1]
        if strategy == "tp":
            with planted_fault(state._models[(0, cfg)], "cols"):
                bad, _ = run(state)
            row["planted_cols_fault"] = max((a - b).abs().max().item() for a, b in zip(bad, ref[0]))
        rows[f"{strategy} {shape}"] = row
        log(f"[{tag}] {cfg.name} {cfg.dtype} {strategy} {shape} ({smi}): prefill + 8 decode steps logits vs (1, 1) "
            f"{row['max_abs_err']:.4g} (tol {tol}), greedy equal {row['greedy_equal']}"
            + (f", planted cols fault {row['planted_cols_fault']:.4g}" if "planted_cols_fault" in row else "")
            + f"; {row['wall_s']:.2f} s")
        if row["max_abs_err"] > tol or not row["greedy_equal"]:
            raise AssertionError(f"{tag}: {strategy} {shape} differs from (1, 1): {row}")
        if "planted_cols_fault" in row and row["planted_cols_fault"] <= tol:
            raise AssertionError(f"{tag}: a planted cols fault reads {row['planted_cols_fault']}, within {tol}")
        del state
    return rows


def engine_rooflines(full, seed, smi):
    """(c) ``Engine.roofline()`` of phase 14a's engines (``EngineConfig(
    max_slots=8, max_len=2048)``, tp 1 and tp 2 on one state dict): the tp 2
    record must be available, with collective bytes above 0."""
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig

    sd = T.init_model(full, seed=seed, device="cuda").state_dict()
    recs = {}
    for tp in (1, 2):
        eng = Engine(full, engine_cfg=EngineConfig(max_slots=8, max_len=2048), params=sd, mesh=make_tp_mesh(tp))
        recs[tp] = eng.roofline()
        del eng
    del sd
    gc_collect()
    one, two = recs[1], recs[2]
    log(f"[16c] Engine.roofline() ({smi}; counts): tp 1 {one['flops']:.6e} FLOPs, {one['bytes_accessed']:.6e} bytes; "
        f"tp 2 a device {two['flops']:.6e} FLOPs, {two['bytes_accessed']:.6e} bytes, collective "
        f"{two['collective_bytes']:.6e} bytes ({two['collective_s'] * 1e3:.4f} ms at one NVLink), bound "
        f"{two['bottleneck']}")
    if not (two["available"] and two["collective_bytes"] > 0):
        raise AssertionError(f"16c: the tp 2 engine's roofline: {two}")
    return {"tp1": one, "tp2": two, "card": smi}


def dryrun_phase(full, seed, smi, kernels, rows=None):
    """Phase 16: (a) (``rows``: the helper process's future, else run here),
    then (c), (b) and (d) on the card with the kernels' counts set to 0
    just before and read just after."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    out = {"dryrun": check_dryrun_rows(dryrun_rows() if rows is None else rows.result(timeout=600), smi)}
    log(f"[16a] rows ready after {time.perf_counter() - t0:.1f} s more in phase 16")
    for k in kernels.values():
        k.launches = 0
    out["engine_roofline"] = engine_rooflines(full, seed, smi)
    out["card_count"] = dryrun_on_card(full, seed, smi)
    smoke = registry.get_smoke("qwen3-1.7b", sparse=True)
    out["sharded_smoke"] = sharded_contiguous(
        smoke, T.init_model(smoke, seed=seed, device="cuda").state_dict(), seed, smi, SHARDED_FP32_TOL, "16d")
    sd = T.init_model(full, seed=seed, device="cuda").state_dict()
    out["sharded_full"] = sharded_contiguous(full, sd, seed, smi, TP_LOGIT_TOL, "16d")
    del sd
    gc_collect()
    out["launches"] = {name: k.launches for name, k in kernels.items()}
    for name, n in out["launches"].items():
        if n <= 0:
            raise AssertionError(f"16: kernel {name} was never launched in phase 16")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=str(ROOT / "build" / "chip_smoke.json"),
                        help="where the full JSON report goes")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    dry_pool, dry_rows = start_dryrun_rows()  # phase 16a, on the host beside the card's phases

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsr_attention, bsr_matmul, paged_attention
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig

    report: dict = {}

    # ---- 1. device ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    report["card"] = smi
    report["torch"] = torch.__version__

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    log(f"[2] built {len(libs)} kernels in {build_s:.1f} s into {_build.BUILD_DIR}")
    for src, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2]   {src}: {line.strip()}")
    report["build_s"] = build_s

    # ---- 3. kernels against plain versions -------------------------
    timer = Timer()
    full = registry.get("qwen3-1.7b", sparse=True)
    specs = {  # one layer's seven linears
        "q": L.linear_spec(full, full.d_model, full.q_dim, False),
        "k": L.linear_spec(full, full.d_model, full.kv_dim, False),
        "v": L.linear_spec(full, full.d_model, full.kv_dim, False),
        "o": L.linear_spec(full, full.q_dim, full.d_model, False),
        "gate": L.linear_spec(full, full.d_model, full.d_ff, False),
        "up": L.linear_spec(full, full.d_model, full.d_ff, False),
        "down": L.linear_spec(full, full.d_ff, full.d_model, False),
    }
    # the distinct shapes (k and v, gate and up share one)
    distinct = {"q": specs["q"], "k/v": specs["k"], "o": specs["o"],
                "gate/up": specs["gate"], "down": specs["down"]}
    bsr_rows = []
    for m in (8, 4096):
        for label, spec in distinct.items():
            row = bsr_case(timer, spec, m, torch.bfloat16, seed=m, tol=2e-2)
            row["linear"] = label
            bsr_rows.append(row)
            log(f"[3] bsr_matmul {label:7s} {row['shape']}: err {row['max_abs_err']:.2e} (tol {row['tol']:g}) "
                f"kernel {row['ms']:.4f} ms (host {row['host_us']:.1f} us, through BsrMatmul "
                f"{row['function_host_us']:.1f} us) plain {row['plain_ms']:.4f} ms "
                f"x@dense {row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']}) "
                f"digest {row['out_sha256']}")
    smoke = registry.get_smoke("qwen3-1.7b", sparse=True)
    small_bsr = bsr_case(timer, L.linear_spec(smoke, 512, 256, False),
                         37, torch.float32, seed=1, tol=1e-4)
    log(f"[3] bsr_matmul fp32 {small_bsr['shape']}: err {small_bsr['max_abs_err']:.2e} (tol 1e-4) "
        f"digest {small_bsr['out_sha256']}")
    # one decode step's layer: q, k, v, o, gate, up, down at M = 8
    by_label = {r["linear"]: r for r in bsr_rows if r["shape"].startswith("M=8 ")}
    layer = [by_label[x] for x in ("q", "k/v", "k/v", "o", "gate/up", "gate/up", "down")]

    paged_shape = dict(b=8, hk=8, g=2, d=128, page=128, pps=16, dtype=torch.bfloat16, tol=1e-2)
    paged_main = paged_case(timer, seed=2, **paged_shape)
    # where the split matters most: all 7 scheduled pages visible, and the
    # dense schedule's 16 pages a slot
    paged_full = paged_case(timer, seed=6, full=True, **paged_shape)
    paged_dense = paged_case(timer, seed=7, schedule="dense", **paged_shape)
    paged_small = paged_case(timer, b=4, hk=2, g=2, d=64, page=16, pps=6,
                             dtype=torch.float32, seed=3, tol=1e-5)
    for row in (paged_main, paged_full, paged_dense, paged_small):
        log(f"[3] paged_decode_attention {row['dtype']} {row['shape']} ({row['case']}): "
            f"err {row['max_abs_err']:.2e} (tol {row['tol']:g}) "
            f"kernel {row['ms']:.4f} ms (host {row['host_us']:.1f} us) plain {row['plain_ms']:.4f} ms "
            f"sdpa {row['library_ms']:.4f} ms bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    attn_main = attention_case(timer, b=1, s=2048, h=16, hk=8, d=128, block=128,
                               dtype=torch.bfloat16, seed=4, tol=2e-2)
    attn_small = attention_case(timer, b=2, s=512, h=4, hk=2, d=64, block=64,
                                dtype=torch.float32, seed=5, tol=2e-4)
    for row in (attn_main, attn_small):
        log(f"[3] block_sparse_attention {row['dtype']} {row['shape']}: err {row['max_abs_err']:.2e} (tol {row['tol']:g}) "
            f"kernel {row['ms']:.4f} ms (host {row['host_us']:.1f} us) plain {row['plain_ms']:.4f} ms "
            f"sdpa {row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    report["bsr_matmul"] = bsr_rows + [small_bsr]
    report["paged_decode_attention"] = [paged_main, paged_full, paged_dense, paged_small]
    report["block_sparse_attention"] = [attn_main, attn_small]

    # ---- 4. smoke-width parity: CPU plain versions == CUDA kernels ---
    page = smoke.attn_block
    rng = np.random.default_rng(args.seed)
    work = [(rng.integers(0, smoke.vocab_size, n).astype(np.int32), 6)
            for n in (9 * page + 20, 2 * page + 1, 40, 14 * page + 3)]

    cpu_streams, cuda_streams = (smoke_greedy_streams(smoke, work, args.seed, dev) for dev in ("cpu", "cuda"))
    if cpu_streams != cuda_streams:
        raise AssertionError(f"smoke streams differ: cpu {cpu_streams} cuda {cuda_streams}")
    log(f"[4] smoke-width sparse fp32: CPU and CUDA greedy streams equal over "
        f"{len(work)} requests (max_len {16 * page}, pages skipped by the schedule)")
    for name, fn in smoke_workloads(smoke, args.seed).items():
        got = {dev: fn(dev) for dev in ("cpu", "cuda")}
        if got["cpu"] != got["cuda"]:
            raise AssertionError(f"smoke {name} streams differ: cpu {got['cpu']} cuda {got['cuda']}")
        log(f"[4] smoke-width {name}: CPU and CUDA streams equal over {len(got['cpu']['streams'])} "
            f"requests ({', '.join(f'{k} {v}' for k, v in got['cpu'].items() if k != 'streams')})")

    # ---- 5. full-width serving ---------------------------------------
    t0 = time.perf_counter()
    eng = Engine(full, engine_cfg=EngineConfig(max_slots=8, max_len=2048), seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"[5] full-width qwen3-1.7b sparse: weights {time.perf_counter() - t0:.1f} s, "
        f"KV pools {eng.kv.memory_bytes() / 1e9:.2f} GB")
    # warm-up request (cuBLAS heuristics, allocator), not counted
    eng.submit(rng.integers(0, full.vocab_size, 300).astype(np.int32), 4)
    eng.drain(max_steps=50)
    eng.reset_stats()
    kernels = {
        "bsr_matmul": bsr_matmul.KERNEL,
        "paged_decode_attention": paged_attention.KERNEL,
        "block_sparse_attention": bsr_attention.KERNEL,
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plens = rng.integers(200, 1001, 12)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    for n in plens:
        eng.submit(rng.integers(0, full.vocab_size, int(n)).astype(np.int32), 32)
    fins = eng.drain(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    st = engine_stats(eng)
    if len(fins) != 12 or any(f.finish_reason != "length" or len(f.tokens) != 32 for f in fins):
        raise AssertionError(f"not every request finished with 32 tokens: "
                             f"{[(f.finish_reason, len(f.tokens)) for f in fins]}")
    if any(not (0 <= t < full.padded_vocab) for f in fins for t in f.tokens):
        raise AssertionError("token id out of range")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    per_layer = 7 * full.num_layers
    if launches["bsr_matmul"] < per_layer * (st["decode_steps"] + st["prefill_calls"]):
        raise AssertionError(f"bsr_matmul launched {launches['bsr_matmul']} times, fewer than "
                             f"7 x 28 per decode step and prefill call")
    # the model's own output check: full-width logits finite, right shape
    n_tok = 2 * full.attn_block
    cache = T.init_paged_cache(full, 3, full.attn_block, device="cuda")
    toks = torch.as_tensor(rng.integers(0, full.vocab_size, (1, n_tok)), device="cuda")
    logits, _ = T.prefill_paged(full, eng.model, toks, torch.tensor([n_tok], device="cuda"),
                                cache, torch.tensor([[1, 2]], device="cuda"))
    if logits.shape != (1, full.padded_vocab) or not torch.isfinite(logits).all():
        raise AssertionError("full-width logits not finite or of the wrong shape")
    steps = sorted(st["decode_step_s"])
    ttft = sorted(st["ttft_s"])
    serving = {
        "requests": len(fins),
        "prompt_tokens": int(plens.sum()),
        "prefill_calls": st["prefill_calls"],
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "decode_steps": st["decode_steps"],
        "decode_tok_s": st["decode_tokens"] / sum(steps),
        "decode_step_ms_p50": 1e3 * steps[len(steps) // 2],
        "ttft_ms_p50": 1e3 * ttft[len(ttft) // 2],
        # the greedy streams in submission order: equal digests, equal tokens
        "streams_sha256": digest(torch.as_tensor(np.concatenate(
            [f.tokens for f in sorted(fins, key=lambda f: f.uid)]).astype(np.int64))),
        "wall_s": wall,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "card": smi,
    }
    report["serving"] = serving
    log(f"[5] served {len(fins)} requests ({int(plens.sum())} prompt tokens, 32 new each) in {wall:.2f} s "
        f"on {smi}: prefill {serving['prefill_tok_s']:.0f} tok/s over {st['prefill_calls']} calls, "
        f"decode {serving['decode_tok_s']:.1f} tok/s, decode step p50 {serving['decode_step_ms_p50']:.2f} ms, "
        f"TTFT p50 {serving['ttft_ms_p50']:.1f} ms, peak memory {serving['max_memory_allocated_gb']:.2f} GB")
    log(f"[5] launches on the main path: {launches} over {st['decode_steps']} decode steps; "
        f"streams digest {serving['streams_sha256']}")

    # where a decode step's time goes: a profiled window of 4 steps with
    # all 8 slots decoding (device busy share and the top kernels)
    for _ in range(8):
        eng.submit(rng.integers(0, full.vocab_size, 128).astype(np.int32), 12)
    eng.step()  # admission + the first decode step

    def four_steps():
        for _ in range(4):
            eng.step()

    serving["profile"] = {"window_steps": 4, **profiled("4 decode steps", four_steps)}
    eng.drain(max_steps=50)

    # where a prefill call's time goes: one prefill_paged call, as the
    # engine makes it, of 4 prompts of 1024 tokens (M = 4096 rows through
    # every linear, attention at S = 1024), after one unprofiled call
    n_seq, s_len = 4, 1024
    per_seq = s_len // full.attn_block
    pcache = T.init_paged_cache(full, n_seq * per_seq + 1, full.attn_block, device="cuda")
    pargs = (
        torch.as_tensor(rng.integers(0, full.vocab_size, (n_seq, s_len)), dtype=torch.int32, device="cuda"),
        torch.full((n_seq,), s_len, dtype=torch.int32, device="cuda"),
    )
    prows = torch.arange(1, n_seq * per_seq + 1, dtype=torch.int32, device="cuda").reshape(n_seq, per_seq)

    def one_prefill():
        nonlocal pcache
        logits, pcache = T.prefill_paged(full, eng.model, *pargs, pcache, prows)
        torch.argmax(logits, dim=-1).cpu()  # the engine's one host fetch

    one_prefill()
    serving["prefill_profile"] = {
        "shape": f"N={n_seq} S={s_len}", **profiled(f"one prefill call (N={n_seq}, S={s_len})", one_prefill)
    }
    del pcache

    # ---- 6. full width: sampling, prefix cache, preemption ----------
    report["features"] = full_width_features(
        full, eng.model.state_dict(), kernels, rng, args.seed, smi, timer
    )
    del eng

    # ---- 7. training ------------------------------------------------
    report["training"] = {
        "grads": grad_cases(timer, full, args.seed),
        "smoke_step": smoke_step_cpu_vs_card(smoke),
        "full_width": full_width_training(full, args.seed, smi, kernels),
        "checkpoint": smoke_checkpoint_round_trip(smoke),
    }

    # ---- 8. the rest of the dense family; dense against pixelfly ----
    t8 = time.perf_counter()
    family = {"kernels": family_kernels(timer, args.seed), "smoke": family_smoke(args.seed)}
    for arch in FAMILY:
        family[arch] = family_full_width(arch, args.seed, smi, kernels)
    family["dense_vs_pixelfly"] = dense_vs_pixelfly(args.seed)
    family["wall_s"] = time.perf_counter() - t8
    report["family"] = family
    log(f"[8] phase 8 took {family['wall_s']:.1f} s")

    # ---- 9. the serve CLI, the Server oracle, observability ---------
    t9 = time.perf_counter()
    cli = {"cli": serve_cli_full_width(full, kernels, smi), "legacy": legacy_server(kernels, smi)}
    cli["cost"], traced = observability_cost(full, args.seed, smi)
    step_s = statistics.median(t["decode_step_ms_p50"] for t in cli["cost"]["turns"] if t["traced"]) / 1e3
    cli["replay"] = burst_replay(full, traced, step_s, smi)
    del traced
    torch.cuda.empty_cache()
    cli["wall_s"] = time.perf_counter() - t9
    report["serve"] = cli
    log(f"[9] phase 9 took {cli['wall_s']:.1f} s")

    # ---- 10. vision, the other benchmarks, bsr_matmul at b < 64 ----
    t10 = time.perf_counter()
    vision = {"kernels": small_block_kernels(Timer(iters=10), args.seed), "smoke": vision_smoke(args.seed),
              "b16": vision_b16(args.seed, smi, kernels), "benches": vision_benches(args.seed),
              "ablation": ablation_smoke(kernels)}
    vision["wall_s"] = time.perf_counter() - t10
    report["vision"] = vision
    log(f"[10] phase 10 took {vision['wall_s']:.1f} s")
    # ViT-B/16's four linears at the training M in bf16: forward and dX
    vit_m = small_block_linears()[32][1][-1]
    vit_fwd = [r for r in vision["kernels"] if r["block"] == 32 and r["m"] == vit_m
               and r["dtype"] == "bfloat16" and r["pass"] == "forward"]

    # ---- 11. the vlm and audio backbones, the bench twin, the example
    t11 = time.perf_counter()
    vlm = {"kernels": arch_kernels(timer, args.seed, VLM_AUDIO, "11a"), "smoke": vlm_audio_smoke(args.seed)}
    for arch in VLM_AUDIO:
        vlm[arch] = family_full_width(arch, args.seed, smi, kernels, tag="11c" if arch == "qwen2-vl-7b" else "11d",
                                      traced=True)
        torch.cuda.empty_cache()
    vlm["bench"] = serve_bench_full_width(kernels, smi)
    vlm["example"] = serve_example(kernels)
    vlm["wall_s"] = time.perf_counter() - t11
    report["vlm_audio"] = vlm
    log(f"[11] phase 11 took {vlm['wall_s']:.1f} s")

    # ---- 12. the MoE, SSM and hybrid families ----------------------
    t12 = time.perf_counter()
    moe_ssm = {"kernels": moe_ssm_kernels(timer, args.seed), "smoke": moe_ssm_smoke(args.seed)}
    for arch in MOE_SSM:
        moe_ssm[arch] = moe_ssm_full_width(arch, args.seed, smi, kernels)
    moe_ssm["wall_s"] = time.perf_counter() - t12
    report["moe_ssm"] = moe_ssm
    log(f"[12] phase 12 took {moe_ssm['wall_s']:.1f} s")
    zamba_attn = [r for r in moe_ssm["kernels"]["block_sparse_attention"] if r["arch"] == "zamba2-2.7b"]

    # ---- 13. the analysis instruments, the router, the tools --------
    t13 = time.perf_counter()
    analysis, eng = guarded_decode(full, args.seed, smi, kernels)
    analysis["router"] = router_streams(full, eng, args.seed, smi, kernels)
    del eng
    torch.cuda.empty_cache()
    analysis["training_step"] = guarded_training_step(full, args.seed, smi, kernels)
    analysis["tools"] = tools_on_card(kernels)
    analysis["wall_s"] = time.perf_counter() - t13
    report["analysis"] = analysis
    log(f"[13] phase 13 took {analysis['wall_s']:.1f} s")

    # ---- 14. tensor-parallel serving --------------------------------
    t14 = time.perf_counter()
    tp_report, tp_sd, tp_engines, _ = tp_serving(full, args.seed, smi, kernels)
    tp = {"serving": tp_report, "kernels": tp_kernels(timer, full, args.seed)}
    tp["router"] = tp_router(full, tp_sd, tp_engines[2], args.seed, smi, kernels)
    del tp_engines
    torch.cuda.empty_cache()
    tp["bench"] = tp_bench(tp_sd, smi, kernels)
    del tp_sd
    torch.cuda.empty_cache()
    tp["wall_s"] = time.perf_counter() - t14
    report["tensor_parallel"] = tp
    log(f"[14] phase 14 took {tp['wall_s']:.1f} s")

    # ---- 15. training on a mesh -------------------------------------
    t15 = time.perf_counter()
    mesh_train = {"training": mesh_training(full, args.seed, smi, kernels),
                  "kernels": mesh_kernels(timer, full, args.seed)}
    mesh_train["wall_s"] = time.perf_counter() - t15
    report["mesh_training"] = mesh_train
    log(f"[15] phase 15 took {mesh_train['wall_s']:.1f} s")

    # ---- 16. the dry-run, sharded contiguous prefill and decode -----
    t16 = time.perf_counter()
    try:
        dry = dryrun_phase(full, args.seed, smi, kernels, dry_rows)
    finally:
        dry_pool.shutdown(cancel_futures=True)
    dry["wall_s"] = time.perf_counter() - t16
    report["dryrun"] = dry
    log(f"[16] phase 16 took {dry['wall_s']:.1f} s")

    # ---- 17. report ------------------------------------------------
    def summed(rows, key):
        return sum(r[key] for r in rows)

    line = {"kernels": [
        {
            "name": "bsr_matmul",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_matmul.cu",
            "replaces": "src/repro/kernels/bsr_matmul.py:59",
            "shape": "one decode layer's 7 linears (q,k,v,o,gate,up,down) at M=8, bf16, summed",
            "launches": launches["bsr_matmul"],
            "max_abs_err": max(r["max_abs_err"] for r in bsr_rows),
            "ms": summed(layer, "ms"),
            "plain_ms": summed(layer, "plain_ms"),
            "bound_ms": summed(layer, "bound_ms"),
            "bound_by": "bytes",
            "library_ms": summed(layer, "library_ms"),
        },
        {
            "name": "paged_decode_attention",
            "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:109",
            "shape": paged_main["shape"] + ", bf16",
            "launches": launches["paged_decode_attention"],
            "max_abs_err": paged_main["max_abs_err"],
            "ms": paged_main["ms"],
            "plain_ms": paged_main["plain_ms"],
            "bound_ms": paged_main["bound_ms"],
            "bound_by": paged_main["bound_by"],
            "library_ms": paged_main["library_ms"],
        },
        {
            "name": "block_sparse_attention",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_attention.cu",
            "replaces": "src/repro/kernels/bsr_attention.py:100",
            "shape": attn_main["shape"] + ", bf16",
            "launches": launches["block_sparse_attention"],
            "max_abs_err": attn_main["max_abs_err"],
            "ms": attn_main["ms"],
            "plain_ms": attn_main["plain_ms"],
            "bound_ms": attn_main["bound_ms"],
            "bound_by": attn_main["bound_by"],
            "library_ms": attn_main["library_ms"],
        },
        {
            "name": "bsr_matmul_b32",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_matmul.cu",
            "replaces": "src/repro/kernels/bsr_matmul.py:59",
            "shape": "ViT-B/16's qkv, proj, fc1, fc2 forward at b=32, M=25216, bf16, summed (the tensor-core "
                     "kernel for several output blocks a thread block)",
            "launches": vision["b16"]["launches"]["bsr_matmul"],
            "max_abs_err": max(r["max_abs_err"] for r in vision["kernels"]),
            "ms": summed(vit_fwd, "ms"),
            "plain_ms": summed(vit_fwd, "plain_ms"),
            "bound_ms": summed(vit_fwd, "bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in vit_fwd) else "operations",
            "library_ms": summed(vit_fwd, "library_ms"),
        },
        {
            "name": "block_sparse_attention_d80",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bsr_attention.cu",
            "replaces": "src/repro/kernels/bsr_attention.py:100",
            "shape": zamba_attn[0]["shape"] + ", bf16 (zamba2-2.7b's head dim, phase 12)",
            "launches": sum(moe_ssm["zamba2-2.7b"][part]["launches"]["block_sparse_attention"]
                            for part in ("serving", "training")),
            "max_abs_err": zamba_attn[0]["max_abs_err"],
            "ms": zamba_attn[0]["ms"],
            "plain_ms": zamba_attn[0]["plain_ms"],
            "bound_ms": zamba_attn[0]["bound_ms"],
            "bound_by": zamba_attn[0]["bound_by"],
            "library_ms": zamba_attn[0]["library_ms"],
        },
    ]}
    for k in line["kernels"][:3]:  # the launches of phases 6 to 14, counted apart
        k["launches_phase6"] = report["features"]["launches"][k["name"]]
        k["launches_phase9"] = cli["cli"]["launches"][k["name"]]
        k["launches_training"] = report["training"]["full_width"]["launches"][k["name"]]
        k["launches_phase8"] = sum(family[a][part]["launches"][k["name"]]
                                   for a in FAMILY for part in ("serving", "training"))
        k["launches_phase10"] = vision["b16"]["launches"][k["name"]] + vision["ablation"]["launches"][k["name"]]
        k["launches_phase11"] = (sum(vlm[a][part]["launches"][k["name"]] for a in VLM_AUDIO
                                     for part in ("serving", "training"))
                                 + vlm["bench"]["launches"][k["name"]] + vlm["example"]["launches"][k["name"]])
        k["launches_phase12"] = sum(moe_ssm[a][part]["launches"][k["name"]] for a in MOE_SSM
                                    for part in ("serving", "training"))
        k["launches_phase13"] = (analysis["launches"][k["name"]] + analysis["router"]["launches"][k["name"]]
                                 + analysis["training_step"]["launches"][k["name"]]
                                 + analysis["tools"]["launches"][k["name"]])
        k["launches_phase14"] = (sum(r["launches"][k["name"]] for r in tp["serving"].values())
                                 + tp["router"]["launches"][k["name"]] + tp["bench"]["launches"][k["name"]])
        if k["name"] != "paged_decode_attention":  # training on a mesh runs the other two
            k["launches_phase15"] = mesh_train["training"]["launches"][k["name"]]
        k["launches_phase16"] = dry["launches"][k["name"]]
    report["kernels"] = line["kernels"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    if not paged_main["ms"] < paged_main["library_ms"]:
        raise AssertionError(f"paged_decode_attention {paged_main['ms']:.4f} ms is not below "
                             f"SDPA's {paged_main['library_ms']:.4f} ms on the same inputs")
    report["wall_s"] = time.perf_counter() - T_START
    out.write_text(json.dumps(report, indent=1))
    log(f"[17] chip_smoke.py took {report['wall_s']:.1f} s")
    log(f"card: {smi}")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
