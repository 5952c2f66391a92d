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
   streams, with a max_len whose sparse decode schedule skips pages.
5. Full width: ``Engine(registry.get("qwen3-1.7b", sparse=True))`` with
   ``EngineConfig(max_slots=8, max_len=2048)`` serves 12 requests (prompt
   lengths 200-1000 from --seed, 32 new tokens each) with every kernel's
   launch count reset just before; each kernel must have launched. Then
   two profiled windows (device busy share, top kernels, the port's
   kernels by name): 4 decode steps with 8 slots busy, and one prefill
   call of 4 prompts of 1024 tokens.
6. The kernels line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

It imports nothing of JAX and nothing of the JAX package ``src/repro``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------


def bsr_case(timer, lin_spec, m, dtype, seed, tol):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsr_matmul import bsr_matmul_cuda

    pat = lin_spec.pattern()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, lin_spec.in_features), generator=g, device="cuda").to(dtype)
    blocks = (
        torch.randn((pat.nb_out, pat.r, pat.block, pat.block), generator=g, device="cuda")
        / math.sqrt(pat.r * pat.block)
    ).to(dtype)
    cols = torch.as_tensor(pat.cols, device="cuda")
    y = bsr_matmul_cuda(x, blocks, cols)
    torch.cuda.synchronize()
    err = check_close(f"bsr_matmul {lin_spec.in_features}->{lin_spec.out_features} M={m}",
                      y, ref.bsr_matmul_gather(x, blocks, cols), tol)
    dense = ref.bsr_to_dense(blocks, cols, lin_spec.in_features)
    es = x.element_size()
    nbytes = (m * lin_spec.in_features + blocks.numel() + m * lin_spec.out_features) * es + cols.numel() * 4
    flops = 2.0 * m * pat.nb_out * pat.r * pat.block * pat.block
    b_ms, b_by = bound_ms(nbytes, flops, str(dtype).split(".")[1])
    return {
        "shape": f"M={m} n_in={lin_spec.in_features} nb_out={pat.nb_out} r={pat.r} b={pat.block}",
        "dtype": str(dtype).split(".")[1],
        "max_abs_err": err,
        "tol": tol,
        "ms": timer.ms(lambda: bsr_matmul_cuda(x, blocks, cols)),
        "host_us": host_us(lambda: bsr_matmul_cuda(x, blocks, cols)),
        "plain_ms": timer.ms(lambda: ref.bsr_matmul_gather(x, blocks, cols)),
        "library_ms": timer.ms(lambda: x @ dense),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


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
    base = logical.long() * page
    n_vis = ((pos.long()[:, None] - base + 1).clamp(0, page) * keep.long()).sum().item()
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * n_vis * hk * d) * es + 4 * (3 * phys.numel() + b)
    flops = 4.0 * g * d * n_vis * hk
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

    err = check_close(f"block_sparse_attention S={s} {dtype}", got, plain().reshape(b, s, h, d), tol)
    # causal-visible (q, k) pairs of the schedule
    pairs = 0
    for i in range(sched.nqb):
        for t in range(sched.max_nkv):
            if sched.valid[i, t]:
                j = int(sched.kv_index[i, t])
                pairs += block * block if j < i else block * (block + 1) // 2
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es + 8 * sched.kv_index.size
    flops = 4.0 * d * pairs * b * h
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
# main
# ----------------------------------------------------------------------


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
                f"kernel {row['ms']:.4f} ms (host {row['host_us']:.1f} us) plain {row['plain_ms']:.4f} ms "
                f"x@dense {row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    smoke = registry.get_smoke("qwen3-1.7b", sparse=True)
    small_bsr = bsr_case(timer, L.linear_spec(smoke, 512, 256, False),
                         37, torch.float32, seed=1, tol=1e-4)
    log(f"[3] bsr_matmul fp32 {small_bsr['shape']}: err {small_bsr['max_abs_err']:.2e} (tol 1e-4)")
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

    def serve(device):
        eng = Engine(smoke, engine_cfg=EngineConfig(max_slots=2, max_len=16 * page),
                     seed=args.seed, device=device)
        uids = {eng.submit(p, n): i for i, (p, n) in enumerate(work)}
        return {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=500)}

    cpu_streams, cuda_streams = serve("cpu"), serve("cuda")
    if cpu_streams != cuda_streams:
        raise AssertionError(f"smoke streams differ: cpu {cpu_streams} cuda {cuda_streams}")
    log(f"[4] smoke-width sparse fp32: CPU and CUDA greedy streams equal over "
        f"{len(work)} requests (max_len {16 * page}, pages skipped by the schedule)")

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
    st = eng.stats
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
    log(f"[5] launches on the main path: {launches} over {st['decode_steps']} decode steps")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    def profiled(label, fn):
        """Wall time, device busy share and the top device kernels of one
        window around fn (which ends in a synchronise)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        # device-side events only: an aten op's row repeats its kernels' time
        rows = sorted(
            (e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA),
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
        out = {
            "window_ms": window * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / window if busy_us else None,
            "top": [(e.key[:80], dev_us(e) / 1e3, e.count) for e in rows[:8] if dev_us(e) > 0],
            "ours": ours,
        }
        if busy_us:
            log(f"[5] profiled {label}: {window * 1e3:.1f} ms wall, device busy "
                f"{busy_us / 1e3:.1f} ms, idle share {out['device_idle_share']:.2f}")
            for name, ms, n in out["top"]:
                log(f"[5]   {ms:8.3f} ms  x{n:<5d} {name}")
            for name, o in ours.items():
                if o["launches"]:
                    log(f"[5]   port kernel {name}: {o['device_ms']:.3f} ms over {o['launches']} device "
                        f"launches ({1e3 * o['device_ms'] / o['launches']:.1f} us each) {o['kernels']}")
        else:
            log(f"[5] profiler recorded no device time for {label}: device busy share not measured")
        return out

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

    # ---- 6. report -------------------------------------------------
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
    ]}
    report["kernels"] = line["kernels"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    if not paged_main["ms"] < paged_main["library_ms"]:
        raise AssertionError(f"paged_decode_attention {paged_main['ms']:.4f} ms is not below "
                             f"SDPA's {paged_main['library_ms']:.4f} ms on the same inputs")
    log(f"card: {smi}")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
