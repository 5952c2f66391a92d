"""The paper's LM comparison on the port: train a dense decoder and its
pixelfly twin through ``Trainer`` and compare their step times.

    PYTHONPATH=src python -m repro_torch.bench.lm_speedup --arch smollm-360m \\
        --batch 8 --seq 2048 --steps 3 --out build/lm_speedup_smollm.json
    PYTHONPATH=src python -m repro_torch.bench.lm_speedup --smoke --device cpu --steps 3

The port's counterpart of ``benchmarks/lm_speedup.py`` (paper Fig 8 /
Table 5: sparse training "2.1x faster" at the dense model's perplexity).
For one architecture, the dense model (``registry.get(arch)``) and the
pixelfly one (``registry.get(arch, sparse=True)``) each take 2 warm-up
steps, ``--steps`` timed steps and one step traced on the device only, on
the same ``SyntheticLM`` stream, seed and ``OptConfig``, one after the
other: the first is freed before the second is built. Each arm records
its median step time and train tokens/s, parameter count, mean loss of
its last 5 steps (as the JAX script reports it), peak device memory, and
the traced step's device busy share and top device operations; the run
derives the speedup ``dense_ms / sparse_ms`` and the parameter ratio.
The loss of a few steps is reported, not judged: the claim is equal
perplexity at less wall clock, and only the step-time ratio transfers to
a run this short.

``--smoke`` takes a copy of the JAX script's reduced ``gpt2-bench`` config
(4 layers, d_model 256, vocab 512, fp32, block 64) at B = 8, S = 128.
On the CPU (``--device cpu``) the times are the CPU's and the device
metrics are null. The result goes to ``--out`` (default
``build/lm_speedup_<arch>.json``), never to ``BENCH_serve.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import statistics
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench.common import card_line, device_trace
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import TrainConfig, Trainer
from repro_torch.training.optimizer import OptConfig

__all__ = ["smoke_config", "run_arm", "compare", "main"]

ROOT = Path(__file__).resolve().parents[3]
WARMUP = 2


def smoke_config(sparse: bool) -> ModelConfig:
    """The JAX script's ``_cfg``: a reduced GPT-2-class decoder."""
    return ModelConfig(
        name="gpt2-bench", family="dense", num_layers=4, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=1024,
        vocab_size=512, dtype="float32", sparse=sparse,
        sparse_density=0.2, sparse_block=64, attn_block=64, attn_chunk=128,
        sparse_attention=sparse,
    )


def run_arm(
    cfg: ModelConfig,
    *,
    batch: int,
    seq: int,
    steps: int,
    lr: float,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Train ``cfg`` from ``seed`` for ``WARMUP`` + ``steps`` + 1 steps on
    ``SyntheticLM(cfg.vocab_size, seq, batch, seed)``; the last step is
    traced on the device only (on the card). Frees the model before it
    returns."""
    dev = T.resolve_device(device)
    on_card = dev.type == "cuda"
    ckpt = ROOT / "build" / "lm_speedup_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)  # nothing to restore: start from the seed
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(
        cfg,
        OptConfig(lr=lr, warmup_steps=2, total_steps=WARMUP + steps + 1),
        SyntheticLM(cfg.vocab_size, seq, batch, seed=seed),
        TrainConfig(ckpt_dir=str(ckpt), ckpt_every=10 ** 9, log_every=10 ** 9, seed=seed),
        device=dev,
    )
    hist = trainer.run(WARMUP + steps)
    trace = device_trace(lambda: hist.extend(trainer.run(1))) if on_card else None
    step_ms = [1e3 * h["step_time_s"] for h in hist[WARMUP : WARMUP + steps]]
    med = statistics.median(step_ms)
    out = {
        "config": cfg.name,
        "sparse": cfg.sparse,
        "parameters": sum(p.numel() for p in trainer.params.values()),
        "step_ms": step_ms,
        "step_ms_median": med,
        "train_tok_s": batch * seq / (med / 1e3),
        "loss": [h["loss"] for h in hist],
        "loss_last5_mean": float(np.mean([h["loss"] for h in hist[-5:]])),
        "grad_norm": [h["grad_norm"] for h in hist],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None,
        "device_trace": trace,
    }
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    return out


def compare(
    arch: str | None,
    *,
    batch: int,
    seq: int,
    steps: int,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Dense, then pixelfly, for ``arch`` at its published widths (AdamW
    lr 3e-4, as the full-width training of ``chip_smoke.py``), or for
    ``smoke_config`` when ``arch`` is None (lr 3e-3, as the JAX script)."""
    dev = T.resolve_device(device)
    if arch is None:
        cfgs, lr = (smoke_config(False), smoke_config(True)), 3e-3
    else:
        cfgs, lr = (registry.get(arch), registry.get(arch, sparse=True)), 3e-4
    dense, sparse = (run_arm(c, batch=batch, seq=seq, steps=steps, lr=lr, seed=seed, device=dev) for c in cfgs)
    out = {
        "arch": arch or cfgs[0].name,
        "batch": batch,
        "seq": seq,
        "warmup_steps": WARMUP,
        "timed_steps": steps,
        "lr": lr,
        "seed": seed,
        "device": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dense": dense,
        "sparse": sparse,
        "speedup": dense["step_ms_median"] / sparse["step_ms_median"],
        "param_ratio": sparse["parameters"] / dense["parameters"],
    }
    if dev.type == "cuda":
        out["card"] = card_line()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="dense vs pixelfly LM training step time")
    ap.add_argument("--arch", choices=registry.ARCH_NAMES, default=None)
    ap.add_argument("--smoke", action="store_true", help="the JAX script's reduced gpt2-bench config")
    ap.add_argument("--batch", type=int, default=None, help="default 8")
    ap.add_argument("--seq", type=int, default=None, help="default 2048, 128 with --smoke")
    ap.add_argument("--steps", type=int, default=3, help="timed steps after 2 warm-up steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    ap.add_argument("--out", default=None, help="default build/lm_speedup_<arch>.json")
    args = ap.parse_args(argv)
    if args.smoke == (args.arch is not None):
        ap.error("give exactly one of --arch and --smoke")
    res = compare(
        None if args.smoke else args.arch,
        batch=args.batch or 8,
        seq=args.seq or (128 if args.smoke else 2048),
        steps=args.steps, seed=args.seed, device=args.device,
    )
    out = Path(args.out or ROOT / "build" / f"lm_speedup_{res['arch']}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    for arm in ("dense", "sparse"):
        a = res[arm]
        print(f"{res['arch']} {arm}: {a['parameters'] / 1e6:.2f} M parameters, step "
              f"{a['step_ms_median']:.1f} ms ({a['train_tok_s']:.0f} train tokens/s on {res['device_name']}), "
              f"loss (last 5) {a['loss_last5_mean']:.4f}")
    print(f"{res['arch']}: speedup dense/sparse {res['speedup']:.3f}x, parameter ratio "
          f"{res['param_ratio']:.3f}; wrote {out}")
    return res


if __name__ == "__main__":
    main()
