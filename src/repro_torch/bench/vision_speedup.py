"""The paper's vision comparison on the port: train a dense ViT or
MLP-Mixer and its pixelfly twin with the same SGD step and compare their
step times.

    PYTHONPATH=src python -m repro_torch.bench.vision_speedup --width b16
    PYTHONPATH=src python -m repro_torch.bench.vision_speedup --smoke --device cpu

The port's counterpart of ``benchmarks/vision_speedup.py`` (paper Fig 5 /
Table 4: pixelfly ViT and Mixer "up to 2.5x faster" than dense). It runs
the Mixer, then the ViT, as the JAX script does. The step
is the JAX script's: cross-entropy of the fp32 logits, the gradient of
every parameter, then ``p - 1e-3 * g`` in the parameter's dtype. Each arm,
dense then pixelfly, is built from the same seed and trained on the same
random patches and labels (numpy, ``--seed``); the first arm is freed
before the second is built. Each takes 2 warm-up steps, ``--steps`` timed
steps (host clock, ending in the loss's fetch) and, on the card, one step
traced on the device only. Each records its median step time and
images/s, parameter count, losses, peak device memory, the traced step's
device busy share and top device kernels, and its ``bsr_matmul`` launches
a step (the kernel's launch count, 0 on the CPU); the run derives the
speedup ``dense_ms / pixelfly_ms`` and the parameter ratio.

``--width bench`` is the JAX script's config (4 layers, d_model 256, 4
heads, d_ff 1024, 64 patches of 192 values, 100 classes, token_ff 128,
fp32, density 0.15, block 32, batch 32); ``--width b16`` the published
B/16 widths (ViT-B/16: Dosovitskiy et al. 2021, Table 1; Mixer-B/16:
Tolstikhin et al. 2021, Table 1): 12 layers, d_model 768, 196 patches of
16x16x3, 12 heads and d_ff 3072 (ViT), token_ff 384 and d_ff 3072 (Mixer),
1000 classes, bf16, density 0.15, block 32, batch 128. ``--smoke`` is the
bench width at batch 8 with 1 warm-up and 1 timed step. On the CPU the
times are the CPU's and the device metrics are null. Each kind's result
goes to ``<stem>_<kind>.json`` beside ``--out`` (default
``build/vision_speedup.json``, hence ``build/vision_speedup_vit.json``).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.bench.common import card_line, device_trace
from repro_torch.core.pixelfly import Linear
from repro_torch.kernels.bsr_matmul import KERNEL as BSR
from repro_torch.models import vision as V
from repro_torch.models.transformer import resolve_device

__all__ = ["bench_config", "b16_config", "make_data", "sgd_step", "run_arm", "compare", "main"]

ROOT = Path(__file__).resolve().parents[3]
LR = 1e-3
KINDS = ("mixer", "vit")
BATCH = {"bench": 32, "b16": 128}
SMOKE_BATCH = 8


def bench_config(kind: str, sparse: bool) -> V.VisionConfig:
    """The JAX script's reduced config."""
    return V.VisionConfig(
        kind=kind, num_layers=4, d_model=256, num_heads=4, d_ff=1024,
        num_patches=64, num_classes=100, patch_dim=192, token_ff=128,
        sparse=sparse, sparse_density=0.15, sparse_block=32,
    )


def b16_config(kind: str, sparse: bool) -> V.VisionConfig:
    """ViT-B/16 or Mixer-B/16 at the published widths, bf16."""
    return V.VisionConfig(
        kind=kind, num_layers=12, d_model=768, num_heads=12, d_ff=3072,
        num_patches=196, num_classes=1000, patch_dim=768, token_ff=384,
        sparse=sparse, sparse_density=0.15, sparse_block=32, dtype="bfloat16",
    )


CONFIGS = {"bench": bench_config, "b16": b16_config}


def make_data(cfg: V.VisionConfig, batch: int, seed: int, device: torch.device):
    """Random patches (fp32) and labels, drawn as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.num_patches, cfg.patch_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, batch)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def sgd_step(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor, lr: float = LR) -> torch.Tensor:
    """One step of the JAX script: the mean cross-entropy, the gradient of
    every parameter, ``p - lr * g`` in place. Returns the loss (before the
    update) on the device."""
    params = list(model.parameters())
    loss = F.cross_entropy(model(x), y)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)
    return loss.detach()


def run_arm(
    cfg: V.VisionConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    steps: int,
    warmup: int = 2,
    seed: int = 0,
) -> dict:
    """Build ``cfg`` from ``seed`` on x's device and take ``warmup`` +
    ``steps`` steps (and one traced step on the card). Frees the model
    before it returns."""
    dev = x.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    model = V.init_vision(cfg, seed=seed, device=dev)
    sparse_linears = sum(1 for m in model.modules() if isinstance(m, Linear) and m.spec.sparse)
    losses = [float(sgd_step(model, x, y)) for _ in range(warmup)]
    step_ms = []
    launches = BSR.launches
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(sgd_step(model, x, y)))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = BSR.launches - launches
    trace = device_trace(lambda: losses.append(float(sgd_step(model, x, y)))) if on_card else None
    med = statistics.median(step_ms)
    out = {
        "config": f"{cfg.kind}-d{cfg.d_model}-L{cfg.num_layers}",
        "sparse": cfg.sparse,
        "parameters": V.param_count(model),
        "sparse_linears": sparse_linears,
        "bsr_matmul_launches_per_step": launches / steps,
        "step_ms": step_ms,
        "step_ms_median": med,
        "images_s": x.shape[0] / (med / 1e3),
        "loss": losses,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None,
        "device_trace": trace,
    }
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def compare(
    kind: str,
    *,
    width: str,
    batch: int,
    steps: int,
    warmup: int = 2,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Dense, then pixelfly, for ``kind`` at ``width``, on the same data."""
    dev = resolve_device(device)
    dense_cfg, sparse_cfg = (CONFIGS[width](kind, s) for s in (False, True))
    x, y = make_data(dense_cfg, batch, seed, dev)
    dense, sparse = (run_arm(c, x, y, steps=steps, warmup=warmup, seed=seed)
                     for c in (dense_cfg, sparse_cfg))
    out = {
        "kind": kind,
        "width": width,
        "batch": batch,
        "dtype": dense_cfg.dtype,
        "warmup_steps": warmup,
        "timed_steps": steps,
        "lr": LR,
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
    ap = argparse.ArgumentParser(description="dense vs pixelfly ViT / MLP-Mixer training step time")
    ap.add_argument("--width", choices=tuple(CONFIGS), default="b16")
    ap.add_argument("--smoke", action="store_true", help="bench width, batch 8, 1 warm-up and 1 timed step")
    ap.add_argument("--steps", type=int, default=3, help="timed steps after 2 warm-up steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    ap.add_argument("--out", default=str(ROOT / "build" / "vision_speedup.json"),
                    help="writes <stem>_<kind>.json beside it")
    args = ap.parse_args(argv)
    width = "bench" if args.smoke else args.width
    batch = SMOKE_BATCH if args.smoke else BATCH[width]
    steps, warmup = (1, 1) if args.smoke else (args.steps, 2)
    results = {}
    stem = Path(args.out)
    for kind in KINDS:
        res = compare(kind, width=width, batch=batch, steps=steps, warmup=warmup,
                      seed=args.seed, device=args.device)
        out = stem.with_name(f"{stem.stem}_{kind}{stem.suffix}")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
        for arm in ("dense", "sparse"):
            a = res[arm]
            print(f"{kind} {width} {arm}: {a['parameters'] / 1e6:.2f} M parameters, step "
                  f"{a['step_ms_median']:.1f} ms ({a['images_s']:.0f} images/s on {res['device_name']}), "
                  f"bsr_matmul {a['bsr_matmul_launches_per_step']:.0f} launches a step")
        print(f"{kind} {width}: speedup dense/pixelfly {res['speedup']:.3f}x, parameter ratio "
              f"{res['param_ratio']:.3f}; wrote {out}")
        results[kind] = res
    return results


if __name__ == "__main__":
    main()
