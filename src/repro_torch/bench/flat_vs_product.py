"""Flat block butterfly (one block-sparse product) against the product of
butterfly factor matrices (paper App. J / Fig 11: up to 3x on a V100).

    PYTHONPATH=src python -m repro_torch.bench.flat_vs_product
    PYTHONPATH=src python -m repro_torch.bench.flat_vs_product --smoke --device cpu

The port's counterpart of ``benchmarks/flat_vs_product.py``, with its
defaults (n = 1024, block 32, batch 512, max stride 4, 16 and n / block)
and its inputs, drawn from one numpy generator in the JAX script's order.
The product arm is ``1 + log2(k)`` dependent dense fp32 ``torch.matmul``s
by ``I + 0.1 B`` over the ``butterfly_factor_matrix`` factors. The flat
arm is one ``kernels.ops.bsr_matmul`` with the flat butterfly's pattern:
on the card that is the hand-written ``bsr_matmul`` kernel (fp32, b = 32),
on the CPU its plain version. The JAX script times its plain gather; the
paper's claim is about the hardware-efficient flat form, so the card
times the kernel. ``--smoke`` is n = 512, batch 32. Times are medians of
CUDA events on the card, of the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench.common import card_line, time_ms
from repro_torch.core import butterfly as bf
from repro_torch.kernels import ops
from repro_torch.models.transformer import resolve_device

__all__ = ["inputs", "product", "run", "main"]

ROOT = Path(__file__).resolve().parents[3]


def inputs(n: int, block: int, batch: int, device: torch.device, seed: int = 0):
    """x (batch, n) and, for each max stride k in (4, 16, n / block), a
    row (k, the product's factors, the flat form's blocks and cols), fp32
    on device, drawn as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    nb = n // block
    x = torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32)).to(device)
    arms = []
    for k in (4, 16, nb):
        factors = [
            torch.from_numpy(
                (np.eye(n) + 0.1 * bf.butterfly_factor_matrix(nb, 2 * s if s > 1 else 2, rng, block=block))
                .astype(np.float32)
            ).to(device)
            for s in [1] + bf.flat_butterfly_strides(k)
        ]
        pat = bf.make_pattern(n, n, block=block, max_stride=k)
        blocks = rng.standard_normal((pat.nb_out, pat.r, block, block)) / np.sqrt(pat.r * block)
        arms.append((k, factors, torch.from_numpy(blocks.astype(np.float32)).to(device),
                     torch.from_numpy(pat.cols).to(device)))
    return x, arms


def product(x: torch.Tensor, factors: list[torch.Tensor]) -> torch.Tensor:
    for f in factors:
        x = torch.matmul(x, f)
    return x


def run(n: int = 1024, block: int = 32, batch: int = 512, *, iters: int = 20,
        device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    x, arms = inputs(n, block, batch, dev)
    rows = []
    for k, factors, blocks, cols in arms:
        t_prod = time_ms(lambda: product(x, factors), dev, iters=iters)
        t_flat = time_ms(lambda: ops.bsr_matmul(x, blocks, cols), dev, iters=iters)
        rows.append({
            "max_stride": k, "factors": len(factors), "r": blocks.shape[1],
            "product_ms": t_prod, "flat_ms": t_flat, "speedup": t_prod / t_flat,
        })
    out = {"n": n, "block": block, "batch": batch, "dtype": "float32", "device": dev.type, "rows": rows}
    if dev.type == "cuda":
        out["card"] = card_line()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="flat block butterfly vs product of factors")
    ap.add_argument("--smoke", action="store_true", help="n = 512, batch 32")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    ap.add_argument("--out", default=None, help="default build/flat_vs_product.json")
    args = ap.parse_args(argv)
    res = run(512, 32, 32, iters=3, device=args.device) if args.smoke else run(device=args.device)
    out = Path(args.out or ROOT / "build" / "flat_vs_product.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    for r in res["rows"]:
        print(f"flat_vs_product/k={r['max_stride']}: flat {r['flat_ms']:.4f} ms (r = {r['r']}), product "
              f"{r['product_ms']:.4f} ms ({r['factors']} factors), speedup {r['speedup']:.2f}x on {res['device']}")
    return res


if __name__ == "__main__":
    main()
