"""Block-size microbenchmark (paper App. L.5 / Table 7): the density a
pattern is meant to have against the density a block-32 device touches
(its (32, 32)-block cover), for random and pixelfly patterns of a 4K x 4K
matrix, then the latency of the BSR product against ``x @ w``.

    PYTHONPATH=src python -m repro_torch.bench.block_microbench
    PYTHONPATH=src python -m repro_torch.bench.block_microbench --smoke --device cpu

The port's counterpart of ``benchmarks/block_microbench.py``, with its
defaults (n = 4096, hardware block 32, batch 256) and its numpy draws in
its order, so the densities equal the JAX script's. The latency arms are
fp32: ``kernels.ops.bsr_matmul`` at the pixelfly pattern of density 0.1
(the ``bsr_matmul`` kernel at b = 32 on the card, its plain version on the
CPU) and ``x @ w`` with a dense (n, n) ``w``. ``--smoke`` is n = 1024,
batch 32. Times are medians of CUDA events on the card, of the host clock
on the CPU.
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

__all__ = ["densities", "run", "main"]

ROOT = Path(__file__).resolve().parents[3]


def densities(n: int, hw_block: int, rng: np.random.Generator) -> list[dict]:
    """(pattern, block, expected density, actual density) rows: random
    patterns grouped into blk x blk blocks, then pixelfly patterns at
    density 0.1."""
    rows = []
    for blk in [1, 2, 4, 8, 16, 32]:
        density = 0.0125 * blk if blk < 16 else 0.10
        nb = n // blk
        keep = rng.random((nb, nb)) < density
        mask = np.repeat(np.repeat(keep, blk, 0), blk, 1).astype(np.float32)
        rows.append({"pattern": "random", "block": blk, "expected_density": density,
                     "actual_density": bf.block_cover_density(mask, hw_block)})
    for blk in [4, 8, 16, 32]:
        pat = bf.make_pattern(n, n, block=blk, density=0.10)
        rows.append({"pattern": "pixelfly", "block": blk, "expected_density": pat.density,
                     "actual_density": bf.block_cover_density(pat.dense_mask(), hw_block)})
    return rows


def run(n: int = 4096, hw_block: int = 32, batch: int = 256, *, iters: int = 20,
        device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = densities(n, hw_block, rng)
    x = torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32)).to(dev)
    pat = bf.make_pattern(n, n, block=hw_block, density=0.10)
    blocks = torch.from_numpy(
        rng.standard_normal((pat.nb_out, pat.r, hw_block, hw_block)).astype(np.float32)).to(dev)
    cols = torch.from_numpy(pat.cols).to(dev)
    w = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev)
    t_bsr = time_ms(lambda: ops.bsr_matmul(x, blocks, cols), dev, iters=iters)
    t_dense = time_ms(lambda: x @ w, dev, iters=iters)
    out = {
        "n": n, "hw_block": hw_block, "batch": batch, "device": dev.type, "densities": rows,
        "latency": {"bsr_ms": t_bsr, "dense_ms": t_dense, "bsr_speedup": t_dense / t_bsr,
                    "density": pat.density, "r": pat.r, "dtype": "float32"},
    }
    if dev.type == "cuda":
        out["card"] = card_line()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="expected vs block-cover density; BSR vs dense latency")
    ap.add_argument("--smoke", action="store_true", help="n = 1024, batch 32")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    ap.add_argument("--out", default=None, help="default build/block_microbench.json")
    args = ap.parse_args(argv)
    res = run(1024, 32, 32, iters=3, device=args.device) if args.smoke else run(device=args.device)
    out = Path(args.out or ROOT / "build" / "block_microbench.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    for r in res["densities"]:
        print(f"block_microbench/{r['pattern']}/b={r['block']}: expected_density={r['expected_density']:.4f} "
              f"actual_density={r['actual_density']:.4f}")
    lat = res["latency"]
    print(f"block_microbench/latency: bsr {lat['bsr_ms']:.4f} ms, dense {lat['dense_ms']:.4f} ms, "
          f"bsr_speedup {lat['bsr_speedup']:.2f}x at density {lat['density']:.3f} on {res['device']}")
    return res


if __name__ == "__main__":
    main()
