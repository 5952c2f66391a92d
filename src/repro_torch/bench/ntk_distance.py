"""Empirical-NTK distance to the dense model (paper Fig 4): which mask of
a small MLP keeps its neural tangent kernel closest to the dense one.

    PYTHONPATH=src python -m repro_torch.bench.ntk_distance [--device cpu]

The port's counterpart of ``benchmarks/ntk_distance.py``: the MLP
``relu(x @ (w1 * m1)) @ w2`` (D 64, H 256, one output), N = 24 inputs, and
``K_ij = <df(x_i)/dθ, df(x_j)/dθ>`` from the per-sample gradients
(``torch.func.vmap`` of ``torch.func.grad``). Candidates at about equal
density: pixelfly (a flat butterfly of stride 2 at block 8 plus a low-rank
cross), the butterfly alone (stride 4), the low-rank cross alone, and a
random mask. Reports ``||K_mask - K_dense||_F / ||K_dense||_F``; the
paper's finding is that pixelfly is closest. Weights, inputs and masks
come from numpy in the JAX script's order. No kernel runs here; the
products are fp32 ``torch.matmul`` on the card or the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import butterfly as bf
from repro_torch.models.transformer import resolve_device

__all__ = ["D", "H", "N", "BLOCK", "masks", "ntk", "run", "main"]

ROOT = Path(__file__).resolve().parents[3]
D, H, N = 64, 256, 24  # input width, hidden width, NTK samples
BLOCK = 8


def _lowrank_mask(rows: int, cols: int, rank: int) -> np.ndarray:
    m = np.zeros((rows, cols), np.float32)
    m[:rank, :] = 1.0
    m[:, :rank] = 1.0
    return m


def masks(rng: np.random.Generator) -> dict[str, np.ndarray]:
    """The four candidate (D, H) masks; draws the random one from rng."""
    butterfly_mask = bf.make_pattern(H, D, block=BLOCK, max_stride=4).dense_mask().T
    density = butterfly_mask.mean()
    rank = max(1, int(density * D * H / (D + H) / 2))
    pf = np.clip(bf.make_pattern(H, D, block=BLOCK, max_stride=2).dense_mask().T
                 + _lowrank_mask(D, H, max(1, rank // 2)), 0, 1)
    return {
        "pixelfly(butterfly+lowrank)": pf,
        "butterfly_only": butterfly_mask,
        "lowrank_only(global)": _lowrank_mask(D, H, rank),
        "random(magnitude-init)": (rng.random((D, H)) < density).astype(np.float32),
    }


def ntk(params: dict[str, torch.Tensor], mask1: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The (N, N) empirical NTK of the masked MLP at ``params``."""
    from torch.func import grad, vmap

    def f(p, x):
        h = torch.relu(x[None] @ (p["w1"] * mask1))
        return (h @ p["w2"]).sum()

    g = vmap(grad(f), in_dims=(None, 0))(params, xs)
    flat = torch.cat([g["w1"].reshape(len(xs), -1), g["w2"].reshape(len(xs), -1)], dim=1)
    return flat @ flat.T


def run(seed: int = 0, device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    xs = t(rng.standard_normal((N, D)))
    params = {"w1": t(rng.standard_normal((D, H)) / np.sqrt(D)), "w2": t(rng.standard_normal((H, 1)) / np.sqrt(H))}
    k_dense = ntk(params, t(np.ones((D, H))), xs)
    nd = torch.linalg.norm(k_dense)
    cands = masks(rng)
    dist = {name: float(torch.linalg.norm(ntk(params, t(m), xs) - k_dense) / nd) for name, m in cands.items()}
    return {
        "device": dev.type,
        "rel_ntk_dist": dist,
        "density": {name: float(m.mean()) for name, m in cands.items()},
        "closest_to_dense": min(dist, key=dist.get),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="empirical-NTK distance of masked MLPs to the dense one")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    p.add_argument("--out", default=None, help="default build/ntk_distance.json")
    args = p.parse_args(argv)
    res = run(args.seed, args.device)
    out = Path(args.out or ROOT / "build" / "ntk_distance.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    for name, v in sorted(res["rel_ntk_dist"].items(), key=lambda kv: kv[1]):
        print(f"ntk_distance/{name}: rel_ntk_dist={v:.4f} density={res['density'][name]:.3f}"
              + (" closest_to_dense" if name == res["closest_to_dense"] else ""))
    return res


if __name__ == "__main__":
    main()
