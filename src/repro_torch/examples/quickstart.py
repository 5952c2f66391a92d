"""Quickstart: sparsify one linear layer with Pixelated Butterfly.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--smoke]

The port's counterpart of ``examples/quickstart.py``: build the flat block
butterfly + low-rank spec of a 1024 -> 4096 layer from a density budget
of 0.15, count its parameters against the dense layer's, apply it to a
batch of 8 (the ``bsr_matmul`` kernel on the card, its plain version on
the CPU), and check that its mask is its own block cover: a block device
touches no byte the pattern does not use. ``--smoke`` changes nothing
(the example is already small); it is accepted for symmetry with the
other entry points.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.butterfly import block_cover
from repro_torch.core.pixelfly import Linear, LinearSpec, param_count
from repro_torch.models.transformer import resolve_device

__all__ = ["main"]

IN, OUT, DENSITY = 1024, 4096, 0.15


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="one pixelfly linear layer")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    ap.add_argument("--smoke", action="store_true", help="no change: the example is CPU-sized")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    dense = LinearSpec.dense(IN, OUT, dtype=torch.float32)
    sparse = LinearSpec.pixelfly(IN, OUT, DENSITY, block=128, dtype=torch.float32)
    print(f"dense params : {param_count(dense):,}")
    print(f"pixelfly     : {param_count(sparse):,} "
          f"({param_count(sparse) / param_count(dense):.1%} of dense)")
    pat = sparse.pattern()
    print(f"pattern      : block={pat.block} max_stride={pat.max_stride} "
          f"slots/row={pat.r} rank={sparse.rank}")

    layer = Linear(sparse, gen=torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((8, IN), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        y = layer(x)
    print(f"y = x @ (gamma*B + (1-gamma)*UV^T): {tuple(x.shape)} -> {tuple(y.shape)}, "
          f"gamma={float(layer.gamma.detach()):.2f}, on {dev.type}")

    m = pat.dense_mask()
    assert np.array_equal(m, block_cover(m, pat.block, pat.block))
    print("mask is its own block cover: every byte a block device touches is used")
    return {"dense": param_count(dense), "pixelfly": param_count(sparse), "y_shape": tuple(y.shape),
            "finite": bool(torch.isfinite(y).all())}


if __name__ == "__main__":
    main()
