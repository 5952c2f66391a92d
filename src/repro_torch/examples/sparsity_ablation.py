"""Ablation (paper §5.3): sweep the density and the butterfly / low-rank
split of a small LM through the port's ``Trainer``; prints the mean loss
of the last 5 steps and the parameters of each setting, the twin of the
"1/4 low rank : 3/4 butterfly is best" finding.

    PYTHONPATH=src python -m repro_torch.examples.sparsity_ablation [--steps 60] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.sparsity_ablation --smoke --device cpu

The port's counterpart of ``examples/sparsity_ablation.py``: the smoke
``smollm-360m`` at 2 layers, d_model 384, 6 heads over 2 kv heads (head
dim 64), d_ff 768, linear block 16, fp32, trained on ``SyntheticLM`` (seq
64, batch 8) with AdamW (lr 3e-3, 5 warm-up steps). Its attention is the
pixelfly block-sparse path at block 64 over one block of 64 tokens, which
the ``block_sparse_attention`` kernel takes in fp32 and bf16; its linears
run ``bsr_matmul`` at b = 16 on the card. ``--smoke`` is one cell
(density 0.4, split 0.25) of 2 steps. Checkpoints go to
``build/ablation_ckpt`` and are removed after each cell.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import TrainConfig, Trainer
from repro_torch.training.optimizer import OptConfig

__all__ = ["config", "run_one", "main"]

CKPT = Path(__file__).resolve().parents[3] / "build" / "ablation_ckpt"
SEQ, BATCH = 64, 8


def config(density: float, lowrank_frac: float) -> ModelConfig:
    """Widths where the budget split is not degenerate (rank floor 32)."""
    return registry.get_smoke("smollm-360m", sparse=True).replace(
        sparse_density=density, lowrank_frac=lowrank_frac, num_layers=2,
        d_model=384, num_heads=6, num_kv_heads=2, d_ff=768, sparse_block=16,
    )


def run_one(density: float, lowrank_frac: float, steps: int, device=None) -> tuple[float, int]:
    """Train one cell from seed 0; returns (mean loss of the last 5 steps,
    parameter count)."""
    cfg = config(density, lowrank_frac)
    shutil.rmtree(CKPT, ignore_errors=True)  # nothing to restore: start from the seed
    tr = Trainer(
        cfg,
        OptConfig(lr=3e-3, warmup_steps=5, total_steps=steps),
        SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0),
        TrainConfig(steps=steps, ckpt_dir=str(CKPT), ckpt_every=10 ** 9, log_every=10 ** 9),
        device=device,
    )
    hist = tr.run()
    n = sum(p.numel() for p in tr.params.values())
    del tr
    shutil.rmtree(CKPT, ignore_errors=True)
    return float(np.mean([h["loss"] for h in hist[-5:]])), n


def main(argv=None) -> list[tuple]:
    ap = argparse.ArgumentParser(description="density x low-rank split ablation")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--smoke", action="store_true", help="one sweep cell, 2 steps")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    grid = [(0.4, 0.25)] if args.smoke else [(d, f) for d in [0.2, 0.4, 0.8] for f in [0.0, 0.25, 0.5]]
    steps = 2 if args.smoke else args.steps
    rows = []
    print("density,lowrank_frac,final_loss,params")
    for density, frac in grid:
        loss, n = run_one(density, frac, steps, args.device)
        print(f"{density},{frac},{loss:.4f},{n}")
        rows.append((density, frac, loss, n))
    return rows


if __name__ == "__main__":
    main()
