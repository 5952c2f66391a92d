"""End-to-end example: train a smoke-width qwen3-1.7b LM with pixelfly
sparsity, checkpoints and resume, on the card unless ``--device cpu``;
the port of the JAX package's ``examples/train_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--dense]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --smoke --device cpu

Run it again with the same ``--ckpt-dir`` and it resumes from the newest
checkpoint. ``--smoke`` is the quick check: 2 steps of a 2-layer model
with a 256-token vocabulary, checkpoints in a fresh temporary directory.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import registry
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import TrainConfig, Trainer
from repro_torch.training.optimizer import OptConfig

__all__ = ["main"]


def main(argv=None, *, params: dict[str, torch.Tensor] | None = None) -> list[dict]:
    """Parse ``argv``, train, and return the history (one dict a step).
    ``params`` is a state dict to start from in place of the seed's draw
    (``bridge.params_from_jax`` for a parity run)."""
    ap = argparse.ArgumentParser(description="train a smoke-width pixelfly LM with checkpoints")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--ckpt-dir", default="build/example_lm")
    ap.add_argument("--smoke", action="store_true", help="tiny model, 2 steps (the quick check)")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    cfg = registry.get_smoke("qwen3-1.7b", sparse=not args.dense)
    if args.smoke:
        args.steps = 2
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_smoke_lm_")
        cfg = cfg.replace(num_layers=2, vocab_size=256)
        data = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    else:
        data = SyntheticLM(cfg.vocab_size, 128, 8, seed=0)
    trainer = Trainer(
        cfg,
        OptConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps),
        data,
        TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=20),
        device=args.device,
        params=params,
    )
    hist = trainer.run()
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"in {trainer.step} steps; checkpoints in {args.ckpt_dir}")
    return hist


if __name__ == "__main__":
    main()
