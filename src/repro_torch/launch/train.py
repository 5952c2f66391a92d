"""Training launcher of the port, the JAX ``launch/train.py``'s flags: the
``Trainer`` on ``make_local_mesh()`` over every card (over ``[--device]``
when a device is given) under ``--strategy`` (``fsdp``, the default, or
``tp``); ``--production-mesh`` exits on a machine with fewer than the 256
devices of the 16 x 16 mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --sparse \\
      --steps 20 --batch 4 --seq 2048 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --sparse \\
      --smoke --steps 30 --batch 4 --seq 128 --device cpu --strategy tp

With ``--smoke`` the reduced config trains on a 512-token synthetic
vocabulary; ``--data-file`` trains on the bytes of a local file instead.
The vlm and audio backbones (``qwen2-vl-7b``, ``musicgen-large``) train on
the stub frontend's pseudo-embeddings of those tokens (``EmbedsWrapper``).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.training.data import EmbedsWrapper, SyntheticLM, TextFileLM
from repro_torch.training.loop import TrainConfig, Trainer
from repro_torch.training.optimizer import OptConfig


def build_data(cfg, args):
    if args.data_file:
        src = TextFileLM(args.data_file, args.seq, args.batch, seed=args.seed)
    else:
        src = SyntheticLM(
            min(cfg.vocab_size, 512) if args.smoke else cfg.vocab_size,
            args.seq,
            args.batch,
            seed=args.seed,
        )
    if not cfg.embed_inputs:
        src = EmbedsWrapper(src, cfg.d_model, n_pos_streams=len(cfg.mrope_sections))
    return src


def main(argv=None):
    ap = argparse.ArgumentParser(description="train a decoder LM of the port")
    ap.add_argument("--arch", choices=registry.ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--sparse", action="store_true", help="pixelfly model")
    ap.add_argument("--density", type=float, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-file", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", choices=["tp", "fsdp"], default="fsdp")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="default: every card; 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    if args.production_mesh:
        mesh = make_production_mesh()
        have = torch.cuda.device_count() if args.device is None else 1
        raise SystemExit(
            f"--production-mesh: the {mesh.shape} mesh needs {mesh.size} devices, this machine "
            f"has {have}"
        )

    if args.smoke:
        cfg = registry.get_smoke(args.arch, sparse=args.sparse)
    else:
        cfg = registry.get(args.arch, sparse=args.sparse, density=args.density)
    if args.density is not None:
        cfg = cfg.replace(sparse_density=args.density)
    opt = OptConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=max(1, args.steps // 10),
        compress_grads=args.compress_grads,
    )
    trainer = Trainer(
        cfg,
        opt,
        build_data(cfg, args),
        TrainConfig(
            steps=args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, seed=args.seed,
        ),
        mesh=make_local_mesh(devices=None if args.device is None else [args.device]),
        strategy=args.strategy,
    )
    hist = trainer.run()
    if hist:
        print(
            f"final loss {hist[-1]['loss']:.4f} after {trainer.step} steps "
            f"({trainer.straggler_events} straggler events)"
        )
    trainer.checkpoint()


if __name__ == "__main__":
    main()
