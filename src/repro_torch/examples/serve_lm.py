"""Continuous-batching serving example with per-request sampling.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--smoke] [--device cpu]

The port's counterpart of ``examples/serve_lm.py``: mixed-length requests
flow through ``repro_torch.serving.Engine`` (bucketed prefill into the
block-paged KV cache, slot admission and eviction every step, one decode
step over all slots) on the sparse smoke ``smollm-360m``. Each request
carries its own ``SamplingParams``: greedy, temperature, top-k/top-p,
repetition penalty, each sampled on the device from the request's own
seeded noise stream. Two late requests are submitted mid-flight to show
slots refilling. ``--smoke`` shrinks the model to 2 layers and a
128-token vocabulary, as the JAX example's does. The card by default;
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.sampling import SamplingParams

__all__ = ["main"]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="continuous batching with per-request sampling")
    ap.add_argument("--smoke", action="store_true", help="tiny model and short requests")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    cfg = registry.get_smoke("smollm-360m", sparse=True)
    if args.smoke:
        cfg = cfg.replace(num_layers=2, vocab_size=128)
    engine = Engine(cfg, engine_cfg=EngineConfig(max_slots=3, max_len=128), device=args.device)
    rng = np.random.default_rng(0)
    # one greedy request, the rest sampled, each with its own seed
    samplers = [
        SamplingParams(),  # greedy
        SamplingParams(temperature=0.8, top_k=50, seed=1),
        SamplingParams(temperature=0.7, top_p=0.95, seed=2),
        SamplingParams(temperature=1.0, repetition_penalty=1.2, seed=3),
    ]
    for i, (plen, gen) in enumerate([(16, 12), (9, 6), (24, 10), (5, 8)]):
        engine.submit(rng.integers(0, cfg.vocab_size, plen), gen, sampling=samplers[i % len(samplers)])
    finished = []
    for _ in range(6):  # the first wave makes progress...
        finished += engine.step()
    for plen, gen, sp in [  # ...then late arrivals join
        (12, 5, SamplingParams(temperature=0.9, top_k=20, seed=4)),
        (7, 9, SamplingParams()),
    ]:
        engine.submit(rng.integers(0, cfg.vocab_size, plen), gen, sampling=sp)
    finished += engine.drain()

    finished.sort(key=lambda f: f.uid)
    for f in finished:
        print(
            f"req {f.uid}: prompt {f.prompt.size:>2} tok -> "
            f"{len(f.tokens):>2} generated ({f.finish_reason}, "
            f"admitted step {f.admit_step}) {f.tokens[:8]}"
        )
    s = engine.stats_summary()
    print(
        f"\n{s['generated_tokens']} tokens, {s['tok_s']} tok/s, "
        f"occupancy mean {s['mean_occupancy']} "
        f"(min {s['min_occupancy']}, max {s['max_occupancy']}) on {engine.device}"
    )
    print("by sampler:", {k: v["requests"] for k, v in s["by_sampler"].items()})
    return finished


if __name__ == "__main__":
    main()
