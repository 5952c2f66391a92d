"""Dense against pixelfly block-sparse attention at long sequences (paper
Fig 9, the Long Range Arena's 1K-4K), the attention op alone.

    PYTHONPATH=src python -m repro_torch.bench.lra_attention
    PYTHONPATH=src python -m repro_torch.bench.lra_attention --smoke --device cpu

The port's counterpart of ``benchmarks/lra_attention.py``: B = 2, 4 heads
(G = 1), head dim 64, causal, the pixelfly block mask at block 128 (one
local block, the full flat butterfly, one global block), S in {1024, 2048,
4096}, inputs ``0.1 * N(0, 1)`` from one numpy generator in the JAX
script's order. On the CPU both arms are fp32, as the script: the dense
arm is ``layers.flash_attention`` (the chunked online softmax at chunk
512) and the sparse arm ``ops.block_sparse_attention`` (its plain
version). On the card both are bf16: the dense arm is PyTorch's flash SDPA
(what ``layers.flash_attention`` runs there) and the sparse arm the
hand-written ``block_sparse_attention`` kernel. Each row also gives the
keys a query reads. ``--smoke`` is S = 256. Times are medians of CUDA
events on the card, of the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench.common import card_line, time_ms
from repro_torch.core import attn_pattern as ap
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import resolve_device

__all__ = ["BLOCK", "inputs", "schedule", "dense", "sparse", "run", "main"]

ROOT = Path(__file__).resolve().parents[3]
B, HK, G, D = 2, 4, 1, 64
BLOCK = 128
PATTERN = ap.AttentionPatternConfig(block=BLOCK, local_blocks=1, max_stride=0, global_blocks=1)


def inputs(s: int, rng: np.random.Generator, device: torch.device, dtype: torch.dtype):
    """q (B, S, Hk, G, D), k, v (B, S, Hk, D): 0.1 * N(0, 1), drawn in fp32
    and cast to ``dtype``."""
    def draw(shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)).to(device, dtype)

    return draw((B, s, HK, G, D)), draw((B, s, HK, D)), draw((B, s, HK, D))


def schedule(s: int):
    """The causal pixelfly block mask of length s and its KV schedule."""
    mask = ap.pixelfly_attention_block_mask(s, s, PATTERN, causal=True)
    return mask, ap.block_schedule(mask, BLOCK, BLOCK)


def dense(q, k, v):
    return L.flash_attention(q, k, v, sm_scale=D ** -0.5, chunk=512)


def sparse(q, k, v, kv_index, valid):
    return ops.block_sparse_attention(q, k, v, kv_index, valid, block=BLOCK, causal=True, sm_scale=D ** -0.5)


def run(seqs=(1024, 2048, 4096), *, iters: int = 20, device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    rng = np.random.default_rng(0)
    rows = []
    for s in seqs:
        q, k, v = inputs(s, rng, dev, dtype)
        mask, sched = schedule(s)
        kv_index = torch.as_tensor(sched.kv_index, device=dev)
        valid = torch.as_tensor(sched.valid, device=dev)
        t_d = time_ms(lambda: dense(q, k, v), dev, warmup=3, iters=iters)
        t_s = time_ms(lambda: sparse(q, k, v, kv_index, valid), dev, warmup=3, iters=iters)
        rows.append({"seq": s, "dense_ms": t_d, "sparse_ms": t_s, "speedup": t_d / t_s,
                     "keys_per_query": ap.keys_per_query(mask, BLOCK, s)})
    out = {"batch": B, "kv_heads": HK, "group": G, "head_dim": D, "block": BLOCK,
           "dtype": str(dtype).split(".")[1], "device": dev.type, "rows": rows}
    if dev.type == "cuda":
        out["card"] = card_line()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="dense vs pixelfly block-sparse attention, S = 1K-4K")
    p.add_argument("--smoke", action="store_true", help="S = 256")
    p.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    p.add_argument("--out", default=None, help="default build/lra_attention.json")
    args = p.parse_args(argv)
    res = run((256,), iters=3, device=args.device) if args.smoke else run(device=args.device)
    out = Path(args.out or ROOT / "build" / "lra_attention.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    for r in res["rows"]:
        print(f"lra_attention/s={r['seq']}: sparse {r['sparse_ms']:.4f} ms, dense {r['dense_ms']:.4f} ms, "
              f"speedup {r['speedup']:.2f}x, keys_per_query {r['keys_per_query']:.0f}/{r['seq']} "
              f"({res['dtype']} on {res['device']})")
    return res


if __name__ == "__main__":
    main()
