"""Render the dry-run / roofline markdown table from the sweep JSON, a
copy of the JAX package's ``analysis/report.py``.

  PYTHONPATH=src python -m repro_torch.analysis.report [dryrun_baseline_torch.json]

The sweep JSON is what the port's dry-run writes (``launch.dryrun --json
dryrun_baseline_torch.json``): the JAX package's keys, on a file of its
own so the two packages' rows never mix. Its numbers are counts on the
meta mesh at the H100's data-sheet peaks, not measured times.
"""

from __future__ import annotations

import json
import sys

__all__ = ["fmt_bytes", "render"]


def fmt_bytes(x) -> str:
    if x is None:
        return "-"
    return f"{x/1e9:.1f}"


def render(path: str) -> str:
    with open(path) as f:
        rows = json.load(f)
    ok = [r for r in rows if r.get("ok")]
    bad = [r for r in rows if not r.get("ok")]
    out = []
    out.append(
        "| arch | shape | mesh | strat | compile s | temp GB/dev | compute ms "
        "| memory ms | collective ms | bound | useful |"
    )
    out.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in ok:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('strategy','?')} "
            f"| {r['compile_s']} | {fmt_bytes(r['bytes_per_device'])} "
            f"| {r['compute_s']*1e3:.1f} | {r['memory_s']*1e3:.0f} "
            f"| {r['collective_s']*1e3:.0f} | {r['bottleneck']} "
            f"| {r['useful_flops_ratio']:.2f} |"
        )
    for r in bad:
        out.append(
            f"| {r['arch']} | {r['shape']} | {'2x16x16' if r.get('multi_pod') else '16x16'} "
            f"| - | FAILED | - | - | - | - | - | {r.get('error','')[:40]} |"
        )
    return "\n".join(out)


if __name__ == "__main__":
    print(render(sys.argv[1] if len(sys.argv) > 1 else "dryrun_baseline_torch.json"))
