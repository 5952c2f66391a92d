"""Roofline report: the dry-run sweep JSON as one CSV row per (arch x
shape x mesh): the roofline terms, the bottleneck and the useful-FLOPs
ratio; the twin of ``benchmarks/roofline_report.py``.

It reads ``dryrun_baseline_torch.json`` at the root of the checkout,
which the port's dry-run writes (``python -m repro_torch.launch.dryrun
--all --both-meshes --json dryrun_baseline_torch.json``; the JAX package's
``dryrun_baseline.json`` is its own, so ``benchmarks/roofline_report.py``
never reads the port's rows). Without the file it emits the one
``roofline/missing`` row, as the JAX script does.

  PYTHONPATH=src python -m repro_torch.bench.roofline_report
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["DEFAULT", "rows", "run"]

DEFAULT = Path(__file__).resolve().parents[3] / "dryrun_baseline_torch.json"


def rows(path: str | Path = DEFAULT) -> list[tuple[str, float, str]]:
    """(name, us_per_call, derived) rows of the sweep at ``path``."""
    path = Path(path)
    if not path.exists():
        return [("roofline/missing", 0.0, f"run the dry-run sweep first ({path})")]
    out = []
    for r in json.loads(path.read_text()):
        if not r.get("ok"):
            out.append((f"roofline/{r['arch']}/{r['shape']}/{r.get('multi_pod')}", 0.0,
                        f"FAILED:{r.get('error', '?')[:60]}"))
            continue
        out.append((
            f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
            r["compute_s"] * 1e6,
            f"mem_ms={r['memory_s']*1e3:.1f};coll_ms={r['collective_s']*1e3:.1f}"
            f";bottleneck={r['bottleneck']}"
            f";useful={r['useful_flops_ratio']:.3f}"
            f";temp_gb={(r['bytes_per_device'] or 0)/1e9:.1f}",
        ))
    return out


def run(path: str | Path = DEFAULT) -> None:
    for name, us, derived in rows(path):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    run()
