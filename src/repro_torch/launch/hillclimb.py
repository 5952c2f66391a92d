"""Hill-climb tool, the twin of the JAX package's ``launch/hillclimb.py``:
count one dry-run cell with a named variant (config overrides) and append
its row, tagged, to a log: the bookkeeping of the hypothesis, change,
measure loop. The rows are counts on the meta mesh (``launch.dryrun``),
not measured times.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen3-1.7b \\
      --shape train_4k --tag density-0.25 --override sparse_density=0.25 \\
      --note "a denser butterfly pattern"

``--override field=value`` parses the value with ``ast.literal_eval`` (a
number, a string, a tuple: a Python literal, never code). The log is
``perf_log_torch.json`` at the root of the checkout unless ``--log`` says
otherwise.
"""

from __future__ import annotations

import argparse
import ast
import json
import os

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import run_cell

LOG = os.path.join(os.path.dirname(__file__), "..", "..", "..", "perf_log_torch.json")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="count one dry-run cell with a variant and log it")
    ap.add_argument("--arch", required=True, choices=registry.ARCH_NAMES)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--tag", required=True)
    ap.add_argument("--note", default="")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", choices=["tp", "fsdp"], default=None)
    ap.add_argument("--density", type=float, default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="config field=value (a Python literal)")
    ap.add_argument("--log", default=os.path.abspath(LOG))
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = ast.literal_eval(v)

    res = run_cell(
        args.arch, args.shape,
        multi_pod=args.multi_pod, sparse=not args.dense,
        density=args.density, strategy=args.strategy, overrides=overrides,
    )
    res["tag"] = args.tag
    res["note"] = args.note
    res["overrides"] = {k: repr(v) for k, v in overrides.items()}
    log = []
    if os.path.exists(args.log):
        with open(args.log) as f:
            log = json.load(f)
    log.append(res)
    with open(args.log, "w") as f:
        json.dump(log, f, indent=1)
    print(f"[hillclimb] logged '{args.tag}' -> {args.log}")
    return res


if __name__ == "__main__":
    main()
