"""Dry-run over the production meshes, the twin of the JAX package's
``launch/dryrun.py``: for every (arch x shape x mesh) cell, count the
port's real sharded step program of one mesh position, and write the JAX
rows.

The JAX dry-run lowers each cell's step with its shardings over the 16 x 16
(or 2 x 16 x 16) mesh of host devices, compiles it and walks the HLO. The
port has no compiler: it builds the cell's step on a meta mesh,
``Mesh(axes, shape, ["meta"] * size)``, and runs it once on the meta
device under ``analysis.roofline.counting``. Nothing is allocated and
nothing needs the card: the kernels' entry points return empty results on
meta and report their own cost (``kernels.ops``).

  - train: ``training.loop.MeshState`` of the parameter specs
    (``launch.specs``), the optimizer state, ``make_train_step`` with the
    JAX microbatch count, run for the replica of position 0 alone
    (``train_step(..., replica=i)``): its forward and backward, its
    gradients' reduce-scatters, and its positions' optimizer updates;
  - prefill: ``transformer.prefill`` on the ``MeshState`` for that replica;
  - decode: ``transformer.decode_step`` over ``init_mesh_cache``'s caches
    for that replica, at the last position of the cache.

A row counts the model cut to two layers and to three and extends the
counts to the model's depth (``count_by_layers``): on one controller a
tensor-parallel replica runs each of its shards' ops in turn, and a
48-layer model at tp 16 takes many minutes of meta ops, where two and
three layers take seconds. A training step of k > 3 microbatches is
counted the same way, as the step of two and of three microbatches of the
same size extended to k (``count_by_microbatches``).

A replica under tp is its ``tp`` model shards (each shard's heads and
slices, joined by the collectives); the counts of the run are divided by
``tp``, the shards being symmetric, to give one position's. Under fsdp a
replica is one position's program. Positions that compute the same rows
(a batch smaller than the data positions) each run that program: the
useful-FLOPs ratio counts the redundancy, as the JAX record does.

The row's keys are the JAX row's:

  - ``lower_s``: seconds spent building the state, the batch and the
    caches on the meta mesh; ``compile_s``: seconds of the counted run;
  - ``hlo_flops_per_device``, ``hlo_bytes_per_device``: the counted FLOPs
    and bytes of one position (``analysis.roofline``: matmul-class FLOPs,
    bytes of every op that moves data, the kernels' own formulas);
    ``xla_cost_flops_per_device`` is null (no XLA);
  - ``collective_bytes_per_device``, ``collective_breakdown``: the bytes
    of the collectives the position takes part in, by the JAX walker's
    rule and classes;
  - ``argument_bytes_per_device``: the position's shards of the
    parameters (and, for training, the optimizer state), its caches and
    its rows of the batch; ``bytes_per_device`` (XLA's "temp"): the peak
    of live bytes the counted run created, its outputs while alive
    included; ``output_bytes_per_device``: what the step returns and did
    not take in (training updates the state in place, so only metrics);
  - ``compute_s``, ``memory_s``, ``collective_s``, ``bottleneck``,
    ``roofline_fraction_compute``: ``roofline_terms`` at the H100's
    data-sheet peaks for the model's dtype, one NVLink (450 GB/s a
    direction) for every collective byte: counts, not measured times;
  - ``model_flops_global`` and ``useful_flops_ratio``: ``model_flops``
    over the counted FLOPs of every position.

A cell the port refuses gives a row with ``ok: false`` and the refusal's
words, which name the ROADMAP item; the exit code is 1 when any row
failed, as in JAX. The module imports no JAX and sets no XLA flag.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --json dryrun_baseline_torch.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.analysis import roofline
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.training.loop import MeshState, make_train_step
from repro_torch.training.optimizer import OptConfig, init_opt_state

__all__ = ["meta_mesh", "_prep_cfg", "pick_microbatches", "Cell", "build_cell", "count_cell", "count_by_microbatches",
           "count_by_layers", "run_cell", "main"]


def meta_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh with every position on the meta device."""
    prod = make_production_mesh(multi_pod=multi_pod)
    return Mesh(prod.axis_names, tuple(prod.shape.values()), ["meta"] * prod.size)


def _prep_cfg(cfg: ModelConfig, mesh: Mesh, st: sharding.Strategy) -> ModelConfig:
    """Launcher-side knobs that depend on the mesh and the strategy."""
    dp = mesh.size // (mesh.shape.get("model", 1) if st.kind == "tp" else 1)
    cfg = cfg.replace(tp_size=st.tp_size, batch_axes=st.batch)
    if cfg.moe_num_experts:
        cfg = cfg.replace(moe_routing_groups=dp)
    return cfg


def pick_microbatches(
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh: Mesh,
    st: sharding.Strategy,
    *,
    target_tokens_per_device: int | None = None,
) -> int:
    """Gradient-accumulation factor: bound live activations to about
    ``target`` tokens a device and microbatch (``REPRO_MB_TARGET_TOKENS``,
    4096 by default). k divides the per-data-shard batch, so every
    microbatch stays evenly sharded."""
    if shape.kind != "train":
        return 1
    if target_tokens_per_device is None:
        target_tokens_per_device = int(os.environ.get("REPRO_MB_TARGET_TOKENS", 4096))
    dp = 1
    for a in st.batch:
        dp *= mesh.shape[a]
    dp = min(dp, shape.global_batch)
    per_dev = shape.global_batch * shape.seq_len // dp
    want = max(1, -(-per_dev // target_tokens_per_device))
    per_shard_batch = max(1, shape.global_batch // dp)
    k = 1
    for d in range(1, per_shard_batch + 1):
        if per_shard_batch % d == 0 and d <= want:
            k = d
    return k


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _position_bytes(state: MeshState, position: int, trees: list[dict]) -> int:
    """Bytes of the slices ``position`` holds of each tree laid out as the
    state's parameters (the parameters, the moments)."""
    slot = state.slots(position)
    return sum(_nbytes(tree[name][i] for name, i in slot.items()) for tree in trees)


def _batch_bytes(st: sharding.Strategy, batch: dict, position: int) -> int:
    """Bytes of ``position``'s rows of every batch leaf (``batch_specs``)."""
    specs = sharding.batch_specs(st, batch)
    total = 0
    for name, t in batch.items():
        sl = sharding.position_slices(st.mesh, specs[name], t.shape)[position]
        total += math.prod(b - a for a, b in sl) * t.element_size()
    return total


@dataclasses.dataclass
class Cell:
    """One cell's step built on a mesh (``build_cell``): ``run()`` runs it
    once; ``per`` is how many positions the run covers (tp under tp, else
    1); ``argument_bytes`` one position's arguments; ``build_s`` the
    seconds spent building."""

    run: Callable[[], Any]
    per: int
    argument_bytes: int
    build_s: float


def build_cell(
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh: Mesh,
    *,
    strategy: str = "tp",
    opt_cfg: OptConfig = OptConfig(),
    params: dict[str, torch.Tensor] | None = None,
    microbatches: int | None = None,
) -> Cell:
    """The counterpart of JAX's ``lower_cell``: the cell's step on ``mesh``
    (a meta mesh for the dry-run; on a mesh of devices the same program
    runs), for the replica of position 0 (module docstring). ``params``:
    the state dict to shard (default: the specs on meta; a mesh of devices
    needs tensors), the batch is zeros of the specs' shapes on the first
    position's device. ``microbatches``: the training step's count
    (default ``pick_microbatches``'s). Refuses what the port does not
    shard (``ValueError`` naming the ROADMAP item) before building
    anything."""
    st = sharding.Strategy(mesh, strategy)
    cfg = _prep_cfg(cfg, mesh, st)
    sharding.check_tp(cfg, st.tp_size)
    t0 = time.perf_counter()
    state = MeshState(cfg, mesh, strategy, specs_lib.params_specs(cfg) if params is None else params, copy=False)
    dev = state.devices[0]
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev) for k, v in specs_lib.input_specs(cfg, shape).items()}
    args = _position_bytes(state, 0, [state.shards])
    rows = shape.global_batch
    if shape.kind == "train":
        k = microbatches or pick_microbatches(cfg, shape, mesh, st)
        opt = init_opt_state(opt_cfg, state.shards)
        args += _position_bytes(state, 0, [v for key, v in opt.items() if key != "step"]) + 4
        args += _batch_bytes(st, batch, 0)
        step = make_train_step(cfg, opt_cfg, microbatches=k)
        replica = state.replica_of(0, rows // k)
        per = len(state.replicas(rows // k)[replica][1])

        def run():
            return step(state, opt, batch, replica=replica)
    elif shape.kind == "prefill":
        args += _batch_bytes(st, batch, 0)
        replica = state.replica_of(0, rows)
        per = state.tp

        def run():
            return T.prefill(cfg, state, batch, replica=replica)
    elif shape.kind == "decode":
        replica = state.replica_of(0, rows)
        caches = T.init_mesh_cache(cfg, state, rows, shape.seq_len, replica=replica)
        per = state.tp
        args += _batch_bytes(st, batch, 0) + _nbytes(_leaves(caches)) // per

        def run():
            return T.decode_step(cfg, state, caches, batch["tokens"], shape.seq_len - 1, replica=replica)
    else:
        raise ValueError(shape.kind)
    return Cell(run, per, args, time.perf_counter() - t0)


def count_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, **kw) -> dict:
    """``build_cell`` (its keywords) and count one run: {"cost": one
    position's ``Cost``, "temp_bytes", "argument_bytes", "output_bytes",
    "build_s", "count_s"} (the run's counts divided by the
    positions it covers)."""
    cell = build_cell(cfg, shape, mesh, **kw)
    t0 = time.perf_counter()
    with roofline.counting() as tally:
        out = cell.run()
    count_s = time.perf_counter() - t0
    per = cell.per
    return {"cost": tally.cost().divided(per), "temp_bytes": tally.peak_bytes / per, "argument_bytes": cell.argument_bytes,
            "output_bytes": tally.created_bytes(out) / per, "build_s": cell.build_s, "count_s": count_s}


def _extended(a: dict, b: dict, times: int, *, memory: str) -> dict:
    """Two counts of a program that repeats one block (a layer, a
    microbatch), ``b`` with one block more than ``a``, extended by
    ``times`` more blocks: every count is ``a`` plus ``times`` what ``b``
    adds. The memory peak is
    extended the same way (``memory="linear"``: a layer's activations stay
    live until the backward) or is ``b``'s (``"last"``: from the third
    microbatch on, each runs with the same fp32 accumulators live)."""

    def ext(x, y):
        return x + times * (y - x)

    ca, cb = a["cost"], b["cost"]
    cost = roofline.Cost(
        flops=ext(ca.flops, cb.flops), bytes_accessed=ext(ca.bytes_accessed, cb.bytes_accessed),
        collective_bytes={k: ext(ca.collective_bytes.get(k, 0.0), v) for k, v in cb.collective_bytes.items()},
        n_collectives=ext(ca.n_collectives, cb.n_collectives),
    )
    out = {key: ext(a[key], b[key]) for key in ("argument_bytes", "output_bytes")}
    out["temp_bytes"] = ext(a["temp_bytes"], b["temp_bytes"]) if memory == "linear" else b["temp_bytes"]
    return {"cost": cost, **out, "build_s": a["build_s"] + b["build_s"], "count_s": a["count_s"] + b["count_s"]}


def count_by_microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, *, microbatches: int | None = None,
                          **kw) -> dict:
    """``count_cell`` of the cell's step. A training step of k > 3
    microbatches (``pick_microbatches``'s by default) is counted as the
    step of two microbatches of the same size and of three, extended to k
    (``_extended``): every microbatch after the first runs the same
    program, and the batch rows a position holds grow with k."""
    if shape.kind != "train":
        return count_cell(cfg, shape, mesh, **kw)
    st = sharding.Strategy(mesh, kw.get("strategy", "tp"))
    k = microbatches or pick_microbatches(_prep_cfg(cfg, mesh, st), shape, mesh, st)
    if k <= 3:
        return count_cell(cfg, shape, mesh, microbatches=k, **kw)
    rows = shape.global_batch // k
    two, three = (count_cell(cfg, dataclasses.replace(shape, global_batch=j * rows), mesh, microbatches=j, **kw)
                  for j in (2, 3))
    return _extended(two, three, k - 2, memory="last")


def count_by_layers(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, **kw) -> dict:
    """``count_by_microbatches`` of the model cut to two layers and to
    three, extended to ``cfg.num_layers``: the layers of a one-group model
    run the same program, so every count is the two-layer count plus
    ``num_layers - 2`` times what the third layer adds (the JAX walker
    multiplies a scanned layer's body by its trip count the same way). The
    memory is extended the same way, which holds while the same phase of
    the step has the peak at every depth: from two layers on, not from one
    (a one-layer prefill of musicgen-large peaks elsewhere), and the tests
    hold it equal to a count of every layer. A model of several layer
    groups, or of three layers or fewer, is counted whole."""
    n = cfg.num_layers
    if len(cfg.layer_groups()) != 1 or n <= 3:
        return count_by_microbatches(cfg, shape, mesh, **kw)
    two, three = (count_by_microbatches(cfg.replace(num_layers=j), shape, mesh, **kw) for j in (2, 3))
    return _extended(two, three, n - 2, memory="linear")


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    sparse: bool = True,
    density: float | None = None,
    verbose: bool = True,
    strategy: str | None = None,
    overrides: dict | None = None,
) -> dict:
    """Count one cell on the meta production mesh (``count_by_layers``) and
    return its row (the JAX row's keys; module docstring)."""
    shape = SHAPES[shape_name]
    cfg = registry.get(arch, sparse=sparse, density=density, **(overrides or {}))
    mesh = meta_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    strategy = strategy or registry.DEFAULT_STRATEGY.get(arch, "tp")
    c = count_by_layers(cfg, shape, mesh, strategy=strategy)
    cost = c["cost"]
    terms = roofline.roofline_terms(cost, roofline.HW().for_dtype(cfg.dtype))
    n_tokens = shape.global_batch * shape.seq_len if shape.kind in ("train", "prefill") else shape.global_batch
    mflops = roofline.model_flops(cfg, n_tokens, backward=(shape.kind == "train"))
    hlo_flops_global = cost.flops * n_chips
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "strategy": strategy,
        "sparse": sparse,
        "density": cfg.sparse_density if sparse else 1.0,
        "ok": True,
        "lower_s": round(c["build_s"], 1),
        "compile_s": round(c["count_s"], 1),
        "bytes_per_device": int(c["temp_bytes"]),
        "argument_bytes_per_device": int(c["argument_bytes"]),
        "output_bytes_per_device": int(c["output_bytes"]),
        "xla_cost_flops_per_device": None,
        "hlo_flops_per_device": cost.flops,
        "hlo_bytes_per_device": cost.bytes_accessed,
        "collective_bytes_per_device": cost.total_collective_bytes,
        "collective_breakdown": dict(cost.collective_bytes),
        **terms,
        "model_flops_global": mflops,
        "useful_flops_ratio": mflops / hlo_flops_global if hlo_flops_global else 0.0,
    }
    if verbose:
        print(f"== {arch} x {shape_name} [{result['mesh']}] {'pixelfly' if sparse else 'dense'} {strategy} ==")
        print(f"  build {c['build_s']:.1f}s count {c['count_s']:.1f}s")
        print(f"  memory/device: arguments {result['argument_bytes_per_device'] / 1e9:.3f} GB, "
              f"temp {result['bytes_per_device'] / 1e9:.3f} GB, output {result['output_bytes_per_device'] / 1e9:.3f} GB")
        print(f"  counted flops/device {cost.flops:.3e}  bytes {cost.bytes_accessed:.3e}  "
              f"collective {cost.total_collective_bytes:.3e}")
        print(f"  terms (counts at data-sheet peaks): compute {terms['compute_s'] * 1e3:.2f}ms  "
              f"memory {terms['memory_s'] * 1e3:.2f}ms  collective {terms['collective_s'] * 1e3:.2f}ms  "
              f"-> {terms['bottleneck']}-bound")
        print(f"  MODEL_FLOPS/counted FLOPS (useful ratio): {result['useful_flops_ratio']:.3f}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="count every dry-run cell of the port on the meta production mesh")
    ap.add_argument("--arch", choices=registry.ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dense", action="store_true", help="dense baseline (no pixelfly)")
    ap.add_argument("--strategy", choices=["tp", "fsdp"], default=None)
    ap.add_argument("--density", type=float, default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in registry.ARCH_NAMES:
            for sh in registry.shapes_for(a, sparse=not args.dense):
                cells.append((a, sh.name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results, failures = [], []
    for arch, sh in cells:
        for mp in meshes:
            try:
                results.append(run_cell(arch, sh, multi_pod=mp, sparse=not args.dense, density=args.density,
                                        strategy=args.strategy))
            except Exception as e:  # noqa: BLE001 - report and continue
                if not isinstance(e, ValueError):
                    traceback.print_exc()
                print(f"== {arch} x {sh} [{'2x16x16' if mp else '16x16'}] refused or failed: {e}")
                failures.append({"arch": arch, "shape": sh, "multi_pod": mp,
                                 "mesh": "2x16x16" if mp else "16x16",
                                 "strategy": args.strategy or registry.DEFAULT_STRATEGY.get(arch, "tp"),
                                 "error": str(e), "ok": False})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results + failures, f, indent=1)
    print(f"\n{len(results)} cells OK, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
