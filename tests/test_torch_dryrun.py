"""The port's dry-run (``repro_torch.launch.{specs, dryrun, hillclimb}``)
against the JAX package's, on the CPU. Every JAX call runs in one
subprocess on 512 forced host devices (``repro.launch.dryrun`` sets its
XLA flags when imported), started when the module's first test runs.

(i) the meta stand-ins of every arch at full width, sparse and dense,
equal JAX's ``eval_shape`` stand-ins through the bridge's names;
(ii) ``_prep_cfg`` and ``pick_microbatches`` equal JAX's for every arch,
shape, mesh and strategy; (iii) the argument bytes of full-width
qwen3-1.7b and musicgen-large ``train_4k`` on 16 x 16 equal the sum of
JAX's ``NamedSharding.shard_shape`` bytes; (iv) smoke qwen3-1.7b on (2, 2)
and (1, 2) under both strategies: the counted FLOPs of one position equal
the JAX walker's of ``lower_cell(...).compile()`` up to named terms that
the test computes, and the argument bytes equal XLA's exactly, and so
do smoke deepseek-moe-16b's under expert parallelism and smoke
qwen3-1.7b's prefill, decode and train cells at tp 4 (1, 4), the
sequence-parallel mode, whose collective bytes are printed beside the
walker's; (v) one
position's count times the positions equals the whole mesh's; (vi) a
meta count equals a CPU count; (vii) the fsdp step's all-gather and
reduce-scatter bytes equal the walker's rule over the parameters; (viii)
the sharded contiguous prefill and decode equal the (1, 1) run; (ix)
``Engine.roofline()`` at tp 2 against the JAX engine's record on
``make_tp_mesh(2)``; (x) the CLIs, the report, and the counts by layers
and by microbatches."""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import report, roofline as R
from repro_torch.bench import roofline_report
from repro_torch.bridge import port_names
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.core.butterfly import transpose_tables
from repro_torch.core.pixelfly import Linear
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_tp_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.training.loop import MeshState, make_train_step
from repro_torch.training.optimizer import OptConfig, init_opt_state

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"2x2": (2, 2), "1x2": (1, 2)}
ENGINE = dict(max_slots=4, max_len=256)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX = r'''
import json, sys
import numpy as np
req = json.loads(sys.stdin.read())
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.analysis import roofline
from repro.configs import registry
from repro.configs.base import SHAPES
from repro.distributed import sharding
from repro.launch import dryrun as D
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh, make_tp_mesh
from repro.training.optimizer import OptConfig, init_opt_state

def flat(tree):
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = [list(x.shape), str(x.dtype)]
    return out

out = {"specs": {}, "prep": {}, "args": {}, "cells": {}}
for arch in registry.ARCH_NAMES:
    for sparse in (True, False):
        cfg = registry.get(arch, sparse=sparse)
        p = S.params_specs(cfg)
        opt = jax.eval_shape(lambda q: init_opt_state(OptConfig(), q), p)
        out["specs"][f"{arch} {sparse}"] = {
            "params": flat(p), "opt": flat(opt),
            "inputs": {sh: flat(S.input_specs(cfg, SHAPES[sh])) for sh in SHAPES},
            "caches": {sh: flat(S.decode_cache_specs(cfg, SHAPES[sh])) for sh in ("decode_32k", "long_500k")},
        }
meshes = {False: make_production_mesh(), True: make_production_mesh(multi_pod=True)}
for arch in registry.ARCH_NAMES:
    base = registry.get(arch, sparse=True)
    for mp, mesh in meshes.items():
        for strat in ("tp", "fsdp"):
            st = sharding.Strategy(mesh, strat)
            c = D._prep_cfg(base, mesh, st)
            for sh in SHAPES:
                out["prep"][f"{arch} {mp} {strat} {sh}"] = [
                    c.tp_size, list(c.batch_axes), c.moe_routing_groups, D.pick_microbatches(c, SHAPES[sh], mesh, st)]

def shard_bytes(tree, shardings):
    xs = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings, is_leaf=lambda s: isinstance(s, NamedSharding))
    assert len(xs) == len(shs)
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize for x, s in zip(xs, shs))

mesh = meshes[False]
for arch, strat in (("qwen3-1.7b", "fsdp"), ("musicgen-large", "tp")):
    st = sharding.Strategy(mesh, strat)
    cfg = D._prep_cfg(registry.get(arch, sparse=True), mesh, st)
    state = S.state_specs(cfg, OptConfig())
    batch = S.input_specs(cfg, SHAPES["train_4k"])
    total = shard_bytes(state["params"], sharding.param_shardings(st, state["params"]))
    total += sum(shard_bytes(state["opt"][k], sharding.param_shardings(st, state["opt"][k])) for k in ("mu", "nu"))
    total += shard_bytes(state["opt"]["step"], NamedSharding(mesh, P()))
    total += shard_bytes(batch, sharding.named(st, sharding.batch_specs(st, batch)))
    out["args"][arch] = total

def lowrank_flops(text):
    # the walker's FLOPs of the x @ U dots alone (einsum "...i,ir->...r"
    # and its two gradients), every other dot read as a copy
    keep = lambda l: "...i,ir->...r" in l or " dot(" not in l
    return roofline.analyze_hlo("\n".join(l if keep(l) else l.replace(" dot(", " copy(")
                                           for l in text.splitlines())).flops

devs = jax.devices()
out["collectives"] = {}
for group, arch in (("cells", "qwen3-1.7b"), ("moe_cells", "deepseek-moe-16b"), ("seq_cells", "qwen3-1.7b")):
    out[group] = {}
    for key, (shape, strat, cell) in req[group].items():
        n = shape[0] * shape[1]
        m = jax.sharding.Mesh(np.array(devs[:n]).reshape(shape), ("data", "model"))
        cfg = registry.get_smoke(arch, sparse=True)
        if cell == "train_4k":
            cfg = cfg.replace(remat=False)
        c = D.lower_cell(cfg, SHAPES[cell], m, strategy=strat).compile()
        text = c.as_text()
        walked = roofline.analyze_hlo(text)
        out[group][key] = [walked.flops, c.memory_analysis().argument_size_in_bytes, lowrank_flops(text)]
        out["collectives"][f"{group} {key}"] = dict(walked.collective_bytes)

import jax.numpy as jnp
from repro.serving import Engine, EngineConfig
eng = Engine(registry.get_smoke("qwen3-1.7b", sparse=True), make_tp_mesh(2), engine_cfg=EngineConfig(**req["engine"]))
out["engine"] = eng.roofline()
zeros = jnp.zeros((eng.ecfg.max_slots,), jnp.int32)
with eng.mesh:  # the decode program Engine.roofline() walks
    text = eng._decode.lower(eng.params, eng.kv.buffers, zeros, zeros,
                             jnp.zeros_like(jnp.asarray(eng.kv.page_table))).compile().as_text()
out["engine_lowrank"] = lowrank_flops(text)
print(json.dumps(out))
'''


def _cells() -> dict:
    """The (iv) cells."""
    return {f"{m} {strat} {cell}": [list(shape), strat, cell] for m, shape in MESHES.items()
            for strat in ("fsdp", "tp") for cell in ("prefill_32k", "decode_32k", "train_4k")}


# (iv) smoke deepseek-moe-16b under expert parallelism, one cell a mesh
MOE_CELLS = {"2x2 tp prefill_32k": [[2, 2], "tp", "prefill_32k"], "1x2 tp decode_32k": [[1, 2], "tp", "decode_32k"]}
# (iv) smoke qwen3-1.7b (2 kv heads) at tp 4: the sequence-parallel mode
SEQ_CELLS = {"1x4 tp prefill_32k": [[1, 4], "tp", "prefill_32k"], "1x4 tp decode_32k": [[1, 4], "tp", "decode_32k"],
             "1x4 tp train_4k": [[1, 4], "tp", "train_4k"]}


@pytest.fixture(scope="module", autouse=True)
def _jax_proc():
    """Start the JAX subprocess when the module's first test runs; the
    port-side tests run meanwhile."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512", JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", _JAX], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=err, text=True, env=env)
    proc.stdin.write(json.dumps({"cells": _cells(), "moe_cells": MOE_CELLS, "seq_cells": SEQ_CELLS,
                                 "engine": ENGINE}))
    proc.stdin.close()
    _JAX_STATE.update(proc=proc, err=err)
    yield
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    proc.stdout.close()
    err.close()


_JAX_STATE: dict = {}


def jax_side() -> dict:
    if "out" not in _JAX_STATE:
        proc, err = _JAX_STATE["proc"], _JAX_STATE["err"]
        out = proc.stdout.read()
        proc.wait(timeout=600)
        err.seek(0)
        assert proc.returncode == 0, err.read()[-3000:]
        _JAX_STATE["out"] = json.loads(out.strip().splitlines()[-1])
    return _JAX_STATE["out"]


def meta(shape) -> Mesh:
    return Mesh(("data", "model"), shape, ["meta"] * (shape[0] * shape[1]))


def _spec(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


# ----------------------------------------------------------------------
# (v) one position x positions == the whole mesh
# ----------------------------------------------------------------------

SMALL = {"train": ShapeSpec("t", 256, 8, "train"), "prefill": ShapeSpec("p", 256, 8, "prefill"),
         "decode": ShapeSpec("d", 256, 8, "decode")}


def _whole_mesh_count(cfg, shape: ShapeSpec, mesh: Mesh, strategy: str) -> R.Cost:
    """The count of every replica's program: the step a user runs on the
    whole ``MeshState`` (``make_train_step``'s, ``T.prefill``,
    ``T.decode_step`` over ``init_mesh_cache``'s caches), built here."""
    st = sharding.Strategy(mesh, strategy)
    cfg = D._prep_cfg(cfg, mesh, st)
    state = MeshState(cfg, mesh, strategy, S.params_specs(cfg), copy=False)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device="meta") for k, v in S.input_specs(cfg, shape).items()}
    if shape.kind == "train":
        opt = init_opt_state(OptConfig(), state.shards)
        step = make_train_step(cfg, OptConfig(), microbatches=D.pick_microbatches(cfg, shape, mesh, st))

        def run():
            return step(state, opt, batch)
    elif shape.kind == "prefill":
        def run():
            return T.prefill(cfg, state, batch)
    else:
        caches = T.init_mesh_cache(cfg, state, shape.global_batch, shape.seq_len)

        def run():
            return T.decode_step(cfg, state, caches, batch["tokens"], shape.seq_len - 1)
    with R.counting() as t:
        run()
    return t.cost()


@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_position_times_positions_is_the_whole_mesh(strategy, kind):
    """Every position holds an equal shard of the batch here. FLOPs and the
    gathers' and reduce-scatters' bytes add up exactly; the whole run's
    gather of the logits onto the first position is its one extra
    collective (named); training's optimizer runs each distinct slice once
    in the real step, so its HBM bytes are compared only for inference."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    mesh = meta((2, 2))
    one = D.count_cell(cfg, SMALL[kind], mesh, strategy=strategy)
    whole = _whole_mesh_count(cfg, SMALL[kind], mesh, strategy)
    n = mesh.size
    assert one["cost"].flops * n == whole.flops
    coll = dict(whole.collective_bytes)
    if kind != "train":
        logits = SMALL[kind].global_batch * cfg.padded_vocab * 4
        coll["all-gather"] -= logits  # the whole run's logits onto the first position
        assert one["cost"].bytes_accessed * n == whole.bytes_accessed
    for k, v in one["cost"].collective_bytes.items():
        assert v * n == coll[k], k
    assert one["cost"].collective_bytes and one["argument_bytes"] > 0


# ----------------------------------------------------------------------
# (vi) meta == CPU
# ----------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_count_equals_cpu_count(strategy, kind):
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    sd = T.init_model(cfg, seed=0, device="cpu").state_dict()
    shape = ShapeSpec("x", 128, 4, kind)
    on_meta = D.count_cell(cfg, shape, meta((2, 2)), strategy=strategy)
    on_cpu = D.count_cell(cfg, shape, make_local_mesh(2, 2, ["cpu"] * 4), strategy=strategy, params=sd)
    for key in ("argument_bytes", "temp_bytes", "output_bytes"):
        assert on_meta[key] == on_cpu[key], key
    a, b = on_meta["cost"], on_cpu["cost"]
    assert (a.flops, a.bytes_accessed, a.collective_bytes, a.n_collectives) == (
        b.flops, b.bytes_accessed, b.collective_bytes, b.n_collectives)


# ----------------------------------------------------------------------
# (vii) the fsdp step's collectives by the walker's rule
# ----------------------------------------------------------------------


def test_fsdp_train_collectives_follow_the_walker_rule():
    """Each position gathers every parameter its slices do not cover (an
    all-gather of the whole tensor: the walker counts the result), and
    hands in its gradient of each one (a reduce-scatter of the whole
    gradient where the tensor is cut, an all-reduce where it is
    replicated: the operand), once a microbatch."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    mesh = meta((2, 2))
    shape = SMALL["train"]
    c = D.count_cell(cfg, shape, mesh, strategy="fsdp")
    st = sharding.Strategy(mesh, "fsdp")
    sd = S.params_specs(cfg)
    k = D.pick_microbatches(cfg, shape, mesh, st)
    want = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    for name, spec in sharding.param_specs(st, sd).items():
        nbytes = sd[name].numel() * sd[name].element_size()
        cut = any(sharding.axes_size(mesh, e) > 1 for e in spec)
        if cut:
            want["all-gather"] += k * nbytes
            want["reduce-scatter"] += k * nbytes
        else:
            want["all-reduce"] += k * nbytes
    assert c["cost"].collective_bytes == want
    assert want["all-gather"] > 0 and want["all-reduce"] > 0


# ----------------------------------------------------------------------
# (viii) sharded contiguous prefill and decode
# ----------------------------------------------------------------------


@pytest.mark.parametrize("strategy,shape", [("tp", (1, 2)), ("fsdp", (2, 1))])
def test_sharded_prefill_and_decode_equal_one_device(strategy, shape):
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    model = T.init_model(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(1, 250, size=(4, 128)).astype(np.int64)
    want, caches = T.prefill(cfg, model, {"tokens": toks}, max_len=256)
    nxt = want.argmax(-1)
    want_d, _ = T.decode_step(cfg, model, caches, nxt, 128)
    state = MeshState(cfg, make_local_mesh(*shape, ["cpu"] * 2), strategy, model.state_dict())
    got, mcaches = T.prefill(cfg, state, {"tokens": toks}, max_len=256)
    assert len(mcaches) == (2 if strategy == "fsdp" else 1)
    if strategy == "tp":  # one cache a model shard, each with its kv head
        assert [tuple(c[0]["k"].shape) for c in mcaches[0]] == [(cfg.num_layers, 4, 256, 1, cfg.head_dim)] * 2
    got_d, _ = T.decode_step(cfg, state, mcaches, nxt, 128)
    assert (got - want).abs().max() <= 1e-5
    assert (got_d - want_d).abs().max() <= 1e-5
    assert torch.equal(got_d.argmax(-1), want_d.argmax(-1))


def test_mesh_cache_refuses_a_sequence_cut():
    cfg = registry.get_smoke("smollm-360m", sparse=True)
    state = MeshState(cfg, meta((2, 2)), "fsdp", S.params_specs(cfg))
    with pytest.raises(ValueError, match="item 16"):
        T.init_mesh_cache(cfg, state, 1, 4096)
    # the decode layout's per-position bytes: the port cuts kv heads where
    # the JAX spec cuts head_dim
    qcfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    tp = MeshState(qcfg, meta((1, 2)), "tp", S.params_specs(qcfg))
    ours = T.init_mesh_cache(qcfg, tp, 4, 256, replica=0)[0]
    spec = sharding.cache_specs(tp.st, T.init_cache(qcfg, 4, 256, device="meta"))[0]["k"]
    assert spec[-1] == "model" and ours[0][0]["k"].shape[-2] == qcfg.num_kv_heads // 2
    assert sum(c[0]["k"].numel() for c in ours) == qcfg.num_layers * 4 * 256 * qcfg.num_kv_heads * qcfg.head_dim


# ----------------------------------------------------------------------
# (x) CLIs, report, by-layers
# ----------------------------------------------------------------------

JAX_ROW_KEYS = {
    "arch", "shape", "mesh", "strategy", "sparse", "density", "ok", "lower_s", "compile_s", "bytes_per_device",
    "argument_bytes_per_device", "output_bytes_per_device", "xla_cost_flops_per_device", "hlo_flops_per_device",
    "hlo_bytes_per_device", "collective_bytes_per_device", "collective_breakdown", "compute_s", "memory_s",
    "collective_s", "bottleneck", "roofline_fraction_compute", "model_flops_global", "useful_flops_ratio",
}


def test_dryrun_cli_full_width_cell_and_refusals(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dryrun_baseline_torch.json"
    assert D.main(["--arch", "qwen3-1.7b", "--shape", "train_4k", "--json", str(out)]) == 0
    row, = json.loads(out.read_text())
    assert set(row) == JAX_ROW_KEYS and row["ok"] and row["mesh"] == "16x16" and row["strategy"] == "fsdp"
    assert row["xla_cost_flops_per_device"] is None and row["bottleneck"] in ("compute", "memory", "collective")
    assert row["collective_breakdown"]["all-gather"] > 0 and 0 < row["useful_flops_ratio"] < 1
    # --all over the refused cells: a row each, naming its item; exit 1
    # (deepseek-67b's and kimi-k2's cells count in the sequence-parallel
    # mode, their train cells too, and zamba2-2.7b's with its SSM mixer cut
    # by heads: what is left is the sequence-cut decode cache of
    # smollm-360m's and zamba2-2.7b's long_500k)
    for arch in ("deepseek-67b", "kimi-k2-1t-a32b"):
        train = next(s for s in registry.shapes_for(arch, sparse=True) if s.kind == "train")
        mesh = D.meta_mesh()
        st = sharding.Strategy(mesh, registry.DEFAULT_STRATEGY[arch])
        assert st.tp_size == 16 and L.seq_mode(registry.get(arch), 16)
        D.check_cell(D._prep_cfg(registry.get(arch, sparse=True), mesh, st), train, st)
    monkeypatch.setattr(registry, "ARCH_NAMES", ["smollm-360m", "zamba2-2.7b"])
    shapes_for = registry.shapes_for
    monkeypatch.setattr(registry, "shapes_for", lambda name, sparse=False: [
        s for s in shapes_for(name, sparse=sparse) if s.name == "long_500k"])
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        mesh = D.meta_mesh()
        st = sharding.Strategy(mesh, registry.DEFAULT_STRATEGY["zamba2-2.7b"])
        assert st.tp_size == 16
        D.check_cell(D._prep_cfg(registry.get("zamba2-2.7b", sparse=True), mesh, st), SHAPES[shape], st)
    refused = tmp_path / "refused.json"
    assert D.main(["--all", "--json", str(refused)]) == 1
    rows = json.loads(refused.read_text())
    assert len(rows) == 2 and all(not r["ok"] and "item 16" in r["error"] for r in rows)
    table = report.render(str(refused))
    assert table.count("FAILED") == 2
    both = tmp_path / "both.json"
    both.write_text(json.dumps([row] + rows))
    assert "| qwen3-1.7b | train_4k | 16x16 | fsdp |" in report.render(str(both))
    names = [n for n, _, _ in roofline_report.rows(both)]
    assert names[0] == "roofline/qwen3-1.7b/train_4k/16x16" and len(names) == 3
    assert roofline_report.DEFAULT.name == "dryrun_baseline_torch.json"


def test_hillclimb_appends_a_tagged_row(tmp_path):
    log = tmp_path / "perf_log_torch.json"
    args = ["--arch", "smollm-360m", "--shape", "decode_32k", "--log", str(log), "--override", "sparse_density=0.25"]
    first = hillclimb.main(args + ["--tag", "density-0.25", "--note", "a quarter"])
    hillclimb.main(args + ["--tag", "again"])
    rows = json.loads(log.read_text())
    assert [r["tag"] for r in rows] == ["density-0.25", "again"]
    assert rows[0]["overrides"] == {"sparse_density": "0.25"} and rows[0]["density"] == 0.25
    assert JAX_ROW_KEYS <= set(first)
    with pytest.raises(ValueError):
        hillclimb.main(args + ["--tag", "code", "--override", "sparse_density=__import__('os')"])


@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
def test_count_by_layers_equals_every_layer(strategy):
    """Counting two and three layers and extending gives the count of every
    layer, memory included (smoke widths, extended to 6)."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=6)
    for kind in ("train", "prefill", "decode"):
        full = D.count_cell(cfg, SMALL[kind], meta((2, 2)), strategy=strategy)
        ext = D.count_by_layers(cfg, SMALL[kind], meta((2, 2)), strategy=strategy)
        assert full["cost"] == ext["cost"], kind
        for key in ("temp_bytes", "argument_bytes", "output_bytes"):
            assert full[key] == ext[key], (kind, key)


def test_count_by_layers_of_the_moe_family_equals_every_layer():
    """A model of two layer groups whose last one repeats (smoke
    deepseek-moe-16b: its dense layer, then MoE layers, extended to 6) is
    counted from its dense layer and two and three MoE layers under tp on
    (2, 2): the count of every layer, memory included."""
    cfg = registry.get_smoke("deepseek-moe-16b", sparse=True).replace(num_layers=6)
    assert D._repeated_group(cfg) == 1 and D._repeated_group(registry.get_smoke("zamba2-2.7b")) is None
    for kind in ("train", "prefill", "decode"):
        full = D.count_cell(cfg, SMALL[kind], meta((2, 2)), strategy="tp")
        ext = D.count_by_layers(cfg, SMALL[kind], meta((2, 2)), strategy="tp")
        assert full["cost"] == ext["cost"], kind
        for key in ("temp_bytes", "argument_bytes", "output_bytes"):
            assert full[key] == ext[key], (kind, key)


@pytest.mark.parametrize("strategy,k", [("fsdp", 4), ("tp", 5)])
def test_count_by_microbatches_equals_every_microbatch(strategy, k):
    """A step of k > 3 microbatches counted as two and three microbatches
    extended to k equals the count of the step that runs all k: FLOPs,
    bytes, collectives, and the argument, temp and output bytes."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    mesh = meta((2, 2))
    shape = ShapeSpec("t", 128, 4 * k, "train")
    full = D.count_cell(cfg, shape, mesh, strategy=strategy, microbatches=k)
    ext = D.count_by_microbatches(cfg, shape, mesh, strategy=strategy, microbatches=k)
    assert full["cost"] == ext["cost"]
    assert full["cost"].collective_bytes["reduce-scatter"] > 0
    for key in ("temp_bytes", "argument_bytes", "output_bytes"):
        assert full[key] == ext[key], key


def test_collectives_count_by_the_walker_rule():
    """A join of two positions: an all-gather adds its result's bytes for
    each position, an all-reduce each position's operand bytes, and the
    all-gather's backward one reduce-scatter of each result's gradient;
    the copies and sums inside them add no HBM bytes."""
    from repro_torch.distributed import collectives as C

    a, b = (torch.ones((4, 8), requires_grad=True) for _ in range(2))
    with R.counting() as t:
        outs = C.all_gather([a, b], dim=-1)
        assert len({id(o) for o in outs}) == 2  # a result a position while counting
        (outs[0].sum() + outs[1].sum()).backward()
        hbm = t.bytes
        C.all_reduce([a.detach(), b.detach()])
    one = 4 * 16 * 4  # a (4, 16) fp32 result
    assert t.collective_bytes == {"all-gather": 2 * one, "reduce-scatter": 2 * one, "all-reduce": 2 * 4 * 8 * 4}
    assert t.n_collectives == 4 and t.bytes == hbm  # one all-gather, its two gradients, one all-reduce
    assert torch.equal(a.grad, torch.full((4, 8), 2.0))  # each position's slice of both results


def test_kernel_entry_points_return_shapes_on_meta():
    """Meta is a counting device: each entry point returns an empty result of
    the kernel's shape and dtype and reports its cost; the attention's
    cost reads the host schedule."""
    from repro_torch.kernels import ops

    x = torch.empty((6, 256), device="meta", dtype=torch.bfloat16)
    blocks = torch.empty((4, 2, 64, 64), device="meta", dtype=torch.bfloat16)
    cols = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    y, c = R.count(lambda: ops.bsr_matmul(x, blocks, cols))
    assert y.is_meta and y.shape == (6, 256) and y.dtype == torch.bfloat16
    assert c.flops == 2 * 6 * 8 * 64 * 64
    kv, ok = L._schedule_tensors(256, 64, 2, 0, 1, "meta")
    kv_cpu, ok_cpu = L._schedule_tensors(256, 64, 2, 0, 1, "cpu")
    q = torch.empty((1, 256, 2, 2, 64), device="meta")
    k = torch.empty((1, 256, 2, 64), device="meta")
    kw = dict(block=64, causal=True, sm_scale=0.125)
    o, c = R.count(lambda: ops.block_sparse_attention(q, k, k, kv, ok, **kw))
    assert o.is_meta and o.shape == q.shape
    qc, kc = torch.zeros(q.shape), torch.zeros(k.shape)
    assert (c.flops, c.bytes_accessed) == ops.block_sparse_attention_cost(qc, kc, kc, kv_cpu, ok_cpu, **kw)


# ----------------------------------------------------------------------
# (i) specs
# ----------------------------------------------------------------------


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, val in tree.items() for k, v in _flat(val, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, val in enumerate(tree) for k, v in _flat(val, f"{prefix}{i}/").items()}
    return {prefix[:-1]: _spec(tree)}


def _through_bridge(cfg, jleaves: dict) -> dict:
    """JAX params leaves as the port's names: a stacked leaf is one tensor a
    layer, without the layer axis."""
    out = {}
    for path, (shape, dtype) in jleaves.items():
        names, stacked = port_names(cfg, path)
        for name in names:
            out[name] = [shape[1:] if stacked else shape, dtype]
    return out


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_specs_equal_jax_eval_shape(arch):
    for sparse in (True, False):
        cfg = registry.get(arch, sparse=sparse)
        want = jax_side()["specs"][f"{arch} {sparse}"]
        params = S.params_specs(cfg)
        assert all(t.is_meta for t in params.values())
        assert {n: _spec(t) for n, t in params.items()} == _through_bridge(cfg, want["params"]), sparse
        st = S.state_specs(cfg, OptConfig())
        assert _spec(st["opt"]["step"]) == want["opt"]["step"]
        for key in ("mu", "nu"):
            jmom = {k.removeprefix(f"{key}/"): v for k, v in want["opt"].items() if k.startswith(f"{key}/")}
            assert {n: _spec(t) for n, t in st["opt"][key].items()} == _through_bridge(cfg, jmom), key
        for sh in SHAPES:
            assert _flat(S.input_specs(cfg, SHAPES[sh])) == want["inputs"][sh], sh
        for sh in ("decode_32k", "long_500k"):
            assert _flat(S.decode_cache_specs(cfg, SHAPES[sh])) == want["caches"][sh], sh


# ----------------------------------------------------------------------
# (ii) launcher knobs
# ----------------------------------------------------------------------


def test_prep_cfg_and_microbatches_equal_jax():
    want = jax_side()["prep"]
    got = {}
    for arch in registry.ARCH_NAMES:
        base = registry.get(arch, sparse=True)
        for mp in (False, True):
            mesh = D.meta_mesh(multi_pod=mp)
            for strat in ("tp", "fsdp"):
                st = sharding.Strategy(mesh, strat)
                c = D._prep_cfg(base, mesh, st)
                for sh in SHAPES:
                    got[f"{arch} {mp} {strat} {sh}"] = [c.tp_size, list(c.batch_axes), c.moe_routing_groups,
                                                         D.pick_microbatches(c, SHAPES[sh], mesh, st)]
    assert got == want
    assert {v[3] for v in got.values()} > {1}  # the microbatch rule does bite


# ----------------------------------------------------------------------
# (iii) argument bytes at full width
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch,strategy", [("qwen3-1.7b", "fsdp"), ("musicgen-large", "tp")])
def test_argument_bytes_equal_named_sharding_shards(arch, strategy):
    cell = D.build_cell(registry.get(arch, sparse=True), SHAPES["train_4k"], D.meta_mesh(), strategy=strategy)
    assert cell.argument_bytes == jax_side()["args"][arch]


# ----------------------------------------------------------------------
# (iv) counted FLOPs against the JAX walker
# ----------------------------------------------------------------------


def _attention_pairs(cfg, seq: int) -> tuple[int, int]:
    """(pairs the kernel computes, pairs JAX's gather computes) for one row
    and query head: the causal schedule's visible pairs, and every slot's
    block x block."""
    b = cfg.attn_block
    sched = L.prefill_schedule(seq, b, cfg.attn_local_blocks, cfg.attn_max_stride, cfg.attn_global_blocks)
    rows = np.arange(sched.kv_index.shape[0])[:, None]
    pairs = np.where(sched.valid > 0, np.where(sched.kv_index == rows, b * (b + 1) // 2, b * b), 0).sum()
    return int(pairs), int(sched.kv_index.size * b * b)


def _linears(cfg) -> list[tuple[int, int]]:
    """(n_in, n_out) of a layer's seven pixelfly linears."""
    return [(cfg.d_model, cfg.q_dim), (cfg.d_model, cfg.kv_dim), (cfg.d_model, cfg.kv_dim), (cfg.q_dim, cfg.d_model),
            (cfg.d_model, cfg.d_ff), (cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)]


def _lowrank_flops(cfg, tokens: int, kind: str) -> float:
    """The port's FLOPs of one position's low-rank input products ``x @
    U``: U (n_in x rank) of every pixelfly linear of the model (attention,
    MLP, the MoE family's shared experts) is replicated over the model
    axis, and each shard computes the whole product (``o``'s and
    ``down``'s inputs are all-gathered first). Training has three uses:
    x @ U and its two gradients. The routed experts' low-rank products
    are cut by expert on both sides, and are not among them."""
    uses = 3 if kind == "train" else 1
    lins = [m.spec for m in T.skeleton(cfg).modules() if isinstance(m, Linear) and m.spec.sparse]
    return 2.0 * tokens * uses * sum(spec.in_features * spec.rank for spec in lins)


def _padded_dx(cfg, tokens: int, tp: int) -> float:
    """The FLOPs of the padding slots that the port's dX kernel runs: a
    position's shard of each linear has its own transposed tables, padded
    to their largest fan-in: those of its block rows of the pattern, or,
    where the block rows do not split into tp, of its column view (every
    block's b/tp output columns as tp square blocks of b/tp over
    consecutive input sub-blocks, ``pixelfly.linear_tables``)."""
    pad = 0
    for din, dout in _linears(cfg):
        spec = L.linear_spec(cfg, din, dout, False)
        cols, b = spec.pattern().cols, spec.block
        if tp == 1 or dout % (tp * b) == 0:
            n = len(cols) // tp
            parts = [(cols[r * n: (r + 1) * n], din // b, b) for r in range(tp)]
        else:
            bc = b // tp
            view = (cols[:, :, None] * tp + np.arange(tp)).reshape(len(cols), -1)
            parts = [(view, din // bc, bc)] * tp
        for part, nb_in, blk in parts:
            src_i, _, valid = transpose_tables(part, nb_in)
            pad += (src_i.size - int(valid.sum())) * blk ** 2
    return 2.0 * tokens * pad * cfg.num_layers / tp


def _named_terms(cfg, mesh_shape, strategy, cell, jax_lowrank: float) -> dict:
    """JAX's walker FLOPs minus the port's count of one position, term by
    term:

    - ``masked_pairs``: the pixelfly attention forward. The port's kernel
      counts the schedule's visible pairs; JAX's gather computes every
      scheduled slot's block x block and masks;
    - ``recomputed_attention`` (train): the port's attention backward
      recomputes the gathered forward (``autograd.sparse_attention_vjp``),
      where JAX's autodiff keeps its residuals;
    - ``padded_dx`` (train): the port's dX runs the kernel over every slot
      of the shard's transposed tables, padding included; XLA folds the
      padded slots' dots away (their mask is a constant zero);
    - ``split_lowrank`` (tp): the ``x @ U`` products the port's shards
      compute whole (``_lowrank_flops``) and GSPMD splits over the model
      axis, row-parallel on the input features with a partial sum. Which
      ones it splits depends on the mesh and the step (``o``'s and
      ``down``'s in prefill and in training's forward and dx; ``down``'s
      alone in decode at (1, 2), all seven at (2, 2); every dU in training
      at (2, 2)), so the term is the port's FLOPs
      of these products less the walker's, read from the HLO
      (``lowrank_flops`` of the JAX side: the dots of their einsum);
    - ``whole_block_k_dx`` (train in the sequence-parallel mode with
      qk-norm, one data position): k's cotangent leaves ``k_norm``'s
      backward cut on k's output features, and GSPMD computes k's dX over
      the whole sequence on its shard of ``ceil(nb_out / tp)`` whole block
      rows (padding included), where the port's column view holds
      ``nb_out / tp`` block rows' worth of columns. At (2, 4), and without
      qk-norm, the walker keeps the sequence cut and the term is 0.

    The train cells run with ``remat=False`` on both sides: the two remat
    schemes differ (``transformer.forward_train``'s docstring)."""
    shape = SHAPES[cell]
    dp = mesh_shape[0] * (mesh_shape[1] if strategy == "fsdp" else 1)
    rows = shape.global_batch // dp
    tp = mesh_shape[1] if strategy == "tp" else 1
    tokens = rows * (shape.seq_len if shape.kind != "decode" else 1)
    terms = {}
    if shape.kind != "decode":
        pairs, full = _attention_pairs(cfg, shape.seq_len)
        unit = 4.0 * cfg.head_dim * (cfg.num_heads // tp) * rows * cfg.num_layers
        terms["masked_pairs"] = unit * (full - pairs)
        if shape.kind == "train":
            terms["recomputed_attention"] = -unit * full
            terms["padded_dx"] = -_padded_dx(cfg, tokens, tp)
            if L.seq_mode(cfg, tp) and cfg.qk_norm and mesh_shape[0] == 1:
                pat = L.linear_spec(cfg, cfg.d_model, cfg.kv_dim, False).pattern()
                whole = -(-pat.nb_out // tp) - pat.nb_out / tp
                terms["whole_block_k_dx"] = 2.0 * tokens * pat.r * pat.block ** 2 * whole * cfg.num_layers
    if tp > 1:
        terms["split_lowrank"] = jax_lowrank - _lowrank_flops(cfg, tokens, shape.kind)
    else:  # fsdp: every position computes the products whole, as the port
        assert jax_lowrank == _lowrank_flops(cfg, tokens, shape.kind)
    return terms


@pytest.mark.parametrize("key", list(_cells()))
def test_counted_flops_equal_jax_walker_up_to_named_terms(key):
    m, strategy, cell = key.split()
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    if cell == "train_4k":
        cfg = cfg.replace(remat=False)
    c = D.count_by_microbatches(cfg, SHAPES[cell], meta(MESHES[m]), strategy=strategy)
    jflops, jargs, jlowrank = jax_side()["cells"][key]
    terms = _named_terms(cfg, MESHES[m], strategy, cell, jlowrank)
    assert c["cost"].flops + sum(terms.values()) == jflops, terms
    if strategy == "tp":  # GSPMD splits some of the products, and only these
        assert terms["split_lowrank"] < 0
    assert c["argument_bytes"] == jargs
    if cell == "decode_32k" and strategy == "fsdp":
        assert not terms  # the decode step counts exactly what JAX's does


@pytest.mark.parametrize("key", list(MOE_CELLS))
def test_moe_counted_flops_equal_jax_walker_up_to_named_terms(key):
    """Smoke deepseek-moe-16b under tp: the router's columns, the routed
    experts (their BSR, low-rank and router products cut by expert, as
    GSPMD cuts them) and the shared experts count what the walker counts,
    up to (iv)'s inference terms: the attention's masked pairs and the
    low-rank ``x @ U`` that GSPMD splits and every port shard computes
    whole. The argument bytes equal XLA's."""
    m, strategy, cell = key.split()
    cfg = registry.get_smoke("deepseek-moe-16b", sparse=True)
    c = D.count_by_microbatches(cfg, SHAPES[cell], meta(MESHES[m]), strategy=strategy)
    jflops, jargs, jlowrank = jax_side()["moe_cells"][key]
    terms = _named_terms(cfg, MESHES[m], strategy, cell, jlowrank)
    assert c["cost"].flops + sum(terms.values()) == jflops, terms
    assert terms["split_lowrank"] < 0 and c["argument_bytes"] == jargs
    assert c["cost"].collective_bytes["all-gather"] > 0 and c["cost"].collective_bytes["all-reduce"] > 0


@pytest.mark.parametrize("key", list(SEQ_CELLS))
def test_seq_parallel_counted_flops_equal_jax_walker_up_to_named_terms(key):
    """Smoke qwen3-1.7b at tp 4, whose 2 kv heads the mesh does not divide:
    the JAX rules' sequence-parallel mode (each shard's query rows against
    the whole K/V in prefill and in training; the caches on head_dim and
    the scores' partial sums in decode). The counted FLOPs equal the
    walker's up to (iv)'s terms (the attention's masked pairs, the
    low-rank ``x @ U`` GSPMD splits, and in training the recomputed
    attention, the dX padded slots and k's dX on whole block rows; remat
    off on both sides, as (iv)),
    and the argument bytes equal XLA's. The collective bytes by class are
    printed beside the walker's: GSPMD moves the activations between the
    layouts by all-to-alls and permutes, the port by all-gathers and the
    scores' all-reduce."""
    m, strategy, cell = key.split()
    shape = SEQ_CELLS[key][0]
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    if cell == "train_4k":
        cfg = cfg.replace(remat=False)
    c = D.count_by_microbatches(cfg, SHAPES[cell], meta(tuple(shape)), strategy=strategy)
    jflops, jargs, jlowrank = jax_side()["seq_cells"][key]
    terms = _named_terms(cfg, tuple(shape), strategy, cell, jlowrank)
    assert c["cost"].flops + sum(terms.values()) == jflops, terms
    assert terms["split_lowrank"] < 0 and c["argument_bytes"] == jargs
    ours, walker = dict(c["cost"].collective_bytes), jax_side()["collectives"][f"seq_cells {key}"]
    print(f"{key}: collective bytes of a position, port {ours}, JAX walker {walker}")
    assert ours["all-gather"] > 0 and (cell != "decode_32k" or ours["all-reduce"] > 0)


# ----------------------------------------------------------------------
# (ix) the tp engine's roofline
# ----------------------------------------------------------------------


def test_engine_roofline_at_tp2_equals_jax_record_but_for_dropped_pages():
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    eng = Engine(cfg, engine_cfg=EngineConfig(**ENGINE), mesh=make_tp_mesh(2, ["cpu"] * 2))
    ours = eng.roofline()
    theirs = jax_side()["engine"]
    assert ours["available"] and theirs["available"] and set(ours) == set(theirs)
    assert ours["collective_bytes"] > 0 and theirs["collective_bytes"] > 0
    page, ms = cfg.attn_block, ENGINE["max_slots"]
    table = torch.zeros((ms, ENGINE["max_len"] // page), dtype=torch.int32)
    pos = torch.full((ms,), ENGINE["max_len"] - 1, dtype=torch.int32)
    _, _, keep = L.paged_sparse_schedule(table, pos, page, local_blocks=cfg.attn_local_blocks,
                                         global_blocks=cfg.attn_global_blocks)
    dropped = int((1 - keep).sum())
    per_key = 4.0 * cfg.num_heads // 2 * cfg.head_dim * cfg.num_layers  # a device's heads
    split = _lowrank_flops(cfg, ms, "decode") - jax_side()["engine_lowrank"]  # GSPMD's split x @ U, as in (iv)
    assert split > 0 and ours["flops"] + dropped * page * per_key - split == theirs["flops"]
    assert ours == eng.stats_summary()["roofline"]
    # one device's count: the tp 1 step's, halved, but for the low-rank
    # products every shard computes whole
    one = Engine(cfg, engine_cfg=EngineConfig(**ENGINE), device="cpu").roofline()
    rank = L.linear_spec(cfg, cfg.d_model, cfg.q_dim, False).rank
    replicated = 2.0 * ms * rank * sum(din for din, _ in _linears(cfg)) * cfg.num_layers
    assert ours["flops"] == (one["flops"] + replicated) / 2
