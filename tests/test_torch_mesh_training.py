"""Training on a mesh on the CPU (``Trainer(..., mesh=make_local_mesh(d, m,
["cpu"] * n), strategy=...)``), held to the JAX ``Trainer``'s contract that
GSPMD does not change what a step computes: (a) one step on fsdp (2, 1),
fsdp (1, 2), tp (1, 2) and tp (2, 2) equals the JAX ``Trainer``'s jitted
step on ``make_tp_mesh(1)`` within ``test_torch_training._check_step``'s
tolerances (sparse and dense smoke qwen3-1.7b on bridged weights, and
compressed gradients at fsdp (2, 1)); (b) a 3-step history equals the
single-device ``Trainer``'s within 1e-5, and the two shard faults that
``chip_smoke.py`` phase 15 plants each miss it by more than 100x; (c) the
MoE, SSM, hybrid and vlm families under fsdp equal the JAX ``Trainer``'s
step as (a) holds it, and refuse what is not ported, naming the ROADMAP
item; (d) every position's slice is
the one ``NamedSharding.devices_indices_map`` gives (JAX in a subprocess on
eight forced host devices), and the shards round-trip exactly; (e) a
checkpoint taken on one mesh resumes on another and on one device; (f) the
collectives, the row-sliced pixelfly backward and the CLI."""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh as jax_make_tp_mesh
from repro.training import data as jdata
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.core.pixelfly import Linear
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import data as tdata
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import MeshState, TrainConfig, Trainer, make_train_step
from repro_torch.training.optimizer import OptConfig, init_opt_state
from test_torch_training import _check_step, _int8_boundaries, _jax_grads, _unsharded

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"fsdp (2, 1)": ("fsdp", (2, 1)), "fsdp (1, 2)": ("fsdp", (1, 2)),
          "tp (1, 2)": ("tp", (1, 2)), "tp (2, 2)": ("tp", (2, 2))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_local_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# (a) one step against the JAX Trainer on make_tp_mesh(1)
# ----------------------------------------------------------------------

_JAX_STEPS: dict = {}


def _jax_trainer_step(jcfg, jo, data, strategy):
    """The JAX ``Trainer`` on ``make_tp_mesh(1)`` under ``strategy``: its
    initial params, and its state and metrics after one step on
    ``data``'s batch 0."""
    handler = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory() as d:
        tr = jloop.Trainer(jcfg, jo, data, jax_make_tp_mesh(1),
                           jloop.TrainConfig(steps=1, ckpt_dir=d, ckpt_every=10 ** 9, log_every=10 ** 9),
                           strategy=strategy)
        signal.signal(signal.SIGTERM, handler)  # the JAX Trainer installs its own for good
        params = jax.tree.map(np.asarray, tr.state["params"])
        (jm,) = tr.run(1)
        return params, jax.tree.map(np.asarray, tr.state), jm


def _jax_step(sparse, strategy, compress):
    """``_jax_trainer_step`` of smoke qwen3-1.7b with its first batch
    (cached: the meshes of one case share it)."""
    key = (sparse, strategy, compress)
    if key not in _JAX_STEPS:
        jcfg = jreg.get_smoke("qwen3-1.7b", sparse=sparse).replace(num_layers=2, vocab_size=256)
        jo = jopt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10, compress_grads=compress)
        params, jstate, jm = _jax_trainer_step(jcfg, jo, jdata.SyntheticLM(256, 128, 4, seed=3), strategy)
        _JAX_STEPS[key] = (jcfg, params, jdata.SyntheticLM(256, 128, 4, seed=3).batch(0), jstate, jm)
    return _JAX_STEPS[key]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_mesh_step_matches_jax_trainer(sparse, mesh):
    """Loss, grad_norm, lr, mu, nu and the parameters after one step on
    the mesh equal the JAX Trainer's on ``make_tp_mesh(1)`` under the same
    strategy (``_check_step``'s tolerances)."""
    strategy, shape = MESHES[mesh]
    jcfg, params, batch, jstate, jm = _jax_step(sparse, strategy, False)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=sparse).replace(num_layers=2, vocab_size=256)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ms = MeshState(cfg, _mesh(shape), strategy, params_from_jax(params, cfg, "cpu"))
    opt_state = init_opt_state(opt, ms.shards)
    m = make_train_step(cfg, opt)(ms, opt_state, batch)
    model, state = _unsharded(ms, opt_state)
    _check_step(cfg, opt, opt.lr, _jax_grads(jcfg, cfg, params, batch), jstate, jm, model, state, m)


def test_compressed_mesh_step_matches_jax_trainer():
    """With int8 error-feedback compression at fsdp (2, 1): the same, with
    the int8 rounding flips ``_check_step`` allows."""
    jcfg, params, batch, jstate, jm = _jax_step(True, "fsdp", True)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=2, vocab_size=256)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10, compress_grads=True)
    ms = MeshState(cfg, _mesh((2, 1)), "fsdp", params_from_jax(params, cfg, "cpu"))
    opt_state = init_opt_state(opt, ms.shards)
    m = make_train_step(cfg, opt)(ms, opt_state, batch)
    model, state = _unsharded(ms, opt_state)
    jgrads = _jax_grads(jcfg, cfg, params, batch)
    _check_step(cfg, opt, opt.lr, jgrads, jstate, jm, model, state, m, flips=_int8_boundaries(jgrads, cfg))


# ----------------------------------------------------------------------
# (b) the mesh is invisible in the history; planted faults are not
# ----------------------------------------------------------------------


def _small():
    return registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=2, vocab_size=64)


def _trainer(path, mesh=None, strategy="fsdp", cfg=None, steps=20, batch=4):
    cfg = cfg or _small()
    return Trainer(cfg, OptConfig(lr=1e-2, warmup_steps=2, total_steps=steps),
                   SyntheticLM(cfg.vocab_size, 64, batch, seed=0),
                   TrainConfig(steps=steps, ckpt_dir=str(path), ckpt_every=10 ** 9, log_every=10 ** 9),
                   device="cpu" if mesh is None else None, mesh=mesh, strategy=strategy)


def _history_gap(hist, ref) -> float:
    """The largest difference in loss or grad_norm between two histories,
    as ``assert_allclose(rtol=tol, atol=tol)`` reads a tolerance: |a - b| /
    (1 + |b|)."""
    return max(abs(a[k] - b[k]) / (1 + abs(b[k])) for a, b in zip(hist, ref) for k in ("loss", "grad_norm"))


_SINGLE: dict = {}


def _single_history():
    if "hist" not in _SINGLE:
        with tempfile.TemporaryDirectory() as d:
            _SINGLE["hist"] = _trainer(d).run(3)
    return _SINGLE["hist"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_is_invisible_in_the_history(mesh, tmp_path):
    """3 ``Trainer.run`` steps on the mesh: losses and grad norms within
    1e-5 (``_history_gap``) of the single-device ``Trainer``'s, the step
    count and lr the same."""
    strategy, shape = MESHES[mesh]
    t = _trainer(tmp_path, _mesh(shape), strategy)
    hist = t.run(3)
    ref = _single_history()
    assert [h["step"] for h in hist] == [1, 2, 3] and [h["lr"] for h in hist] == [h["lr"] for h in ref]
    assert _history_gap(hist, ref) <= 1e-5, (hist, ref)
    assert t.mesh.distinct_devices == 1 and len(t.model.devices) == shape[0] * shape[1]


def test_one_position_mesh_is_the_single_device_trainer(tmp_path):
    """``Trainer(device="cpu")`` is the (1, 1) mesh of the CPU: 2 steps
    give an explicit (1, 1) mesh's losses, grad norms, parameters and
    moments bit for bit."""
    one = _trainer(tmp_path / "one")
    assert one.mesh.shape == {"data": 1, "model": 1} and one.model.devices == [torch.device("cpu")]
    mesh = _trainer(tmp_path / "mesh", _mesh((1, 1)))
    for a, b in zip(one.run(2), mesh.run(2)):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    got, want = mesh.state(), one.state()
    for name, p in want["params"].items():
        assert torch.equal(got["params"][name], p), name
        assert torch.equal(got["opt"]["nu"][name], want["opt"]["nu"][name]), name


@pytest.mark.parametrize("fault,mesh", [("replicated grad", "tp (1, 2)"), ("global count", "fsdp (2, 1)")])
def test_planted_faults_miss_the_history(fault, mesh, tmp_path):
    """``chip_smoke.planted_train_fault``: a tensor every model shard holds
    taking its gradient from shard 0 alone, and the second data replica's
    rows left out of the global count. Each moves the history by more than
    100x the 1e-5 it is held to."""
    strategy, shape = MESHES[mesh]
    t = _trainer(tmp_path, _mesh(shape), strategy)
    with _chip_smoke().planted_train_fault(fault):
        hist = t.run(3)
    assert _history_gap(hist, _single_history()) > 100 * 1e-5


# ----------------------------------------------------------------------
# (c) the other families
# ----------------------------------------------------------------------


def _family_data(data_mod, cfg):
    """B = 2, S = 64 batches of ``data_mod`` (the port's ``training.data``
    or the JAX package's): tokens, or the stub frontend's embeddings for a
    backbone that reads them."""
    src = data_mod.SyntheticLM(cfg.vocab_size, 64, 2, seed=1)
    if not cfg.embed_inputs:
        src = data_mod.EmbedsWrapper(src, cfg.d_model, n_pos_streams=len(cfg.mrope_sections))
    return src


def _one_step(cfg, sd, mesh, strategy="fsdp"):
    """One ``make_train_step`` step of ``sd`` on ``mesh``: the metrics, the
    ``MeshState`` and its optimizer state."""
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ms = MeshState(cfg, mesh, strategy, sd)
    state = init_opt_state(opt, ms.shards)
    m = make_train_step(cfg, opt)(ms, state, _family_data(tdata, cfg).batch(0))
    return m, ms, state


@pytest.mark.parametrize("arch,over", [("mamba2-130m", {}), ("deepseek-moe-16b", {"moe_routing_groups": 2}),
                                       ("zamba2-2.7b", {}), ("qwen2-vl-7b", {})])
def test_families_under_fsdp_equal_one_device(arch, over):
    """One step at fsdp (2, 1) equals the JAX ``Trainer``'s on one device
    (``make_tp_mesh(1)``, strategy fsdp) from its bridged initial params:
    ``_check_step``'s tolerances, and nll and lb_loss within 1e-5.
    deepseek-moe routes 2 groups, one a replica (its load-balance loss is
    not 0); qwen2-vl-7b reads embeddings and M-RoPE positions, split by
    rows as the tokens."""
    cfg = registry.get_smoke(arch, sparse=True).replace(num_layers=2, **over)
    jcfg = jreg.get_smoke(arch, sparse=True).replace(num_layers=2, **over)
    jo = jopt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params, jstate, jm = _jax_trainer_step(jcfg, jo, _family_data(jdata, cfg), "fsdp")
    m, ms, state = _one_step(cfg, params_from_jax(params, cfg, "cpu"), _mesh((2, 1)))
    for k in ("nll", "lb_loss"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * (1 + abs(float(jm[k]))), (k, m[k], jm[k])
    if arch == "deepseek-moe-16b":
        assert float(m["lb_loss"]) > 0
    batch = _family_data(jdata, cfg).batch(0)
    model, state = _unsharded(ms, state)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    _check_step(cfg, opt, opt.lr, _jax_grads(jcfg, cfg, params, batch), jstate, jm, model, state, m)


def test_refusals_name_their_roadmap_items(tmp_path):
    """One routing group does not split over two replicas: the MoE family
    refuses fsdp (2, 1) saying so. Under tp the SSM and hybrid families
    take tp 2, which divides their SSM heads, and refuse tp 3, which does
    not (item 24); kv heads tp does not divide are refused where the router
    cannot shard (item 16: kimi-k2 at tp 16, whose experts would shard);
    where they can, the ``Trainer`` trains in the sequence-parallel mode:
    one step at (1, 4) within 1e-5 of the single-device step."""
    moe = registry.get_smoke("deepseek-moe-16b", sparse=True).replace(num_layers=2)
    sd = T.init_model(moe, seed=0, device="cpu").state_dict()
    with pytest.raises(ValueError, match="routing group"):
        _one_step(moe, sd, _mesh((2, 1)))
    kimi = registry.get_smoke("kimi-k2-1t-a32b", sparse=True).replace(num_layers=2)
    with pytest.raises(ValueError, match="item 16"):
        MeshState(kimi, Mesh(("data", "model"), (1, 16), ["meta"] * 16), "tp", T.skeleton(kimi).state_dict())
    for arch in ("mamba2-130m", "zamba2-2.7b"):
        ssm = registry.get_smoke(arch, sparse=True)
        sd = T.skeleton(ssm).state_dict()
        assert MeshState(ssm, Mesh(("data", "model"), (1, 2), ["meta"] * 2), "tp", sd).tp == 2
        with pytest.raises(ValueError, match="item 24"):
            MeshState(ssm, Mesh(("data", "model"), (1, 3), ["meta"] * 3), "tp", sd)
    seq = _trainer(tmp_path, mesh=_mesh((1, 4)), strategy="tp")
    assert L.seq_mode(seq.model_cfg, 4)
    assert _history_gap(seq.run(1), _single_history()[:1]) <= 1e-5


# ----------------------------------------------------------------------
# (d) the layout is JAX's
# ----------------------------------------------------------------------

LAYOUT_MESHES = {"(2, 2)": (("data", "model"), (2, 2)), "(4, 1)": (("data", "model"), (4, 1)),
                 "(2, 2, 2)": (("pod", "data", "model"), (2, 2, 2))}

_JAX_LAYOUT = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
req = json.load(sys.stdin)
meshes = {key: Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), tuple(axes))
          for key, (axes, shape) in req["meshes"].items()}
out = {}
for tag, (key, spec, dims) in req["tensors"].items():
    mesh = meshes[key]
    spec = PartitionSpec(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(dims))
    out[tag] = [[[s.start or 0, dims[d] if s.stop is None else s.stop] for d, s in enumerate(idx[dev])]
                for dev in mesh.devices.flat]
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_position_slices_equal_named_sharding(arch):
    """Every parameter of the smoke model under both strategies on the
    (2, 2), (4, 1) and (2, 2, 2) meshes: each position's slice equals the
    device's index in ``NamedSharding(mesh, spec).devices_indices_map``,
    and ``unshard_state_dict(shard_state_dict(sd)) == sd`` exactly."""
    cfg = registry.get_smoke(arch, sparse=True)
    sd = T.init_model(cfg, seed=0, device="cpu").state_dict()
    tensors, ours = {}, {}
    for kind in ("tp", "fsdp"):
        for key, (axes, shape) in LAYOUT_MESHES.items():
            mesh = Mesh(axes, shape, ["cpu"] * int(np.prod(shape)))
            st = sharding.Strategy(mesh, kind)
            specs = sharding.param_specs(st, sd)
            for name, spec in specs.items():
                tag = f"{key} {kind} {name}"
                tensors[tag] = (key, [list(e) if isinstance(e, tuple) else e for e in spec], list(sd[name].shape))
                ours[tag] = [[list(x) for x in sl] for sl in sharding.position_slices(mesh, spec, sd[name].shape)]
            parts = sharding.shard_state_dict(st, mesh, sd)
            assert len(parts) == mesh.size
            back = sharding.unshard_state_dict(st, parts, specs)
            assert all(torch.equal(back[n], t) and back[n].dtype == t.dtype for n, t in sd.items()), key
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    req = {"meshes": {k: [list(a), list(s)] for k, (a, s) in LAYOUT_MESHES.items()}, "tensors": tensors}
    res = subprocess.run([sys.executable, "-c", _JAX_LAYOUT], input=json.dumps(req), capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout)
    assert want == ours
    # a tuple of axes cuts row-major in its order, as NamedSharding does
    assert any(isinstance(e, list) and len(e) > 1 for _, spec, _ in tensors.values() for e in spec)


# ----------------------------------------------------------------------
# (e) elastic resume
# ----------------------------------------------------------------------


@pytest.mark.parametrize("resume_on", ["tp (1, 2)", "one device"])
def test_checkpoint_resumes_on_another_mesh(resume_on, tmp_path):
    """2 steps at fsdp (2, 1), a checkpoint, then 2 more steps on another
    mesh or on one device: the losses equal the uninterrupted 4-step
    run's within 1e-5, and the new trainer resumes the data stream at step
    2."""
    whole = _trainer(tmp_path / "whole").run(4)
    first = _trainer(tmp_path / "ck", _mesh((2, 1)), "fsdp")
    first.run(2)
    first.checkpoint()
    if resume_on == "one device":
        second = _trainer(tmp_path / "ck")
    else:
        second = _trainer(tmp_path / "ck", _mesh((1, 2)), "tp")
    assert second.step == 2 and second.opt["step"] == 2
    rest = second.run(2)
    assert [h["step"] for h in rest] == [3, 4]
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(rest, whole[2:])) <= 1e-5


def test_single_device_checkpoint_resumes_on_a_mesh(tmp_path):
    """The other direction: a single-device checkpoint resumes at tp (2, 2),
    its parameters and moments cut from the whole tensors exactly."""
    first = _trainer(tmp_path)
    first.run(1)
    first.checkpoint()
    second = _trainer(tmp_path, _mesh((2, 2)), "tp")
    got, want = second.state(), first.state()
    for name, p in want["params"].items():
        assert torch.equal(got["params"][name], p), name
        assert torch.equal(got["opt"]["mu"][name], want["opt"]["mu"][name]), name


# ----------------------------------------------------------------------
# (f) collectives, the row-sliced backward, the CLI
# ----------------------------------------------------------------------


def test_reduce_scatter_and_scalars():
    """The fp32 sum of the positions' tensors in rank order, cut into the
    shard sizes; with ``out`` the same sum added in turn; ``dim=None`` one
    whole shard; a single term is returned as it is. The scalar reduction sums or takes the max in order."""
    g = torch.Generator().manual_seed(0)
    fulls = [torch.randn(6, 5, generator=g).to(torch.bfloat16) for _ in range(3)]
    got = C.reduce_scatter(fulls, 0, [2, 4], ["cpu", "cpu"])
    total = fulls[0].float() + fulls[1].float() + fulls[2].float()
    assert torch.equal(got[0], total[:2]) and torch.equal(got[1], total[2:]) and got[0].dtype == torch.float32
    acc = None
    for f in fulls:
        acc = C.reduce_scatter([f], 0, [2, 4], ["cpu", "cpu"], out=acc)
    assert all(torch.equal(a, b) for a, b in zip(acc, got))
    (whole,) = C.reduce_scatter(fulls, None, [1], ["cpu"])
    assert torch.equal(whole, total)
    (one,) = C.reduce_scatter(fulls[:1], None, [1], ["cpu"])
    assert one is fulls[0]  # one term: itself, uncast
    vals = [torch.tensor(1.5), torch.tensor(-2.0), torch.tensor(4.0)]
    assert float(C.reduce_scalars(vals, "sum", "cpu")) == 3.5
    assert float(C.reduce_scalars(vals, "max", "cpu")) == 4.0
    with pytest.raises(ValueError):
        C.reduce_scalars(vals, "min", "cpu")


def test_row_sliced_pixelfly_backward_sums_to_the_full_linear():
    """A pixelfly linear cut into 2 row shards (``Linear.rows``): each
    shard's dX is a partial sum over all input blocks (the transposed
    pattern of its rows), and the two add up to the full linear's dX; each
    shard's dBlocks and dV are its rows of the full ones, and dU, dγ sum."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    spec = L.linear_spec(cfg, 256, 512, False)
    full = Linear(spec, gen=torch.Generator().manual_seed(0), device=torch.device("cpu"))
    x = torch.randn(8, 256, generator=torch.Generator().manual_seed(1), requires_grad=True)
    dy = torch.randn(8, 512, generator=torch.Generator().manual_seed(2))
    full(x).backward(dy)
    mesh = Mesh(("data", "model"), (1, 2), ["cpu"] * 2)
    sd = {k: v.detach() for k, v in full.state_dict().items()}
    st = sharding.Strategy(mesh, "tp")
    specs = {n: sharding.param_specs(st, {f"layers.0.attn.wq.{n}": t})[f"layers.0.attn.wq.{n}"] for n, t in sd.items()}
    dx, grads = 0.0, []
    nb = spec.pattern().nb_out // 2
    for r in range(2):
        shard = Linear(spec, gen=torch.Generator(), device=torch.device("cpu"))
        part = {n: sharding.take(t, sharding.position_slices(mesh, specs[n], t.shape)[r]) for n, t in sd.items()}
        T.assign(shard, part, trainable=True)
        shard.rows = (r * nb, (r + 1) * nb)
        xr = x.detach().requires_grad_()
        shard(xr).backward(dy[:, r * 256 : (r + 1) * 256])
        dx = dx + xr.grad
        grads.append(dict(shard.named_parameters()))
    torch.testing.assert_close(dx, x.grad, rtol=1e-5, atol=1e-5)
    for name in ("blocks", "V"):
        got = torch.cat([g[name].grad for g in grads])
        torch.testing.assert_close(got, getattr(full, name).grad, rtol=1e-5, atol=1e-5)
    for name in ("U", "gamma"):
        torch.testing.assert_close(grads[0][name].grad + grads[1][name].grad, getattr(full, name).grad,
                                   rtol=1e-5, atol=1e-5)


def test_train_cli_strategy_and_production_mesh(tmp_path, capsys):
    """``--strategy tp --device cpu`` trains on ``make_local_mesh`` over
    the CPU and checkpoints; ``--production-mesh`` exits naming the 256
    devices it needs."""
    launch_train.main(["--arch", "qwen3-1.7b", "--sparse", "--smoke", "--strategy", "tp", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "64", "--ckpt-dir", str(tmp_path)])
    assert "final loss" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["step_00000003"]
    with pytest.raises(SystemExit, match="needs 256 devices, this machine has 1"):
        launch_train.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--production-mesh"])


def test_trainer_on_a_mesh_takes_no_device():
    with pytest.raises(ValueError, match="devices from the mesh"):
        Trainer(_small(), OptConfig(), SyntheticLM(64, 16, 2), TrainConfig(ckpt_dir=tempfile.mkdtemp()),
                device="cpu", mesh=_mesh((1, 1)))
