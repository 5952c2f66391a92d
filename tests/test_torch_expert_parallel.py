"""Expert parallelism for the MoE family on the CPU, held against the JAX
package at tp 1 (``make_tp_mesh(1)``; the same weights through ``bridge``):

(a) ``moe.apply_moe_tp`` at tp 2 and 4 (each shard the router columns and
the experts of its slice of E, the shared experts cut by the pixelfly
rules, row slices at tp 2 and output-column slices at tp 4): y within
fp32 rtol = atol = 1e-5 and the load-balance loss within 1e-6 of
``repro.models.moe.apply_moe``, the routing (top-k, sort, kept set) equal
exactly with pairs dropped, and every gradient within 1e-5 of its
largest entry (a shard's slice of a cut tensor, the shards' sum of a
replicated one);
(b) a column-sliced pixelfly linear (smoke deepseek-moe-16b with
``moe_dense_ff=192``: 3 block rows of 64, which tp 2 and 4 do not
divide): the shards' gathered output, dX, dBlocks, dU, dV and dγ equal the
JAX linear's within 1e-5 (relative to each one's largest entry), and every
position's slice of every parameter equals ``NamedSharding``'s placement
of the JAX rules' spec (JAX in a subprocess on 4 forced host devices);
(c) the tp engine's greedy streams equal the JAX engine's for smoke
deepseek-moe-16b (tp 2, and tp 4 with the column slices) and kimi-k2
(tp 2), token for token, and ``serve --tp 2 --strategy tp`` prints one
device's grid;
(d) one mesh-trainer step of smoke deepseek-moe-16b at tp (1, 2) and
(2, 2), and at (1, 4) with the column-sliced dense layer, equals the JAX
``Trainer``'s step (``test_torch_training.
_check_step``'s tolerances; nll and lb_loss within 1e-5);
(e) the dry-run's sweep splits 56 cells that count and 10 refused,
deepseek-moe-16b's six among the first, and kimi-k2's six, its two
training cells among them (the sequence-parallel mode serves and trains;
``launch.dryrun.sweep_split``)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import pixelfly as jpf
from repro.launch.mesh import make_tp_mesh as jax_make_tp_mesh
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax, port_names
from repro_torch.configs import registry
from repro_torch.core.pixelfly import Linear
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_tp_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.training.optimizer import OptConfig
from test_torch_mesh_training import _family_data, _jax_trainer_step, _one_step
from test_torch_moe import _leaves, _pair, _reference_routing, _x
from test_torch_training import _check_step, _jax_grads, _unsharded


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


def _cols_cfg(mod):
    """Smoke deepseek-moe-16b with a dense layer of 3 block rows (of 64)."""
    return mod.get_smoke("deepseek-moe-16b", sparse=True).replace(moe_dense_ff=192)


# ----------------------------------------------------------------------
# (a) the sharded MoE FFN
# ----------------------------------------------------------------------

MOE = dict(sparse=True, sparse_density=0.6, sparse_block=16, moe_d_ff=48, moe_num_shared=2,
           moe_routing_groups=2, moe_capacity_factor=0.5)
PREFIX = "layers.1.moe."


def _moe_shards(module: moe.Moe, tp: int) -> tuple[list[moe.Moe], dict, Mesh]:
    """``module`` cut by the JAX rules' tp specs (as a layer's ``moe``) into
    ``tp`` trainable shards on the CPU, and the specs."""
    mesh = make_tp_mesh(tp, ["cpu"] * tp)
    st = sharding.Strategy(mesh, "tp")
    sd = {PREFIX + k: v for k, v in module.state_dict().items()}
    specs = sharding.param_specs(st, sd)
    shards = []
    for r, part in enumerate(sharding.shard_state_dict(st, mesh, sd)):
        with torch.device("meta"):
            shard = moe.Moe(module.spec.cfg, gen=torch.Generator(), device=torch.device("meta"))
        T.assign(shard, {k.removeprefix(PREFIX): v for k, v in part.items()}, trainable=True)
        T.mark_linear_slices(shard, r)
        shards.append(shard)
    return shards, specs, mesh


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_apply_moe_equals_reference(tp):
    spec, params, module = _pair(seed=5, **MOE)
    shards, specs, mesh = _moe_shards(module, tp)
    assert shards[0].router.shape[1] == 8 // tp and shards[0].wg.blocks.shape[0] == 8 // tp
    wg = shards[0].shared.wg  # 6 block rows of 16: rows at tp 2, output columns at tp 4
    assert (wg.rows is None) == (tp == 4) and (wg.cols is None) == (tp == 2)
    x, w = _x((2, 24, 64), seed=2), _x((2, 24, 64), seed=3)

    def jloss(p, xx):
        y, aux = jmoe.apply_moe(spec, p, xx)
        return jnp.sum(y * w) + aux["lb_loss"], (y, aux["lb_loss"])

    (_, (jy, jlb)), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    ys, lb = moe.apply_moe_tp(shards, [xt] * tp)
    for y in ys:
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(lb.detach()), float(jlb), rtol=1e-6, atol=1e-6)
    # every shard routes as the reference: the same choices, order and drops
    logits = C.all_gather([moe.router_logits(spec.cfg, s.router, xt) for s in shards], dim=-1)
    idx, order, keep, cap = _reference_routing(spec, params, jnp.asarray(x))
    for lg in logits:
        r = moe.route_logits(module.spec.cfg, lg.detach())
        assert r.cap == cap
        np.testing.assert_array_equal(r.idx.numpy(), idx)
        np.testing.assert_array_equal(r.order.numpy(), order)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert 0 < (~keep).sum() < keep.size
    loss = sum((y * torch.from_numpy(w)).sum() for y in ys) / tp + lb
    names = [n for n, _ in shards[0].named_parameters()]
    leaves = [p for s in shards for _, p in s.named_parameters()]
    grads = torch.autograd.grad(loss, leaves + [xt])
    assert _rel(grads[-1], gx) <= 1e-5
    want = dict(_leaves(gp))
    assert set(names) == set(want)
    for i, n in enumerate(names):
        per = [grads[j * len(names) + i] for j in range(tp)]
        full = want[n]
        if sharding.model_dim(sharding.Strategy(mesh, "tp"), specs[PREFIX + n]) is None:
            assert _rel(sum(per), full) <= 1e-5, n  # replicated: the shards' uses add up
        else:
            for j, sl in enumerate(sharding.position_slices(mesh, specs[PREFIX + n], full.shape)):
                part = full[tuple(slice(a, b) for a, b in sl)]
                assert np.abs(per[j].numpy() - part).max() <= 1e-5 * max(np.abs(full).max(), 1e-30), (n, j)


# ----------------------------------------------------------------------
# (b) the column-sliced pixelfly linear
# ----------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_column_sliced_linear_equals_full_linear(tp):
    jcfg, cfg = _cols_cfg(jreg), _cols_cfg(registry)
    params = JT.init_model(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda a: a[0], params["groups"]["dense_0"]["mlp"]["wg"])
    model = T.init_model(cfg, device="cpu", params=params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu"))
    full = model.layers[0].mlp.wg
    assert tuple(full.blocks.shape[:1]) == (3,) and full.blocks.shape[-1] == 64
    mesh = make_tp_mesh(tp, ["cpu"] * tp)
    sd = model.state_dict()
    parts = sharding.shard_state_dict(sharding.Strategy(mesh, "tp"), mesh, sd)
    sharded = T.build_shards(cfg, mesh.model_devices(), parts, trainable=True)
    lins = [sh.layers[0].mlp.wg for sh in sharded.shards]
    bc = 64 // tp
    assert [lin.cols for lin in lins] == [(r * bc, (r + 1) * bc) for r in range(tp)]
    assert [tuple(lin.blocks.shape) for lin in lins] == [(3, full.blocks.shape[1], 64, bc)] * tp
    x = np.random.default_rng(0).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    dy = np.random.default_rng(1).standard_normal((2, 5, 192)).astype(np.float32)
    jspec = jpf.LinearSpec.pixelfly(cfg.d_model, 192, jcfg.sparse_density, block=jcfg.sparse_block,
                                    lowrank_frac=jcfg.lowrank_frac)
    y, vjp = jax.vjp(lambda p, xx: jpf.apply_linear(jspec, p, xx), jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    out = L.in_feature_order(lins[0], C.all_gather(L.tp_linear(lins, [xt] * tp), dim=-1))
    for o in out:
        assert _rel(o, y) <= 1e-5
    out[0].backward(torch.from_numpy(dy))
    assert _rel(xt.grad, gx) <= 1e-5
    gp = {k: np.asarray(v) for k, v in gp.items()}
    for r, lin in enumerate(lins):
        assert _rel(lin.blocks.grad, gp["blocks"][..., r * bc:(r + 1) * bc]) <= 1e-5 * np.abs(gp["blocks"]).max() / \
            np.abs(gp["blocks"][..., r * bc:(r + 1) * bc]).max()
        rows = 192 // tp
        assert np.abs(lin.V.grad.numpy() - gp["V"][r * rows:(r + 1) * rows]).max() <= 1e-5 * np.abs(gp["V"]).max()
    assert _rel(sum(lin.U.grad for lin in lins), gp["U"]) <= 1e-5
    assert _rel(sum(lin.gamma.grad for lin in lins), gp["gamma"]) <= 1e-5


_JAX_SLICES = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import registry
from repro.distributed import sharding
from repro.models import transformer as JT
req = json.load(sys.stdin)
cfg = registry.get_smoke("deepseek-moe-16b", sparse=True).replace(moe_dense_ff=192)
params = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), cfg))
out = {}
for key, shape in req.items():
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), ("data", "model"))
    specs = sharding.param_specs(sharding.Strategy(mesh, "tp"), params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for (path, x), spec in zip(leaves, spec_leaves):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        idx = NamedSharding(mesh, spec).devices_indices_map(tuple(x.shape))
        out[f"{key} {name}"] = {
            "spec": [list(e) if isinstance(e, tuple) else e for e in spec] + [None] * (len(x.shape) - len(spec)),
            "slices": [[[s.start or 0, x.shape[d] if s.stop is None else s.stop] for d, s in enumerate(idx[dev])]
                       for dev in mesh.devices.flat]}
print(json.dumps(out))
"""

SLICE_MESHES = {"(1, 2)": (1, 2), "(1, 4)": (1, 4), "(2, 2)": (2, 2)}


def test_column_slices_equal_named_sharding():
    """Every parameter of the smoke model with column-sliced linears, on
    (1, 2), (1, 4) and (2, 2) under tp: the port's spec is the JAX rules'
    (its leading layer entry dropped where the JAX leaf is stacked) and each
    position's slice is ``NamedSharding``'s; the column-sliced blocks and
    the expert axis are among them."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _JAX_SLICES], input=json.dumps(SLICE_MESHES), capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = _cols_cfg(registry)
    sd = T.skeleton(cfg).state_dict()
    seen = set()
    for key, shape in SLICE_MESHES.items():
        mesh = Mesh(("data", "model"), shape, ["cpu"] * (shape[0] * shape[1]))
        specs = sharding.param_specs(sharding.Strategy(mesh, "tp"), sd)
        for tag, w in want.items():
            if not tag.startswith(key + " "):
                continue
            names, stacked = port_names(cfg, tag[len(key) + 1:])
            for i, name in enumerate(names):
                jspec = [tuple(e) if isinstance(e, list) else e for e in w["spec"]]
                jspec = jspec[1:] if stacked else jspec
                ours = sharding.position_slices(mesh, specs[name], sd[name].shape)
                spec = list(specs[name]) + [None] * (sd[name].ndim - len(specs[name]))
                assert spec == jspec, (key, name)
                assert [[list(d) for d in sl] for sl in ours] == [s[1:] if stacked else s for s in w["slices"]], \
                    (key, name)
                seen.add((name, tuple(spec)))
    assert ("layers.0.mlp.wg.blocks", (None, None, None, "model")) in seen
    assert any(n == "layers.1.moe.wg.blocks" and s[0] == "model" for n, s in seen)
    assert any(n == "layers.1.moe.router" and s[1] == "model" for n, s in seen)


# ----------------------------------------------------------------------
# (c) the tp engine against the JAX engine
# ----------------------------------------------------------------------

STREAMS = {"deepseek-moe-16b tp 2": ("deepseek-moe-16b", {}, 2),
           "deepseek-moe-16b (column slices) tp 4": ("deepseek-moe-16b", {"moe_dense_ff": 192}, 4),
           "kimi-k2-1t-a32b tp 2": ("kimi-k2-1t-a32b", {}, 2)}


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 500, size=n).astype(np.int32) for n in (9, 17, 70, 12)]


@pytest.mark.parametrize("case", list(STREAMS))
def test_tp_engine_streams_equal_jax_engine(case):
    arch, over, tp = STREAMS[case]
    jcfg = jreg.get_smoke(arch, sparse=True).replace(**over)
    cfg = registry.get_smoke(arch, sparse=True).replace(**over)
    ecfg = dict(max_slots=4, max_len=128)
    jeng = JEngine(jcfg, jax_make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg), seed=0)
    for p in _prompts():
        jeng.submit(p, 10)
    want = {f.uid: f.tokens.tolist() for f in jeng.drain(max_steps=100)}
    eng = Engine(cfg, engine_cfg=EngineConfig(**ecfg), mesh=make_tp_mesh(tp, ["cpu"] * tp),
                 params=params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu"))
    assert eng.tp == tp and len(eng.kv.buffers) == tp
    moe_shard = eng.model.shards[0].layers[1].moe
    assert moe_shard.router.shape[1] == cfg.moe_num_experts // tp
    if over:
        assert eng.model.shards[0].layers[0].mlp.wg.cols == (0, 64 // tp)
    for p in _prompts():
        eng.submit(p, 10)
    got = {f.uid: f.tokens.tolist() for f in eng.drain(max_steps=100)}
    assert got == want and len(got) == 4


# ----------------------------------------------------------------------
# (d) the mesh trainer against the JAX Trainer
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape,cols", [((1, 2), False), ((2, 2), False), ((1, 4), True)],
                         ids=["(1, 2)", "(2, 2)", "(1, 4) column slices"])
def test_mesh_step_equals_jax_trainer(shape, cols):
    """One step of smoke deepseek-moe-16b (2 layers: the dense one and an
    MoE one; 2 routing groups, one a data replica at (2, 2); with ``cols``
    a dense layer of 3 block rows, cut on its blocks' columns at tp 4)
    under tp from the JAX Trainer's bridged initial params."""
    over = dict(num_layers=2, moe_routing_groups=2, **({"moe_dense_ff": 192} if cols else {}))
    cfg = registry.get_smoke("deepseek-moe-16b", sparse=True).replace(**over)
    jcfg = jreg.get_smoke("deepseek-moe-16b", sparse=True).replace(**over)
    jo = jopt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params, jstate, jm = _jax_trainer_step(jcfg, jo, _family_data(jdata, cfg), "tp")
    mesh = make_local_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    m, ms, state = _one_step(cfg, params_from_jax(params, cfg, "cpu"), mesh, "tp")
    assert ms.tp == shape[1] and ms.model_dim["layers.1.moe.router"] == 1
    assert ms.model_dim["layers.1.moe.wg.blocks"] == 0 and ms.model_dim["layers.0.mlp.wg.blocks"] == (3 if cols else 0)
    for k in ("nll", "lb_loss"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * (1 + abs(float(jm[k]))), (k, m[k], jm[k])
    assert float(m["lb_loss"]) > 0
    batch = _family_data(jdata, cfg).batch(0)
    model, state = _unsharded(ms, state)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    _check_step(cfg, opt, opt.lr, _jax_grads(jcfg, cfg, params, batch), jstate, jm, model, state, m)


def test_linear_on_every_shard_is_a_pixelfly_linear():
    """The shards of the engine's model carry their slice in ``rows`` or
    ``cols``, never both, on every pixelfly linear."""
    cfg = _cols_cfg(registry)
    sharded = T.shard_model(cfg, make_tp_mesh(4, ["cpu"] * 4), T.init_model(cfg, device="cpu").state_dict())
    for shard in sharded.shards:
        for mod in shard.modules():
            if isinstance(mod, Linear) and mod.spec.sparse:
                assert (mod.rows is None) != (mod.cols is None)


@pytest.mark.parametrize("tp", [2, 4])
def test_column_sliced_o_and_down_are_refused(tp):
    """A model whose o and down projections have 3 block rows (d_model 192
    at block 64): the JAX rules cut their blocks on the output columns.
    They were refused until the port took that cut for o, down and the
    shared experts' down as it takes it for gate and up (each shard the
    whole input row, its strided output columns gathered back into
    feature order); now the layout is accepted, by the engine and the
    dry-run's check alike, and the tp engine's greedy streams equal the
    single-device engine's."""
    cfg = registry.get_smoke("deepseek-moe-16b", sparse=True).replace(d_model=192, num_layers=2)
    sd = T.init_model(cfg, seed=0, device="cpu").state_dict()
    st = sharding.Strategy(make_tp_mesh(tp, ["cpu"] * tp), "tp")
    specs = sharding.param_specs(st, sd)
    assert sharding.model_dim(st, specs["layers.0.attn.wo.blocks"]) == 3
    assert sharding.model_dim(st, specs["layers.1.moe.shared.wd.blocks"]) == 3
    assert T.check_tp_layout(cfg, st, sd) == specs
    ecfg = EngineConfig(max_slots=2, max_len=128)
    one = Engine(cfg, engine_cfg=ecfg, params=sd, device="cpu")
    eng = Engine(cfg, engine_cfg=ecfg, params=sd, mesh=make_tp_mesh(tp, ["cpu"] * tp))
    wo = eng.model.shards[1].layers[0].attn.wo
    assert wo.cols == (64 // tp, 2 * 64 // tp) and eng.model.shards[1].layers[1].moe.shared.wd.cols == wo.cols

    def serve_all(e):
        for p in _prompts()[:2]:
            e.submit(p, 6)
        return [f.tokens.tolist() for f in sorted(e.drain(max_steps=60), key=lambda f: f.uid)]

    assert serve_all(eng) == serve_all(one)


# ----------------------------------------------------------------------
# (e) the dry-run's sweep
# ----------------------------------------------------------------------


def test_sweep_splits_38_ok_and_28_refused():
    """The sweep's split: 62 cells count and 4 are refused (38 and 28
    before the sequence-parallel mode served the prefill and decode cells
    where tp does not divide the kv heads, 50 and 16 before it trained, 56
    and 10 before the SSM mixer sharded by heads): kimi-k2's six cells
    count, its two train cells at tp 16 among them, and so do zamba2-2.7b's
    train, prefill and decode cells; what is refused is the sequence-cut
    decode cache of smollm-360m's and zamba2-2.7b's long_500k (item 16)."""
    sweep = dryrun.sweep_split()
    ok = [k for k, v in sweep.items() if v is None]
    refused = {k: v for k, v in sweep.items() if v is not None}
    assert (len(sweep), len(ok), len(refused)) == (66, 62, 4)
    assert sum(k.startswith("deepseek-moe-16b ") for k in ok) == 6
    assert sum(k.startswith("kimi-k2-1t-a32b ") for k in ok) == 6
    assert {k for k in ok if k.startswith("kimi-k2-1t-a32b train_4k")} == {
        "kimi-k2-1t-a32b train_4k 16x16", "kimi-k2-1t-a32b train_4k 2x16x16"}
    assert {k for k in ok if k.startswith("zamba2-2.7b ")} == {
        f"zamba2-2.7b {s} {m}" for s in ("train_4k", "prefill_32k", "decode_32k") for m in ("16x16", "2x16x16")}
    assert all("item 16" in v and "cut along the sequence" in v for v in refused.values())
    assert set(refused) == {f"{a} long_500k {m}" for a in ("smollm-360m", "zamba2-2.7b") for m in ("16x16", "2x16x16")}


def test_serve_cli_tp_serves_the_moe_family(capsys):
    """``serve --tp 2 --strategy tp`` on smoke deepseek-moe-16b prints the
    grid of one device."""
    from repro_torch.launch import serve

    args = ["--arch", "deepseek-moe-16b", "--sparse", "--smoke", "--device", "cpu", "--batch", "3", "--slots", "2",
            "--prompt-len", "16", "--gen", "6"]
    tp = serve.main(args + ["--tp", "2", "--strategy", "tp"])
    assert "tp 2 on 1 distinct device(s)" in capsys.readouterr().out and tp.engine.tp == 2
    one = serve.main(args)
    assert [t.tolist() for t in tp.tokens] == [t.tolist() for t in one.tokens]
