"""The Mamba2 mixer and its state at tp > 1 (``ssm.apply_ssm_tp``) against
the JAX package on the CPU, on ``Mesh`` over ``["cpu"] * n`` in fp32 with
weights carried over by ``bridge.params_from_jax``. The JAX side runs on
one device: the mesh does not change what is computed.

(a) The tp mixer at tp 2 and 4, train and decode modes, against
``repro.models.ssm.apply_ssm_train`` and ``apply_ssm_decode`` (1e-5), and
the sum over the shards of each replicated per-head tensor's gradient
against ``jax.grad``'s; (b) prefill and 8 decode steps of smoke zamba2 and
mamba2 on tp (1, 2) and (2, 2) against JAX ``prefill`` and ``decode_step``
(1e-4, as the single-device family tests), and of smoke zamba2 with 2
heads of 96, whose shared block's q, k and v tp 2 cuts on their blocks'
output columns (``layers.tp_heads_qkv``); (c) the ``Server`` on a tp 2
mesh against the JAX ``Server`` on ``make_tp_mesh(1)`` (streams equal),
its argmax held to the vocabulary where ``padded_vocab`` exceeds it, and
the serve CLI at ``--tp 2`` equal to tp 1; (d) one mesh-``Trainer`` step
at tp (1, 2) and (2, 2) against the JAX ``Trainer`` (``_check_step``'s
tolerances); (e) the planted faults of ``chip_smoke.py`` phase 20 fail
these checks; (f) ROADMAP item 24's refusal, and the hybrid's dry-run
count by cycles equal to the count of every layer."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ModelConfig as JModelConfig
from repro.launch import serve as jserve
from repro.launch.mesh import make_tp_mesh as jax_make_tp_mesh
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun as D
from repro_torch.launch import serve
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_tp_mesh
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.training.loop import MeshState
from repro_torch.training.optimizer import OptConfig
from test_torch_mesh_training import _family_data, _jax_trainer_step, _one_step
from test_torch_training import _check_step, _jax_grads_by_name, _unsharded

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# (a) the tp mixer
# ----------------------------------------------------------------------

# 8 heads of 16 (d_inner 128), state 16; sparse: out_proj (128 -> 64) pixelfly
# at block 32, 2 block rows: row-cut at tp 2, column-cut at tp 4
FIELDS = dict(name="t", family="ssm", num_layers=1, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
              vocab_size=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=8, dtype="float32",
              sparse=True, sparse_density=0.5, sparse_block=32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield ".".join(path), np.asarray(tree)


def _x(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


@functools.cache
def _reference():
    """The JAX mixer (seed 0) on x = ``_x((2, 21, 64), 0)``: its spec and
    params, x, w = ``_x((2, 21, 64), 1)``, its train-mode output y, the
    gradient of sum(y * w), and after a 16-token prefill the outputs of 5
    decode steps and the final cache (cached: the tp mixer's tests and the
    planted faults share it)."""
    spec = jssm.SsmSpec(JModelConfig(**FIELDS))
    params = jax.jit(lambda k: jssm.init_ssm(k, spec))(jax.random.PRNGKey(0))
    x, w = _x((2, 21, 64), 0), _x((2, 21, 64), 1)

    def loss(p):
        y = jssm.apply_ssm_train(spec, p, jnp.asarray(x))[0]
        return jnp.sum(y * w), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    _, cache = jax.jit(lambda p, x: jssm.apply_ssm_train(spec, p, x, return_state=True))(params, jnp.asarray(x[:, :16]))
    decode = jax.jit(lambda p, x, c: jssm.apply_ssm_decode(spec, p, x, c))
    steps = []
    for t in range(16, 21):
        yt, cache = decode(params, jnp.asarray(x[:, t : t + 1]), cache)
        steps.append(np.asarray(yt))
    return (spec, params, x, w, np.asarray(y), jax.tree.map(np.asarray, grads), steps,
            jax.tree.map(np.asarray, cache))


def _mixer(tp):
    """The port's ``tp`` shards of ``_reference``'s weights, cut by the JAX
    rules on a (1, tp) mesh."""
    cfg, params = ModelConfig(**FIELDS), _reference()[1]
    sd = {f"layers.0.ssm.{k}": torch.from_numpy(v.copy()) for k, v in _leaves(params)}
    mesh = make_tp_mesh(tp, ["cpu"] * tp)
    shards = []
    for r, part in enumerate(sharding.shard_state_dict(sharding.Strategy(mesh, "tp"), mesh, sd)):
        with torch.device("meta"):
            m = ssm.Ssm(cfg, gen=torch.Generator(), device=torch.device("meta"))
        T.assign(m, {k.removeprefix("layers.0.ssm."): v for k, v in part.items()}, trainable=True)
        T.mark_linear_slices(m, r)
        shards.append(m)
    return shards


def _mesh(shape):
    return make_local_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_mixer_train_and_decode_equal_reference(tp):
    """Train mode: each shard's output against ``apply_ssm_train``; each
    shard's gradient of ``A_log``, ``D``, ``dt_bias`` and ``norm`` is
    nonzero on its slice alone, and their sum is ``jax.grad``'s. Then a
    16-token prefill and 6 decode steps, each step's output and the final
    conv window and state (each shard's channels and heads) against the
    reference's."""
    spec, _, x, w, y, want, steps, jc = _reference()
    shards = _mixer(tp)
    assert (shards[0].out_proj.rows is None) == (tp == 4)
    ys, caches = ssm.apply_ssm_tp(shards, [torch.from_numpy(x)] * tp, mode="train")
    assert caches is None and all(t is ys[0] for t in ys[1:])
    _close(ys[0], y, TOL)
    names = ("A_log", "D", "dt_bias", "norm")
    got = torch.autograd.grad((ys[0] * torch.from_numpy(w)).sum(), [getattr(m, n) for m in shards for n in names])
    for i, name in enumerate(names):
        per = [got[r * len(names) + i] for r in range(tp)]
        n = per[0].shape[0] // tp
        for r, g in enumerate(per):
            assert not g[: r * n].any() and not g[(r + 1) * n :].any(), (name, r)
        _close(sum(per), want[name], 1e-4 * float(np.abs(want[name]).max()))

    with torch.no_grad():
        _, tc = ssm.apply_ssm_tp(shards, [torch.from_numpy(x[:, :16])] * tp, mode="prefill")
        for t, jy in zip(range(16, 21), steps):
            ty, tc = ssm.apply_ssm_tp(shards, [torch.from_numpy(x[:, t : t + 1])] * tp, mode="decode", caches=tc)
            _close(ty[0], jy, TOL)
    di, hl = spec.d_inner, spec.heads // tp
    for r, c in enumerate(tc):
        want_conv = np.concatenate([jc["conv"][..., r * di // tp : (r + 1) * di // tp], jc["conv"][..., di:]], axis=-1)
        _close(c["conv"], want_conv, TOL)
        _close(c["state"], jc["state"][:, r * hl : (r + 1) * hl], TOL)
    with pytest.raises(ValueError, match="unknown SSM mode"):
        ssm.apply_ssm_tp(shards, [torch.from_numpy(x)] * tp, mode="decode_paged")


# ----------------------------------------------------------------------
# (b) prefill and decode on a mesh
# ----------------------------------------------------------------------

ARCHS = ("zamba2-2.7b", "mamba2-130m")
# smoke zamba2 with 2 heads (and kv heads) of 96: q, k and v, 192 features
# in 3 blocks of 64, are cut on their blocks' output columns at tp 2, and
# the shared block's heads mode takes its heads' features of the whole
# projections (``layers.tp_heads_qkv``)
COLS = "zamba2-2.7b-qkv-cols"
OVER = {COLS: ("zamba2-2.7b", dict(num_heads=2, num_kv_heads=2, head_dim=96))}
_JAX: dict = {}
MAX_LEN = 40 + 8 + 1


def _cfgs(arch):
    """Smoke fp32 configs of 3 layers (zamba2: two SSM layers and the
    shared attention block)."""
    arch, over = OVER.get(arch, (arch, {}))
    return (jreg.get_smoke(arch, sparse=True).replace(num_layers=3, **over),
            registry.get_smoke(arch, sparse=True).replace(num_layers=3, **over))


def _jax_run(arch):
    """The JAX ``Server``'s params, ``prefill`` of 4 prompts of 40 tokens,
    and 8 greedy ``decode_step``s after it: the logits of each, the tokens
    fed. Cached: the meshes of one arch share it."""
    if arch not in _JAX:
        jcfg, cfg = _cfgs(arch)
        jsrv = jserve.Server(jcfg, jax_make_tp_mesh(1))
        params = jax.tree.map(np.asarray, jsrv.params)
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
        jp = jax.tree.map(jnp.asarray, params)
        logits, caches = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}))(jp, jnp.asarray(prompts))
        caches = [c if "state" in c else {k: jnp.pad(v, ((0, 0), (0, 0), (0, MAX_LEN - 40), (0, 0), (0, 0)))
                                          for k, v in c.items()} for c in caches]
        step = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, p, c, t, pos))
        out, toks = [np.asarray(logits)], []
        for j in range(8):
            toks.append(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
            logits, caches = step(jp, caches, jnp.asarray(toks[-1]), jnp.asarray(40 + j, jnp.int32))
            out.append(np.asarray(logits))
        _JAX[arch] = (jsrv, params, prompts, out, toks)
    return _JAX[arch]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["tp (1, 2)", "tp (2, 2)"])
@pytest.mark.parametrize("arch", ARCHS + (COLS,))
def test_mesh_prefill_and_decode_equal_reference(arch, shape):
    """``transformer.prefill`` and 8 ``decode_step``s on a ``MeshState``
    under tp: the logits of each within 1e-4 of JAX's, fed JAX's greedy
    tokens; one cache a replica and a model shard, with its heads' state
    (and, for zamba2, its kv heads). ``COLS``: the shared block's q, k and
    v cut on their blocks' output columns."""
    _, cfg = _cfgs(arch)
    _, params, prompts, want, toks = _jax_run(arch)
    state = MeshState(cfg, _mesh(shape), "tp", params_from_jax(params, cfg, "cpu"))
    for n in ("wq", "wk", "wv"):
        if cfg.family == "hybrid":
            assert (state.model_dim[f"shared_attn.attn.{n}.blocks"] == 3) == (arch == COLS)
    logits, caches = T.prefill(cfg, state, {"tokens": prompts}, max_len=MAX_LEN)
    assert len(caches) == shape[0] and all(len(c) == 2 for c in caches)
    ssm_cache = caches[0][1][0]
    assert tuple(ssm_cache["state"].shape[-3:-2]) == (cfg.ssm_heads // 2,)
    _close(logits, want[0], 1e-4)
    for j, tok in enumerate(toks):
        logits, caches = T.decode_step(cfg, state, caches, torch.from_numpy(tok), 40 + j)
        _close(logits, want[j + 1], 1e-4)


# ----------------------------------------------------------------------
# (c) the Server on a mesh
# ----------------------------------------------------------------------


@pytest.mark.parametrize("strategy,shape", [("tp", (1, 2)), ("fsdp", (2, 1))], ids=["tp (1, 2)", "fsdp (2, 1)"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_server_streams_equal_jax_server(arch, strategy, shape):
    """``Server(mesh=..., strategy=...)`` on the JAX ``Server``'s weights
    serves its greedy streams (the JAX ``Server`` prefills through the
    decode step; the port's in one pass): at tp 2, and under fsdp on two
    data positions, each running its rows."""
    _, cfg = _cfgs(arch)
    jsrv, params, prompts, _, _ = _jax_run(arch)
    srv = serve.Server(cfg, mesh=_mesh(shape), strategy=strategy, params=params_from_jax(params, cfg, "cpu"))
    assert srv.model.tp == shape[1] and len(srv.model.replicas(4)) == shape[0]
    np.testing.assert_array_equal(srv.generate(prompts, 10), jsrv.generate(prompts, 10))
    with pytest.raises(ValueError, match="pass device=None"):
        serve.Server(cfg, mesh=make_tp_mesh(2, ["cpu"] * 2), device="cpu")


def test_server_argmax_stays_in_the_vocabulary():
    """A config whose ``padded_vocab`` (512) exceeds ``vocab_size`` (510),
    with the two padded rows of the tied token table set to +-1000: the
    logits there dwarf every real one, and every id the ``Server`` emits,
    on one device and on a tp 2 mesh (vocab-sharded logits), is under
    ``vocab_size``."""
    cfg = registry.get_smoke("mamba2-130m", sparse=True).replace(num_layers=2, vocab_size=510)
    assert cfg.padded_vocab == 512 and cfg.tie_embeddings
    sd = T.init_model(cfg, seed=0, device="cpu").state_dict()
    sd["embed.tok"][510], sd["embed.tok"][511] = 1000.0, -1000.0
    prompts = np.random.default_rng(1).integers(0, 510, (3, 20)).astype(np.int32)
    logits, _ = T.prefill(cfg, T.init_model(cfg, device="cpu", params=sd), {"tokens": prompts})
    assert (logits.argmax(-1) >= 510).all()
    for kw in ({"device": "cpu"}, {"mesh": make_tp_mesh(2, ["cpu"] * 2), "strategy": "tp"}):
        toks = serve.Server(cfg, params=sd, **kw).generate(prompts, 6)
        assert toks.shape == (3, 6) and (toks >= 0).all() and (toks < cfg.vocab_size).all(), kw


CLI = ["--smoke", "--device", "cpu", "--batch", "3", "--prompt-len", "12", "--gen", "5"]


@pytest.mark.parametrize("arch,extra", [("zamba2-2.7b", []), ("qwen3-1.7b", ["--sparse", "--legacy-server"])])
def test_serve_cli_tp2_serves_the_tokens_of_tp1(arch, extra, capsys):
    """``serve --strategy tp --tp 2`` on smoke zamba2 (the Server, its SSM
    state by heads) and ``--legacy-server --tp 2`` on smoke qwen3-1.7b
    print tp 1's grid; ``--tp 2`` alone still exits, as the JAX CLI."""
    one = serve.main(["--arch", arch] + CLI + extra)
    two = serve.main(["--arch", arch] + CLI + extra + ["--strategy", "tp", "--tp", "2"])
    assert "tp 2" in capsys.readouterr().out and two.engine is None
    assert [t.tolist() for t in two.tokens] == [t.tolist() for t in one.tokens]
    with pytest.raises(SystemExit, match="pass --strategy tp"):
        serve.main(["--arch", arch] + CLI + extra + ["--tp", "2"])


# ----------------------------------------------------------------------
# (d) one mesh-Trainer step
# ----------------------------------------------------------------------

_JAX_STEPS: dict = {}
OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def _jax_step(arch):
    """The JAX ``Trainer``'s initial params, its state and metrics after one
    step on ``make_tp_mesh(1)`` under tp, and that step's gradient, read
    off its Adam first moment (cached: the meshes of one arch share it)."""
    if arch not in _JAX_STEPS:
        jcfg, cfg = _cfgs(arch)
        jo = jopt.OptConfig(lr=OPT.lr, warmup_steps=OPT.warmup_steps, total_steps=OPT.total_steps)
        params, jstate, jm = _jax_trainer_step(jcfg, jo, _family_data(jdata, cfg), "tp")
        # the step's gradient from its first moment: mu = (1 - b1) * g * clip scale
        scale = min(1.0, jo.clip_norm / (float(jm["grad_norm"]) + 1e-9))
        grads = jax.tree.map(lambda m: m / ((1 - jo.b1) * scale), jstate["opt"]["mu"])
        _JAX_STEPS[arch] = (params, jstate, jm, _jax_grads_by_name(grads, cfg))
    return _JAX_STEPS[arch]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["tp (1, 2)", "tp (2, 2)"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_trainer_step_equals_jax_trainer(arch, shape):
    """One step at tp (1, 2) and (2, 2) from the JAX ``Trainer``'s initial
    params: loss, grad_norm, lr, mu, nu and the parameters after it within
    ``_check_step``'s tolerances of the JAX ``Trainer``'s step on
    ``make_tp_mesh(1)``."""
    _, cfg = _cfgs(arch)
    params, jstate, jm, jgrads = _jax_step(arch)
    m, ms, state = _one_step(cfg, params_from_jax(params, cfg, "cpu"), _mesh(shape), "tp")
    assert ms.tp == 2
    model, state = _unsharded(ms, state)
    _check_step(cfg, OPT, OPT.lr, jgrads, jstate, jm, model, state, m)


# ----------------------------------------------------------------------
# (e) the planted faults
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mean square on the shard", "head slices shifted"])
def test_planted_mixer_faults_miss_the_reference(kind):
    """``chip_smoke.py`` phase 20's two mixer faults (``planted_ssm_fault``)
    move the tp 2 mixer's output off the reference by more than 100 times
    its tolerance; outside the block the output is back within it."""
    cs = _chip_smoke()
    _, _, x, _, y, _, _, _ = _reference()
    shards = _mixer(2)
    with torch.no_grad(), cs.planted_ssm_fault(kind):
        bad = ssm.apply_ssm_tp(shards, [torch.from_numpy(x)] * 2, mode="train")[0][0].numpy()
    assert np.abs(bad - y).max() > 100 * TOL
    with torch.no_grad():
        _close(ssm.apply_ssm_tp(shards, [torch.from_numpy(x)] * 2, mode="train")[0][0], y, TOL)


def test_planted_norm_gradient_fault_fails_the_step_check():
    """Phase 20's training fault (the SSM ``norm`` taking its gradient from
    shard 0 alone) fails ``_check_step`` at tp (1, 2)."""
    cs = _chip_smoke()
    _, cfg = _cfgs("mamba2-130m")
    params, jstate, jm, jgrads = _jax_step("mamba2-130m")
    with cs.planted_train_fault("replicated grad", leaf=cs.SSM_TRAIN_LEAF):
        m, ms, state = _one_step(cfg, params_from_jax(params, cfg, "cpu"), _mesh((1, 2)), "tp")
    model, state = _unsharded(ms, state)
    with pytest.raises(AssertionError):
        _check_step(cfg, OPT, OPT.lr, jgrads, jstate, jm, model, state, m)


# ----------------------------------------------------------------------
# (f) refusals, the paged engine, the dry-run
# ----------------------------------------------------------------------


def test_item_24_refusals():
    """A tp that does not divide the SSM heads (smoke zamba2's 16 at tp 3),
    and ``ssm_groups`` > 1, are refused naming item 24, by ``check_tp``, the
    ``MeshState`` (so the ``Trainer`` and the ``Server``) and the serve
    CLI; the paged ``Engine`` still refuses SSM state at tp 2, with its own
    words."""
    cfg = registry.get_smoke("zamba2-2.7b", sparse=True)
    assert cfg.ssm_heads == 16
    with pytest.raises(ValueError, match="16 heads and 1 group.*item 24"):
        sharding.check_tp(cfg, 3)
    with pytest.raises(ValueError, match="2 group.*item 24"):
        sharding.check_tp(cfg.replace(ssm_groups=2), 2)
    for tp in (2, 4, 8, 16):
        sharding.check_tp(cfg, tp)
    with pytest.raises(ValueError, match="item 24"):
        MeshState(cfg, Mesh(("data", "model"), (1, 3), ["meta"] * 3), "tp", T.skeleton(cfg).state_dict())
    with pytest.raises(ValueError, match="item 24"):
        serve.Server(cfg, mesh=make_tp_mesh(3, ["cpu"] * 3), strategy="tp")
    with pytest.raises(ValueError, match="item 24"):
        serve.main(["--arch", "zamba2-2.7b"] + CLI + ["--strategy", "tp", "--tp", "3"])
    with pytest.raises(ValueError, match="launch.serve.Server"):
        Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=64), mesh=make_tp_mesh(2, ["cpu"] * 2))
    assert "ssm" not in sharding.REFUSED and "item 24" in sharding.REFUSED["ssm_heads"]


def test_hybrid_count_by_cycles_equals_every_layer():
    """The dry-run counts the hybrid cut to two and three of its cycles
    and extends the counts (``count_by_layers``): smoke zamba2 with its
    shared block every second layer, extended to four cycles (8 layers)
    under tp on (2, 2), at S = 128, B = 4, equals the count of every
    layer, memory included."""
    cfg = registry.get_smoke("zamba2-2.7b", sparse=True).replace(num_layers=8, attn_every=2)
    mesh = Mesh(("data", "model"), (2, 2), ["meta"] * 4)
    assert D._repeated_cycle(cfg) == 0
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind[0], 128, 4, kind)
        full = D.count_cell(cfg, shape, mesh, strategy="tp")
        ext = D.count_by_layers(cfg, shape, mesh, strategy="tp")
        assert full["cost"] == ext["cost"], kind
        for key in ("temp_bytes", "argument_bytes", "output_bytes"):
            assert full[key] == ext[key], (kind, key)
