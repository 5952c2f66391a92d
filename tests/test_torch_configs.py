"""The dense-family configs the port copies (smollm-360m: GQA group 3 and
block 64; qwen2-1.5b: QKV bias; deepseek-67b: untied head, group 8 at full
width) against the JAX package, sparse and dense, on the CPU at smoke
width: the registry's configs field by field, the bridge's coverage, the
training loss and gradients, the paged prefill and decode logits, the
greedy engine's streams, and deepseek-67b's parameter count at full width
from a meta-device build; then the MoE, SSM and hybrid configs
(deepseek-moe-16b, kimi-k2-1t-a32b, mamba2-130m, zamba2-2.7b) field by
field and their parameter counts at full width, dense and sparse.

Every QKV bias is drawn at random (the reference initialises them to zero)
so the bias path is exercised. Tolerances are ``tests/test_torch_model.py``'s
and ``tests/test_torch_training.py``'s: logits 1e-4, loss 1e-5, gradients
2e-5 (fp32, the same products summed in another order); streams, configs
and counts exact."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.training import data

ARCHS = ["smollm-360m", "qwen2-1.5b", "deepseek-67b"]
SPARSE = [False, True]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several workers
    on a few cores, where torch's default pool (one thread a core) spins
    against the other workers; results only move in the last bits, inside
    every tolerance here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, sparse):
    """JAX-initialised smoke params (seed 0), every bias leaf ``b`` drawn
    from N(0, 0.1) with a numpy seed."""
    jcfg = jreg.get_smoke(arch, sparse=sparse)
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)

    def bias(path, leaf):
        if path[-1].key == "b":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jcfg, jax.tree_util.tree_map_with_path(bias, tree)


def _pair(arch, sparse):
    jcfg, tree = _jax_params(arch, sparse)
    cfg = registry.get_smoke(arch, sparse=sparse)
    model = T.init_model(cfg, device="cpu", params=params_from_jax(tree, cfg, "cpu"))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", SPARSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_registry_matches_reference(arch, sparse, smoke):
    get = "get_smoke" if smoke else "get"
    a = dataclasses.asdict(getattr(registry, get)(arch, sparse=sparse))
    b = dataclasses.asdict(getattr(jreg, get)(arch, sparse=sparse))
    assert a == b


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", SPARSE)
def test_bridge_covers_every_parameter(arch, sparse):
    jcfg, tree = _jax_params(arch, sparse)
    cfg = registry.get_smoke(arch, sparse=sparse)
    sd = params_from_jax(tree, cfg, "cpu")
    model = T.init_model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert all(sd[n].shape == t.shape and sd[n].dtype == t.dtype for n, t in model.state_dict().items())
    biases = sorted(n for n in sd if n.endswith(".b"))
    assert len(biases) == (3 * cfg.num_layers if cfg.qkv_bias else 0)
    if biases:
        leaf = tree["groups"]["dense_0"]["attn"]["wk"]["b"][2]
        np.testing.assert_array_equal(sd["layers.2.attn.wk.b"].numpy(), leaf)
    assert ("head.w" in sd) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", SPARSE)
def test_forward_train_loss_and_grads_match(arch, sparse):
    """Loss, nll and every parameter's gradient against
    ``jax.value_and_grad(T.forward_train)``; B = 2, S = 128 (sparse
    attention over two blocks of 64)."""
    jcfg, cfg, params, model = _pair(arch, sparse)
    batch = data.SyntheticLM(cfg.vocab_size, 128, 2, seed=3).batch(0)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.forward_train(jcfg, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    )(params)
    loss, m = T.forward_train(cfg, model, batch)
    _close(loss, jloss, 1e-5)
    _close(m["nll"], jm["nll"], 1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    want = params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        _close(g, want[n], 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", SPARSE)
def test_prefill_then_decode_match(arch, sparse):
    """``prefill_paged`` of two prompts (one ending mid-page) and one
    ``decode_step_paged`` past a page boundary with an idle slot: logits
    and the written K/V pages within 1e-4."""
    jcfg, cfg, params, model = _pair(arch, sparse)
    page, n_pages = cfg.attn_block, 17
    n, s = 2, 4 * page
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)
    plens = np.array([s - 5, 2 * page + 3], np.int32)
    rows = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)  # 0: trash tail
    with make_tp_mesh(1):
        jc = JT.init_paged_cache(jcfg, n_pages, page)
        jl, jc = JT.prefill_paged(jcfg, params, jnp.asarray(toks), jnp.asarray(plens), jc, jnp.asarray(rows))
    tc = T.init_paged_cache(cfg, n_pages, page, device="cpu")
    tl, tc = T.prefill_paged(cfg, model, torch.from_numpy(toks), torch.from_numpy(plens), tc,
                             torch.from_numpy(rows))
    _close(tl, jl, 1e-4)
    real = [1, 2, 3, 4, 5, 6, 7]  # the trash page's contents are unspecified
    for name in ("k", "v"):
        _close(tc[0][name][:, real], np.asarray(jc[0][name])[:, real], 1e-4)
    table = np.zeros((3, 8), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[1, :3] = [5, 6, 7]
    pos = np.array([plens[0], plens[1], 0], np.int32)
    tok = np.array([5, 7, 0], np.int32)
    with make_tp_mesh(1):
        jl2, jc = JT.decode_step_paged(jcfg, params, jc, jnp.asarray(tok), jnp.asarray(pos),
                                       jnp.asarray(table))
    tl2, tc = T.decode_step_paged(cfg, model, tc, torch.from_numpy(tok), torch.from_numpy(pos),
                                  torch.from_numpy(table))
    _close(tl2[:2], np.asarray(jl2)[:2], 1e-4)
    _close(tc[0]["v"][:, real], np.asarray(jc[0]["v"])[:, real], 1e-4)


def test_engine_streams_equal_reference_engine():
    """Greedy streams of sparse qwen2-1.5b (QKV bias) for 4 requests over
    2 slots, one long enough that the decode schedule skips pages: the
    port's ``Engine`` on the JAX engine's bridged weights gives the JAX
    ``Engine``'s tokens."""
    arch = "qwen2-1.5b"
    jcfg, tree = _jax_params(arch, True)
    cfg = registry.get_smoke(arch, sparse=True)
    page = cfg.attn_block
    rng = np.random.default_rng(5)
    work = [(rng.integers(0, cfg.vocab_size, p).astype(np.int32), g)
            for p, g in [(30, 6), (5 * page + 10, 5), (2 * page + 1, 4), (9, 7)]]
    ecfg = dict(max_slots=2, max_len=8 * page)
    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg),
                   params=jax.tree.map(jnp.asarray, tree))
    eng = Engine(cfg, engine_cfg=EngineConfig(**ecfg), params=params_from_jax(tree, cfg, "cpu"), device="cpu")

    def serve(e):
        uids = {e.submit(p, g): i for i, (p, g) in enumerate(work)}
        return {uids[f.uid]: f.tokens.tolist() for f in e.drain(max_steps=200)}

    want = serve(jeng)
    assert serve(eng) == want and len(want) == len(work)


@pytest.mark.parametrize("sparse", SPARSE)
def test_full_width_meta_build_parameter_count(sparse):
    """deepseek-67b at its published widths, built on the meta device
    (no memory): its parameter count equals that of the JAX package's
    init, from ``jax.eval_shape``."""
    jcfg = jreg.get("deepseek-67b", sparse=sparse)
    cfg = registry.get("deepseek-67b", sparse=sparse)
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jcfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = T.LM(cfg, gen=torch.Generator(), device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == want
    assert want > 6e10 if not sparse else want < 3e10


# the MoE, SSM and hybrid families, and their parameter counts (billions,
# dense and at density 0.2) from the JAX package's eval_shape
FAMILY_COUNTS = {
    "deepseek-moe-16b": (16.376, 2.852),
    "kimi-k2-1t-a32b": (1028.3, 171.9),
    "mamba2-130m": (0.129, 0.105),
    "zamba2-2.7b": (2.064, 1.499),
}


@pytest.mark.parametrize("arch", list(FAMILY_COUNTS))
@pytest.mark.parametrize("sparse", SPARSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_family_registry_matches_reference(arch, sparse, smoke):
    """The four configs equal the JAX package's field by field (published
    and smoke, dense and sparse; SSM attention stays dense when sparse)."""
    get = "get_smoke" if smoke else "get"
    a = dataclasses.asdict(getattr(registry, get)(arch, sparse=sparse))
    b = dataclasses.asdict(getattr(jreg, get)(arch, sparse=sparse))
    assert a == b
    assert a["sparse_attention"] == (sparse and a["family"] != "ssm")


@pytest.mark.parametrize("arch", list(FAMILY_COUNTS))
@pytest.mark.parametrize("sparse", SPARSE)
def test_family_full_width_parameter_count(arch, sparse):
    """Each family at its published widths, built on the meta device (no
    memory): its parameter count equals that of the JAX package's init,
    from ``jax.eval_shape``, and the billions stated beside it."""
    jcfg = jreg.get(arch, sparse=sparse)
    cfg = registry.get(arch, sparse=sparse)
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jcfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = T.LM(cfg, gen=torch.Generator(), device=torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == want
    assert round(want / 1e9, 3 if want < 1e11 else 1) == FAMILY_COUNTS[arch][int(sparse)]
