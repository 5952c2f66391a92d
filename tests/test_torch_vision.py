"""The port's ViT and MLP-Mixer (``repro_torch.models.vision``) against the
JAX package's on the CPU: the same JAX-initialised weights, bridged with
``bridge.vision_params_from_jax``, and the same numpy inputs.

The config is ``tests/test_vision.py``'s ``_cfg`` (2 layers, d_model 128,
block 32), dense and sparse, plus a sparse case at block 16, with weights
drawn by numpy into the JAX tree's structure. Tolerances: logits rtol = atol = 1e-4 (fp32, the same
products summed in another order), the loss 1e-5, every parameter's
gradient 1e-4 of its largest entry (a Mixer's scalar ``gamma`` gradient
is a sum over every output that cancels to ~2e-4, and differs by 2e-5 of
itself with the summation order; every other leaf agrees within 5e-6), the
parameters after one SGD step (lr 1e-3, ``benchmarks/vision_speedup.py``'s
step) 1e-6; parameter counts and names exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import vision as JV
from repro_torch.bench.vision_speedup import sgd_step
from repro_torch.bridge import vision_params_from_jax
from repro_torch.core.pixelfly import Linear
from repro_torch.models import vision as V

CASES = [
    pytest.param(("vit", False, 32), id="vit-dense"),
    pytest.param(("vit", True, 32), id="vit-sparse-b32"),
    pytest.param(("mixer", False, 32), id="mixer-dense"),
    pytest.param(("mixer", True, 32), id="mixer-sparse-b32"),
    pytest.param(("vit", True, 16), id="vit-sparse-b16"),
]
JFNS = {"vit": (JV.init_vit, JV.apply_vit), "mixer": (JV.init_mixer, JV.apply_mixer)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several workers
    on a few cores, where torch's default pool spins against the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(kind, sparse, block):
    return dict(kind=kind, num_layers=2, d_model=128, num_heads=4, d_ff=256,
                num_patches=64, num_classes=10, patch_dim=48, token_ff=64,
                sparse=sparse, sparse_density=0.4, sparse_block=block)


@functools.lru_cache(maxsize=None)
def _jax_tree(kind, sparse, block):
    """The JAX tree's structure (``jax.eval_shape`` of its init) filled
    with numpy draws: N(0, 0.05^2) everywhere (the ViT's head and cls
    included, so the step moves the backbone), norm scales 1 + N(0, 0.1^2),
    gamma 0.5 + N(0, 0.1^2)."""
    cfg = JV.VisionConfig(**_kw(kind, sparse, block))
    shapes = jax.eval_shape(lambda key: JFNS[kind][0](key, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(leaf.shape)
        base = 1.0 if "scale" in name else 0.5 if "gamma" in name else 0.0
        return (base + z * (0.1 if base else 0.05)).astype(np.float32)

    return cfg, jax.tree_util.tree_map_with_path(draw, shapes)


def _data():
    rng = np.random.default_rng(0)
    return rng.standard_normal((4, 64, 48)).astype(np.float32), rng.integers(0, 10, 4)


def _port(case):
    kind, sparse, block = case
    _, tree = _jax_tree(*case)
    return V.init_vision(V.VisionConfig(**_kw(kind, sparse, block)), device="cpu",
                         params=vision_params_from_jax(tree, "cpu"))


@functools.lru_cache(maxsize=None)
def _jax_step(case):
    """The JAX logits, loss, SGD-updated tree and gradients (both bridged)
    of one jitted value-and-grad on ``_data()``."""
    cfg, tree = _jax_tree(*case)
    x, y = (jnp.asarray(a) for a in _data())

    def loss_fn(p):
        lg = JFNS[case[0]][1](cfg, p, x)
        return -jnp.take_along_axis(jax.nn.log_softmax(lg), y[:, None], axis=1).mean(), lg

    params = jax.tree.map(jnp.asarray, tree)
    (loss, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    new = jax.tree.map(lambda p, gg: np.asarray(p - 1e-3 * gg), params, g)
    grads = vision_params_from_jax(jax.tree.map(np.asarray, g), "cpu")
    return np.asarray(logits), float(loss), vision_params_from_jax(new, "cpu"), grads


@pytest.mark.parametrize("case", CASES)
def test_logits_match_jax(case):
    want = _jax_step(case)[0]
    with torch.no_grad():
        got = _port(case)(torch.from_numpy(_data()[0]))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax(case):
    """Every parameter's gradient of the bench's loss against JAX's, each
    within 1e-4 of its largest entry, so a term dropped from any leaf's
    backward shows even where the step's update (lr 1e-3) would hide it."""
    want = _jax_step(case)[3]
    x, y = (torch.from_numpy(a) for a in _data())
    model = _port(case)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want)
    loss = torch.nn.functional.cross_entropy(model(x), y)
    for name, g in zip(names, torch.autograd.grad(loss, list(model.parameters()))):
        w = want[name]
        assert w.abs().max() > 0, name  # the leaf is reached by the backward
        assert (g - w).abs().max() <= 1e-4 * w.abs().max(), name


@pytest.mark.parametrize("case", CASES)
def test_sgd_step_matches_jax(case):
    """One step of the bench's SGD: the loss and every updated parameter."""
    _, loss, want, _ = _jax_step(case)
    x, y = _data()
    model = _port(case)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got_loss = sgd_step(model, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(got_loss) - loss) <= 1e-5 * abs(loss)
    moved = 0
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
        moved += not torch.equal(p, before[name])
    assert moved > len(want) // 2  # the step reached the backbone


@pytest.mark.parametrize("case", CASES)
def test_param_count_and_names_match_jax(case):
    _, tree = _jax_tree(*case)
    model = _port(case)
    assert V.param_count(model) == sum(leaf.size for leaf in jax.tree.leaves(tree))
    assert set(model.state_dict()) == set(vision_params_from_jax(tree, "cpu"))
    for name in ("layers.1.n2.scale", "final_norm.scale", "head.w", "patch.w"):
        assert name in model.state_dict()
    names = {"vit": ("pos", "cls", "layers.0.qkv", "layers.0.proj", "layers.0.mlp.w1"),
             "mixer": ("layers.0.token_mlp.w1", "layers.0.chan_mlp.w2")}[case[0]]
    for prefix in names:
        assert any(k.startswith(prefix) for k in model.state_dict()), prefix


def test_lin_rule_keeps_the_token_mlp_dense():
    """``lin`` is pixelfly only where both features divide the block: at
    196 patches the Mixer's token MLP is dense, its channel MLP sparse,
    and every sparse block is the config's (never halved)."""
    cfg = V.VisionConfig(kind="mixer", num_layers=1, d_model=768, num_heads=12, d_ff=3072,
                         num_patches=196, num_classes=10, patch_dim=768, token_ff=384,
                         sparse=True, sparse_density=0.15, sparse_block=32)
    jcfg = JV.VisionConfig(**{k: getattr(cfg, k) for k in _kw("mixer", True, 32)})
    for din, dout in [(196, 384), (384, 196), (768, 3072), (3072, 768), (768, 2304)]:
        a, b = cfg.lin(din, dout), jcfg.lin(din, dout)
        assert (a.sparse, a.block, a.max_stride, a.rank) == (b.sparse, b.block, b.max_stride, b.rank)
    assert not cfg.lin(196, 384).sparse and cfg.lin(768, 3072).block == 32


def test_vit_head_starts_at_zero():
    cfg = V.VisionConfig(**_kw("vit", True, 32))
    model = V.init_vision(cfg, device="cpu")
    assert not model.head.w.any()
    with torch.no_grad():
        assert not model(torch.from_numpy(_data()[0])).any()
    assert sum(isinstance(m, Linear) and m.spec.sparse for m in model.modules()) == 8
