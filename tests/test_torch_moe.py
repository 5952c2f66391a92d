"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the CPU: the same JAX-initialised
weights, the same numpy-seeded inputs.

``apply_moe``'s output within fp32 rtol = atol = 1e-5 (the same products,
summed in another order) and its load-balance loss within 1e-6, with dense
and with pixelfly experts, shared experts on and off, one and several
routing groups; at a capacity factor low enough that tokens drop, the
routing (top-k indices, the sort order and the kept set) equal exactly to
the reference's; the gradients of every MoE parameter and of the input
within 1e-5 of each leaf's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several workers
    on a few cores; results only move in the last bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(**kw):
    base = dict(
        name="t", family="moe", num_layers=1, d_model=64, num_heads=0,
        num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=64,
        moe_num_experts=8, moe_top_k=2, moe_num_shared=0, moe_d_ff=32,
        moe_capacity_factor=8.0, dtype="float32",
    )
    base.update(kw)
    return base


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield ".".join(path), np.asarray(tree)


def _pair(seed=0, **kw):
    """The reference's spec and params (seed ``seed``) and the port's
    ``Moe`` holding the same weights."""
    jcfg, cfg = JModelConfig(**_fields(**kw)), ModelConfig(**_fields(**kw))
    spec = jmoe.MoeSpec(jcfg)
    params = jmoe.init_moe(jax.random.PRNGKey(seed), spec)
    with torch.device("meta"):
        module = moe.Moe(cfg, gen=torch.Generator(), device=torch.device("meta"))
    module.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in _leaves(params)}, strict=True, assign=True)
    return spec, params, module


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


CASES = {
    "dense": {},
    "dense-shared": dict(moe_num_shared=2),
    "dense-groups4": dict(moe_routing_groups=4),
    "sparse": dict(sparse=True, sparse_density=0.6, sparse_block=16, moe_d_ff=64),
    "sparse-shared-groups2": dict(sparse=True, sparse_density=0.6, sparse_block=16, moe_d_ff=64,
                                  moe_num_shared=2, moe_routing_groups=2),
    "top8": dict(moe_top_k=8, moe_capacity_factor=16.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference(case):
    spec, params, module = _pair(**CASES[case])
    x = _x((4, 16, 64))
    y, aux = jmoe.apply_moe(spec, params, jnp.asarray(x))
    got, lb = moe.apply_moe(module, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, y, 1e-5)
    _close(lb, aux["lb_loss"], 1e-6)
    assert ("shared" in dict(module.named_children())) == bool(CASES[case].get("moe_num_shared"))


def _reference_routing(spec, params, x):
    """The reference's routing lines of ``repro.models.moe.apply_moe``
    (top-k indices, the stable sort by expert, the kept set), in jnp."""
    c = spec.cfg
    b, s, d = x.shape
    e, k = spec.n_exp, c.moe_top_k
    tokens = b * s
    groups = max(1, min(c.moe_routing_groups, tokens))
    while tokens % groups:
        groups -= 1
    t = tokens // groups
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", x.reshape(groups, t, d), params["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = max(8, int(np.ceil(int(c.moe_capacity_factor * t * k / e) / 8) * 8))
    fe = idx.reshape(groups, t * k)
    order = jnp.argsort(fe, axis=-1, stable=True)
    se = jnp.take_along_axis(fe, order, axis=-1)
    starts = jax.vmap(lambda a: jnp.searchsorted(a, jnp.arange(e)))(se)
    pos = jnp.arange(t * k)[None, :] - jnp.take_along_axis(starts, se, axis=-1)
    return np.asarray(idx), np.asarray(order), np.asarray(pos < cap), cap


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("sparse", [False, True])
def test_capacity_drops_the_reference_tokens(groups, sparse):
    """Capacity factor 0.25 at 2 x 48 tokens: the capacity is the floor of
    8, so tokens past it drop; the top-k indices, the sort order and the
    kept set equal the reference's exactly, and the outputs (dropped
    choices contributing nothing) agree within 1e-5."""
    kw = dict(moe_capacity_factor=0.25, moe_routing_groups=groups)
    if sparse:
        kw.update(sparse=True, sparse_density=0.6, sparse_block=16, moe_d_ff=64)
    spec, params, module = _pair(seed=3, **kw)
    x = _x((2, 48, 64), seed=1)
    idx, order, keep, cap = _reference_routing(spec, params, jnp.asarray(x))
    r = moe.route(module.spec.cfg, module.router, torch.from_numpy(x))
    assert r.cap == cap == 8 and r.groups == groups
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.order.numpy(), order)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert 0 < (~keep).sum() < keep.size  # some choices dropped, not all
    y, _ = jmoe.apply_moe(spec, params, jnp.asarray(x))
    got, _ = moe.apply_moe(module, torch.from_numpy(x))
    _close(got, y, 1e-5)


def test_capacity_formula_matches_reference():
    """``max(8, ceil(int(factor * t * k / E) / 8) * 8)`` over factors and
    group sizes, against the reference's lines."""
    for factor in (0.25, 1.0, 1.25, 2.0):
        for t in (1, 8, 96, 1000, 8192):
            cfg = ModelConfig(**_fields(moe_capacity_factor=factor, moe_num_experts=64, moe_top_k=6))
            want = max(8, int(np.ceil(int(factor * t * 6 / 64) / 8) * 8))
            assert moe.capacity(cfg, t) == want


@pytest.mark.parametrize("case", ["dense-shared", "sparse-shared-groups2"])
def test_moe_gradients_match_reference(case):
    """d/d(params, x) of sum(y * w) + lb_loss against ``jax.grad``: every
    leaf within 1e-5 of its largest entry, dropped tokens included
    (capacity factor 0.5)."""
    spec, params, module = _pair(seed=5, moe_capacity_factor=0.5, **CASES[case])
    x = _x((2, 24, 64), seed=2)
    w = _x((2, 24, 64), seed=3)

    def jloss(p, xx):
        y, aux = jmoe.apply_moe(spec, p, xx)
        return jnp.sum(y * w) + aux["lb_loss"]

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, lb = moe.apply_moe(module, xt)
    loss = (y * torch.from_numpy(w)).sum() + lb
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in module.named_parameters()] + [xt])
    want = dict(_leaves(gp))
    assert set(names) == set(want)
    for n, g in zip(names + ["x"], grads):
        ref = np.asarray(gx) if n == "x" else want[n]
        err = np.abs(g.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 1e-5, (n, err)


def test_combine_is_deterministic_and_padding_counts():
    """Two calls give the same bits (no atomic scatter), and a row of
    padding tokens changes the other rows' outputs once capacity binds:
    padding goes through the router and counts against capacity, as in the
    reference."""
    spec, params, module = _pair(seed=7, moe_capacity_factor=1.0)
    x = _x((2, 32, 64), seed=4)
    a, _ = moe.apply_moe(module, torch.from_numpy(x))
    b, _ = moe.apply_moe(module, torch.from_numpy(x))
    assert torch.equal(a, b)
    padded = np.concatenate([x, np.repeat(x[:1, :1], 32, axis=1)], axis=0)  # a third row of one token
    got, _ = moe.apply_moe(module, torch.from_numpy(padded))
    y, _ = jmoe.apply_moe(spec, params, jnp.asarray(padded))
    _close(got, y, 1e-5)
    assert not np.allclose(got[:2].detach().numpy(), a.detach().numpy(), atol=1e-6)
