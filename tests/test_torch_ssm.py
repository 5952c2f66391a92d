"""The port's Mamba2 block (``repro_torch.models.ssm``) and the SSM family
(mamba2-130m) against the JAX package's ``repro.models.ssm`` and
``transformer`` on the CPU: the same JAX-initialised weights, the same
numpy-seeded inputs.

Tolerances: the chunked SSD and the block's outputs and states 1e-4 (fp32
exp/cumsum chains summed in another order); ``segsum`` 1e-6; the smoke
model's loss 1e-5 and its gradients 1e-4 of each leaf's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.training import data


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several workers
    on a few cores; results only move in the last bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _ssd_inputs(b=2, s=45, h=3, p=4, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s, h, p)).astype(np.float32),
        (rng.random((b, s, h)) * 0.5 + 0.01).astype(np.float32),
        (-rng.random(h) - 0.1).astype(np.float32),
        rng.standard_normal((b, s, n)).astype(np.float32),
        rng.standard_normal((b, s, n)).astype(np.float32),
    )


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 16)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = ssm.segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", [8, 32, 45])
def test_ssd_chunked_matches_reference(chunk):
    """S = 45: a chunk of 8 or 32 leaves a ragged last chunk (dt = 0
    padding); a chunk of S is one chunk. Output and final state."""
    args = _ssd_inputs()
    y, final = jssm._ssd_chunked(*map(jnp.asarray, args), chunk)
    got_y, got_final = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert got_y.shape == (2, 45, 3, 4) and got_final.shape == (2, 3, 4, 8)
    _close(got_y, y, 1e-4)
    _close(got_final, final, 1e-4)


def test_ssd_chunked_gradients_are_finite_and_match():
    """The mask before the exp keeps the backward free of inf * 0: every
    gradient of the chunked SSD is finite and within 1e-4 of jax.grad's
    relative to its largest entry."""
    args = _ssd_inputs(s=40, seed=1)
    w = np.random.default_rng(2).standard_normal((2, 40, 3, 4)).astype(np.float32)

    def jloss(x, dt, A, B, C):
        y, st = jssm._ssd_chunked(x, dt, A, B, C, 16)
        return jnp.sum(y * w) + jnp.sum(st)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = ssm.ssd_chunked(*ts, 16)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum() + st.sum(), ts)
    for g, wg in zip(got, want):
        assert torch.isfinite(g).all()
        assert np.abs(g.numpy() - np.asarray(wg)).max() <= 1e-4 * np.abs(np.asarray(wg)).max()


def _fields(**kw):
    base = dict(
        name="t", family="ssm", num_layers=1, d_model=64, num_heads=0,
        num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=64,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8, dtype="float32",
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
    jcfg, cfg = JModelConfig(**_fields(**kw)), ModelConfig(**_fields(**kw))
    spec = jssm.SsmSpec(jcfg)
    params = jssm.init_ssm(jax.random.PRNGKey(seed), spec)
    with torch.device("meta"):
        module = ssm.Ssm(cfg, gen=torch.Generator(), device=torch.device("meta"))
    module.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in _leaves(params)}, strict=True, assign=True)
    return spec, params, module


# sparse: out_proj (128 -> 64) pixelfly at block 32; in_proj (64 -> 291) dense
SPARSE = dict(sparse=True, sparse_density=0.5, sparse_block=32)


@pytest.mark.parametrize("sparse", [False, True])
def test_apply_ssm_train_with_state_matches_reference(sparse):
    spec, params, module = _pair(**(SPARSE if sparse else {}))
    assert module.out_proj.spec.sparse == sparse and not module.in_proj.spec.sparse
    x = (np.random.default_rng(0).standard_normal((2, 21, 64)) * 0.3).astype(np.float32)
    y, cache = jssm.apply_ssm_train(spec, params, jnp.asarray(x), return_state=True)
    got, got_cache = ssm.apply_ssm_train(module, torch.from_numpy(x), return_state=True)
    _close(got, y, 1e-4)
    _close(got_cache["conv"], cache["conv"], 1e-6)
    _close(got_cache["state"], cache["state"], 1e-4)


@pytest.mark.parametrize("sparse", [False, True])
def test_prefill_then_decode_continues_reference_stream(sparse):
    """The state of a 16-token forward, then 6 one-token decode steps in
    each package: every step's output and the final cache within 1e-4."""
    spec, params, module = _pair(seed=1, **(SPARSE if sparse else {}))
    x = (np.random.default_rng(1).standard_normal((2, 22, 64)) * 0.3).astype(np.float32)
    _, jc = jssm.apply_ssm_train(spec, params, jnp.asarray(x[:, :16]), return_state=True)
    with torch.no_grad():
        _, tc = ssm.apply_ssm_train(module, torch.from_numpy(x[:, :16]), return_state=True)
        for t in range(16, 22):
            jy, jc = jssm.apply_ssm_decode(spec, params, jnp.asarray(x[:, t : t + 1]), jc)
            ty, tc = ssm.apply_ssm_decode(module, torch.from_numpy(x[:, t : t + 1]), tc)
            _close(ty, jy, 1e-4)
    _close(tc["conv"], jc["conv"], 1e-5)
    _close(tc["state"], jc["state"], 1e-4)


def test_init_ssm_cache_matches_reference():
    cfg = registry.get_smoke("mamba2-130m")
    jc = jssm.init_ssm_cache(jssm.SsmSpec(jreg.get_smoke("mamba2-130m")), 3, jnp.float32)
    tc = ssm.init_ssm_cache(cfg, 3, device=torch.device("cpu"))
    for name in ("conv", "state"):
        assert tuple(tc[name].shape) == jc[name].shape and not tc[name].any()
    assert tc["state"].dtype == torch.float32


@pytest.mark.parametrize("sparse", [False, True])
def test_mamba2_forward_train_loss_and_grads_match(sparse):
    """mamba2-130m at smoke width (tied embeddings, no attention): loss,
    nll and every parameter's gradient against ``jax.value_and_grad(
    T.forward_train)``, B = 2, S = 80 (chunks of 32, the last ragged)."""
    jcfg = jreg.get_smoke("mamba2-130m", sparse=sparse)
    cfg = registry.get_smoke("mamba2-130m", sparse=sparse)
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0), jcfg))
    model = T.init_model(cfg, device="cpu", params=params_from_jax(tree, cfg, "cpu"))
    batch = data.SyntheticLM(cfg.vocab_size, 80, 2, seed=3).batch(0)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.forward_train(jcfg, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    ))(jax.tree.map(jnp.asarray, tree))
    loss, m = T.forward_train(cfg, model, batch)
    _close(loss, jloss, 1e-5)
    _close(m["lb_loss"], 0.0, 0.0)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    want = params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")
    assert set(names) == set(want) and "head.w" not in want
    for n, g in zip(names, grads):
        err = (g - want[n]).abs().max() / want[n].abs().max().clamp(min=1e-30)
        assert err <= 1e-4, (n, float(err))
