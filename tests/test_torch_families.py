"""The MoE, SSM and hybrid families the port copies (deepseek-moe-16b:
a leading dense layer at ``moe_dense_ff``, 2 shared experts; kimi-k2-1t-a32b:
GQA, 1 shared expert; mamba2-130m: SSM only, tied embeddings; zamba2-2.7b:
Mamba2 layers and one shared attention block) against the JAX package on
the CPU at smoke width, on JAX-initialised weights through
``bridge.params_from_jax``: the bridge's coverage, zamba2's one shared
parameter set, and ``forward_train``'s loss, load-balance loss and
gradients. ``tests/test_torch_families_run.py`` holds their prefill,
serving streams and the optimizer step.

Tolerances are ``tests/test_torch_configs.py``'s: loss 1e-5; gradients
1e-4 of each leaf's largest entry (the MoE dispatch and the SSD scan sum
in another order); the load-balance loss 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.training import data

ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b", "mamba2-130m", "zamba2-2.7b"]


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


@functools.lru_cache(maxsize=None)
def _jax_params(arch, sparse):
    jcfg = jreg.get_smoke(arch, sparse=sparse)
    return jcfg, jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0), jcfg))


def _pair(arch, sparse):
    jcfg, tree = _jax_params(arch, sparse)
    cfg = registry.get_smoke(arch, sparse=sparse)
    model = T.init_model(cfg, device="cpu", params=params_from_jax(tree, cfg, "cpu"))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", [False, True])
def test_bridge_covers_every_parameter(arch, sparse):
    """Every leaf maps onto a parameter of the port's model of the same
    shape and dtype, and back: count-1 groups (deepseek-moe's
    ``dense_0``), the experts' stacked leaves, the router, the SSM leaves
    and zamba2's unstacked ``shared_attn``."""
    jcfg, tree = _jax_params(arch, sparse)
    cfg = registry.get_smoke(arch, sparse=sparse)
    sd = params_from_jax(tree, cfg, "cpu")
    model = T.init_model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert all(sd[n].shape == t.shape and sd[n].dtype == t.dtype for n, t in model.state_dict().items())
    groups = tree["groups"]
    if cfg.family == "moe":
        np.testing.assert_array_equal(sd["layers.0.mlp.wd.blocks" if sparse else "layers.0.mlp.wd.w"].numpy(),
                                      groups["dense_0"]["mlp"]["wd"]["blocks" if sparse else "w"][0])
        np.testing.assert_array_equal(sd["layers.2.moe.router"].numpy(), groups["moe_0"]["moe"]["router"][1])
        wg = groups["moe_0"]["moe"]["wg"]
        np.testing.assert_array_equal(sd["layers.1.moe.wg.U" if sparse else "layers.1.moe.wg"].numpy(),
                                      (wg["U"] if sparse else wg)[0])
    if cfg.family == "hybrid":
        np.testing.assert_array_equal(sd["shared_attn.mlp_norm.scale"].numpy(), groups["shared_attn"]["mlp_norm"]["scale"])
        np.testing.assert_array_equal(sd["layers.3.ssm.A_log"].numpy(), groups["ssm_1"]["ssm"]["A_log"][1])
    if cfg.family in ("ssm", "hybrid"):
        assert not model.layers[0].ssm.in_proj.spec.sparse
        assert model.layers[0].ssm.out_proj.spec.sparse == sparse


def test_zamba_shares_attention_params():
    """The twin of ``tests/test_models_smoke.py``'s: zamba2's attention
    block is one parameter set, at every one of its positions, and its
    gradient sums the uses."""
    cfg = registry.get_smoke("zamba2-2.7b")
    keys = [g.param_key for g in cfg.layer_groups() if g.kind == "shared_attn"]
    assert len(keys) >= 2 and len(set(keys)) == 1
    model = T.init_model(cfg, device="cpu")
    shared = [blk for kind, blk in model.blocks() if kind == "shared_attn"]
    assert len(shared) == len(keys) and all(blk is model.shared_attn for blk in shared)
    names = [n for n, _ in model.named_parameters()]
    assert sum(n.startswith("shared_attn.") for n in names) == len(list(model.shared_attn.parameters()))
    assert not any(n.startswith("layers.") and ".attn." in n for n in names)
    assert len(model.layers) == sum(g.count for g in cfg.layer_groups() if not g.shared)


def test_ssm_configs_refuse_paged_caches():
    for arch in ("mamba2-130m", "zamba2-2.7b"):
        with pytest.raises(NotImplementedError, match="SSM state"):
            T.init_paged_cache(registry.get_smoke(arch), 4, 64, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", [False, True])
def test_forward_train_loss_lb_and_grads_match(arch, sparse):
    """Loss, nll, the summed load-balance loss and every parameter's
    gradient (the shared block's summed over its uses) against
    ``jax.value_and_grad(T.forward_train)``; B = 2, S = 128."""
    jcfg, cfg, params, model = _pair(arch, sparse)
    batch = data.SyntheticLM(cfg.vocab_size, 128, 2, seed=3).batch(0)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.forward_train(jcfg, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    ))(params)
    loss, m = T.forward_train(cfg, model, batch)
    _close(loss, jloss, 1e-5)
    _close(m["nll"], jm["nll"], 1e-5)
    _close(m["lb_loss"], jm["lb_loss"], 1e-6)
    assert (m["lb_loss"].item() > 0) == (cfg.family == "moe")
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    want = params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        err = (g - want[n]).abs().max() / want[n].abs().max().clamp(min=1e-30)
        assert err <= 1e-4, (n, float(err))
