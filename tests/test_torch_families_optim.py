"""The optimizer's leaf rule across several layer groups: one AdamW step
of the port's ``training.optimizer.apply_updates``, keyed by the model
config, against the JAX package's ``repro.training.optimizer`` on the
deepseek-moe-16b smoke model (groups ``dense_0`` of one stacked layer and
``moe_0``) and the zamba2-2.7b smoke model (SSM groups ``ssm_0``,
``ssm_1`` and the unstacked ``shared_attn``), with and without
compressed gradients, on bridged JAX-initialised weights. The reference
decays a leaf of ndim >= 2 and quantizes each leaf with its own int8
scale, so both rules follow its groups.

Tolerances: parameters within 1e-6; grad_norm 1e-5; mu and nu 1e-5
relative; ef within 1e-6 of the leaf's largest gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro.training import optimizer as jopt
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import OptConfig, apply_updates, decays, init_opt_state, reference_leaf


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


def _pair(arch):
    jcfg = jreg.get_smoke(arch, sparse=True)
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0), jcfg))
    cfg = registry.get_smoke(arch, sparse=True)
    model = T.init_model(cfg, device="cpu", params=params_from_jax(tree, cfg, "cpu"))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), model


def test_reference_leaf_keys_by_group():
    """deepseek-moe's dense_0 and moe_0 are two leaves of every path; each
    of zamba2's SSM groups is a leaf of its own, and its shared block's
    leaves are unstacked (1-D norm scales do not decay)."""
    moe = registry.get_smoke("deepseek-moe-16b", sparse=True)
    assert reference_leaf("layers.0.attn.wq.blocks", moe) == "layers.dense_0.attn.wq.blocks"
    assert reference_leaf("layers.2.attn.wq.blocks", moe) == "layers.moe_0.attn.wq.blocks"
    hyb = registry.get_smoke("zamba2-2.7b", sparse=True)
    assert [reference_leaf(f"layers.{i}.ssm.D", hyb) for i in (0, 1, 2, 3)] == [
        "layers.ssm_0.ssm.D", "layers.ssm_0.ssm.D", "layers.ssm_1.ssm.D", "layers.ssm_1.ssm.D"]
    scale = torch.ones(4)
    assert not decays("shared_attn.attn_norm.scale", scale, hyb)
    assert decays("layers.0.norm.scale", scale, hyb)
    dense = registry.get_smoke("qwen3-1.7b", sparse=True)
    assert reference_leaf("layers.1.attn.wq.blocks", dense) == "layers.dense_0.attn.wq.blocks"


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-2.7b"])
def test_optimizer_step_matches_reference(arch, compress):
    """One AdamW step of the port's ``apply_updates`` (keyed by the model
    config) against the JAX optimizer's, on the same bridged params and
    the same numpy-seeded gradients (each leaf at its own scale, so the
    int8 scales differ by group): grad_norm within 1e-5, parameters within
    1e-6, mu and nu within 1e-5 relative (the clip factor carries the
    norm's summation order), ef (a residual g - deq, as precise as the gradient)
    within 1e-6 of the leaf's largest gradient. Both rules that depend on
    the reference's leaf show: the shared block's 1-D norm scales take the
    Adam step without decay, and every group has its own int8 scale."""
    jcfg, cfg, params, model = _pair(arch)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10, compress_grads=compress)
    jo = jopt.OptConfig(**opt.__dict__)
    rng = np.random.default_rng(7)
    leaves, treedef = jax.tree.flatten(params)
    jg = jax.tree.unflatten(treedef, [
        jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 1e-2 * (1.0 + i % 7))
        for i, p in enumerate(leaves)])
    jstate = jopt.init_opt_state(jo, params)
    new_params, new_state, jm = jax.jit(lambda p, g, s: jopt.apply_updates(jo, p, g, s))(params, jg, jstate)

    tparams = {n: [p.detach()] for n, p in model.named_parameters()}
    grads = params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")
    state = init_opt_state(opt, tparams)
    m = apply_updates(opt, tparams, {n: [g] for n, g in grads.items()}, state, cfg)
    _close(np.float32(float(m["grad_norm"])), jm["grad_norm"], 1e-5)
    want_p = params_from_jax(jax.tree.map(np.asarray, new_params), cfg, "cpu")
    want_s = opt_state_from_jax(jax.tree.map(np.asarray, new_state), cfg, "cpu")
    assert state["step"] == want_s["step"] == 1
    for name, (p,) in tparams.items():
        _close(p, want_p[name], 1e-6)
        for key in ("mu", "nu"):
            w = want_s[key][name]
            np.testing.assert_allclose(state[key][name][0].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6 * float(w.abs().max()) + 1e-12, err_msg=f"{key} {name}")
        if compress:
            atol = 1e-6 * float(grads[name].abs().max())
            np.testing.assert_allclose(state["ef"][name][0].numpy(), want_s["ef"][name].numpy(), rtol=0,
                                       atol=atol, err_msg=f"ef {name}")
