"""The port's model against the JAX package's on bridged weights: configs,
the static tables, ``apply_linear`` (sparse and dense), norms and RoPE,
and the logits and paged-cache writes of ``prefill_paged`` and
``decode_step_paged``. qwen3 smoke width, sparse and dense, float32,
tolerance 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import budget as jbudget
from repro.core import pixelfly as jpf
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.core import budget
from repro_torch.core import pixelfly as pf
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = 1e-4


def _pair(sparse):
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=sparse)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=sparse)
    params = JT.init_model(jax.random.PRNGKey(0), jcfg)
    model = T.init_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu"))
    return jcfg, cfg, params, model


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("smoke", [False, True])
def test_registry_matches_reference(sparse, smoke):
    get = "get_smoke" if smoke else "get"
    a = dataclasses.asdict(getattr(registry, get)("qwen3-1.7b", sparse=sparse))
    b = dataclasses.asdict(getattr(jreg, get)("qwen3-1.7b", sparse=sparse))
    assert a == b


@pytest.mark.parametrize("din,dout,density,block", [
    (2048, 2048, 0.2, 128), (2048, 1024, 0.2, 128), (2048, 6144, 0.2, 128),
    (6144, 2048, 0.2, 128), (256, 512, 0.5, 64), (96, 160, 0.3, 128), (100, 30, 0.3, 128),
])
def test_linear_spec_and_param_count_match(din, dout, density, block):
    a = pf.LinearSpec.pixelfly(din, dout, density, block=block)
    b = jpf.LinearSpec.pixelfly(din, dout, density, block=block)
    assert (a.sparse, a.block, a.max_stride, a.rank) == (b.sparse, b.block, b.max_stride, b.rank)
    assert pf.param_count(a) == jpf.param_count(b)
    assert budget.split_sparse_lowrank(dout, din, density) == jbudget.split_sparse_lowrank(dout, din, density)


@pytest.mark.parametrize("sparse", [False, True])
def test_bridge_covers_every_parameter(sparse):
    _, cfg, params, model = _pair(sparse)
    sd = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    assert set(sd) == set(model.state_dict())
    blk = model.layers[1].attn.wq
    leaf = params["groups"]["dense_0"]["attn"]["wq"]["blocks" if sparse else "w"][1]
    _close(blk.blocks if sparse else blk.w, leaf, 0)


@pytest.mark.parametrize("sparse", [False, True])
def test_apply_linear_matches(sparse):
    jcfg, cfg, params, model = _pair(sparse)
    x = np.random.default_rng(0).standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    for name in ("wq", "wk", "wo"):
        lin = getattr(model.layers[0].attn, name)
        jp = jax.tree.map(lambda a: a[0], params["groups"]["dense_0"]["attn"][name])
        spec = getattr(JL.AttnSpec(jcfg), name)
        xin = x if name != "wo" else np.random.default_rng(1).standard_normal(
            (3, 5, cfg.q_dim)).astype(np.float32)
        want = jpf.apply_linear(spec, jp, jnp.asarray(xin))
        _close(lin(torch.from_numpy(xin)), want)
        _close(pf.apply_linear(lin.spec, lin._parameters, torch.from_numpy(xin)), want)


def test_norm_and_rope_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 7)).astype(np.int32)
    _close(L.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x)),
           JL.head_rmsnorm(jnp.asarray(scale), jnp.asarray(x)), 1e-5)
    cos, sin = L.rope_angles(torch.from_numpy(pos), 64, 1e6)
    _close(L.apply_rope(torch.from_numpy(x), cos, sin),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-4)


def _prefill_inputs(cfg):
    page = cfg.attn_block
    n, s = 2, 4 * page
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)
    plens = np.array([s - 5, 2 * page + 3], np.int32)
    rows = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)  # 0: trash tail
    return toks, plens, rows


@pytest.mark.parametrize("sparse", [False, True])
def test_prefill_then_decode_match(sparse):
    jcfg, cfg, params, model = _pair(sparse)
    page, n_pages = cfg.attn_block, 17
    toks, plens, rows = _prefill_inputs(cfg)
    jc = JT.init_paged_cache(jcfg, n_pages, page)
    jl, jc = JT.prefill_paged(jcfg, params, jnp.asarray(toks), jnp.asarray(plens),
                              jc, jnp.asarray(rows))
    tc = T.init_paged_cache(cfg, n_pages, page, device="cpu")
    tl, tc = T.prefill_paged(cfg, model, torch.from_numpy(toks),
                             torch.from_numpy(plens), tc, torch.from_numpy(rows))
    _close(tl, jl)
    real = [1, 2, 3, 4, 5, 6, 7]  # the trash page's contents are unspecified
    for name in ("k", "v"):
        _close(tc[0][name][:, real], np.asarray(jc[0][name])[:, real])

    # one decode step: two live slots past a page boundary + an idle slot
    table = np.zeros((3, 8), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[1, :3] = [5, 6, 7]
    pos = np.array([plens[0], plens[1], 0], np.int32)
    tok = np.array([5, 7, 0], np.int32)
    jl2, jc = JT.decode_step_paged(jcfg, params, jc, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(table))
    tl2, tc = T.decode_step_paged(cfg, model, tc, torch.from_numpy(tok),
                                  torch.from_numpy(pos), torch.from_numpy(table))
    _close(tl2[:2], np.asarray(jl2)[:2])
    _close(tc[0]["k"][:, real], np.asarray(jc[0]["k"])[:, real])


def test_decode_reaches_sparse_schedule_that_skips_pages():
    """At position 5 pages in, the butterfly schedule visits pages
    {0, 1, 4, 5} of 8: the sparse read skips pages 2 and 3."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    page = cfg.attn_block
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    pos = torch.tensor([5 * page + 3], dtype=torch.int32)
    idx = L.decode_index(cfg, table, pos, page)
    visited = {int(l) for l, k in zip(idx.logical[0], idx.keep[0]) if k}
    assert visited == {0, 1, 4, 5}
