"""The MoE, SSM and hybrid families served and trained against the JAX
package on the CPU at smoke width, on JAX-initialised weights through
``bridge.params_from_jax``: ``prefill``'s logits and caches; greedy
streams of deepseek-moe-16b and kimi-k2-1t-a32b through the paged engine
(a ragged batch whose padding reaches the router) equal to the JAX
``Engine``'s on ``make_tp_mesh(1)``; streams of mamba2-130m and
zamba2-2.7b through the fixed-batch ``Server`` equal to the JAX
``Server``'s, and with one prefill pass to JAX's ``prefill`` then
``decode_step``; and the engine's and the serve CLI's handling of SSM
configs. ``tests/test_torch_families_optim.py`` holds their optimizer
step.

Tolerances: logits and caches 1e-4; streams exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.launch.mesh import make_tp_mesh
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig

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
def _jax_params(arch, sparse=True):
    jcfg = jreg.get_smoke(arch, sparse=sparse)
    return jcfg, jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0), jcfg))


def _pair(arch, sparse=True):
    jcfg, tree = _jax_params(arch, sparse)
    cfg = registry.get_smoke(arch, sparse=sparse)
    model = T.init_model(cfg, device="cpu", params=params_from_jax(tree, cfg, "cpu"))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match(arch):
    """``prefill`` of B = 2, S = 96: the last-token logits, every
    attention group's K/V and every SSM group's conv window and state
    within 1e-4."""
    jcfg, cfg, params, model = _pair(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 96)).astype(np.int32)
    jl, jcaches = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}))(params, jnp.asarray(toks))
    tl, tcaches = T.prefill(cfg, model, {"tokens": toks})
    _close(tl, jl, 1e-4)
    assert len(jcaches) == len(tcaches) == len(cfg.layer_groups())
    for g, jc, tc in zip(cfg.layer_groups(), jcaches, tcaches):
        assert set(tc) == ({"conv", "state"} if g.kind == "ssm" else {"k", "v"}) == set(jc)
        for name in tc:
            _close(tc[name], jc[name], 1e-4)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_moe_engine_streams_equal_reference_engine(arch):
    """Greedy streams of 4 requests over 2 slots, prompts of 9 to 202
    tokens: the first two (30 and 50 tokens) share a bucket and one
    prefill call, so the shorter one's padding goes through the router
    and counts against the experts' capacity in both packages."""
    jcfg, tree = _jax_params(arch)
    cfg = registry.get_smoke(arch, sparse=True)
    page = cfg.attn_block
    rng = np.random.default_rng(5)
    work = [(rng.integers(0, cfg.vocab_size, p).astype(np.int32), g)
            for p, g in [(30, 6), (50, 5), (3 * page + 10, 5), (2 * page + 1, 4), (9, 7)]]
    ecfg = dict(max_slots=2, max_len=6 * page)
    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg),
                   params=jax.tree.map(jnp.asarray, tree))
    eng = Engine(cfg, engine_cfg=EngineConfig(**ecfg), params=params_from_jax(tree, cfg, "cpu"), device="cpu")

    def serve_all(e):
        uids = {e.submit(p, g): i for i, (p, g) in enumerate(work)}
        return {uids[f.uid]: f.tokens.tolist() for f in e.drain(max_steps=200)}

    want = serve_all(jeng)
    assert serve_all(eng) == want and len(want) == len(work)
    assert eng.stats_summary()["mean_prefill_batch"] > 1  # a ragged group was prefilled


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_server_streams_equal_reference(arch):
    """The ``Server``, which prefills an SSM or hybrid config in one pass,
    equals JAX's ``prefill`` (its K/V caches zero-padded to the decode
    length) then ``decode_step``, greedy."""
    jcfg = jreg.get_smoke(arch, sparse=True)
    cfg = registry.get_smoke(arch, sparse=True)
    jsrv = jserve.Server(jcfg, make_tp_mesh(1))
    params = jax.tree.map(np.asarray, jsrv.params)
    sd = params_from_jax(params, cfg, "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    max_len = 40 + 12 + 1
    jp = jax.tree.map(jnp.asarray, params)
    logits, caches = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(prompts)})
    caches = [c if "state" in c else {k: jnp.pad(v, ((0, 0), (0, 0), (0, max_len - 40), (0, 0), (0, 0)))
                                      for k, v in c.items()} for c in caches]
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, p, c, t, pos))
    tok, ref = jnp.argmax(logits, -1).astype(jnp.int32), []
    for j in range(12):
        ref.append(np.asarray(tok))
        logits, caches = step(jp, caches, tok, jnp.asarray(40 + j, jnp.int32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    got = serve.Server(cfg, params=sd, device="cpu").generate(prompts, 12)
    np.testing.assert_array_equal(got, np.stack(ref, axis=1))


def test_engine_refuses_ssm_configs():
    for arch in ("mamba2-130m", "zamba2-2.7b"):
        with pytest.raises(ValueError, match="launch.serve.Server"):
            Engine(registry.get_smoke(arch), device="cpu")


def test_cli_serves_ssm_archs_with_the_server(capsys):
    """An SSM arch goes to the fixed-batch ``Server``, greedy only: the
    CLI's grid equals the ``Server``'s, and a sampler is refused."""
    args = ["--arch", "zamba2-2.7b", "--sparse", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "12", "--gen", "5"]
    served = serve.main(args)
    assert served.engine is None and "has SSM layers: using the fixed-batch Server" in capsys.readouterr().out
    cfg = registry.get_smoke("zamba2-2.7b", sparse=True)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 12), dtype=np.int32)
    np.testing.assert_array_equal(np.stack(served.tokens), serve.Server(cfg, device="cpu").generate(prompts, 5))
    with pytest.raises(SystemExit, match="plain greedy only"):
        serve.main(args + ["--temperature", "0.7"])
