"""The vlm and audio backbones the port copies (qwen2-vl-7b: M-RoPE, QKV
bias, untied head; musicgen-large: multi-head attention at head dim 64,
untied head), both fed embeddings by a stub frontend, against the JAX
package on the CPU at smoke width: the configs field by field, M-RoPE,
the bridge's coverage, ``forward_train`` and ``prefill`` on embeddings and
position streams. ``tests/test_torch_vlm_audio_run.py`` holds their data,
training step, launcher and engine.

Tolerances are ``tests/test_torch_training.py``'s and
``tests/test_torch_model.py``'s: M-RoPE 1e-6 (fp32, the same products),
loss 1e-5, gradients 2e-5, logits 1e-4; configs exact. Every QKV bias is
drawn at random (the reference initialises them to zero) so the bias path
is exercised."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import data

ARCHS = ["qwen2-vl-7b", "musicgen-large"]
SPARSE = [False, True]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several workers
    on a few cores, where torch's default pool spins against the others;
    results only move in the last bits, inside every tolerance here."""
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


def _grid_positions(cfg, b, s):
    """Distinct t/h/w streams, as an image's patches give them: t the
    token index, h and w the row and column of an 8-wide grid; (B, S)
    plain positions for a model without M-RoPE."""
    t = np.arange(s, dtype=np.int32)
    if not cfg.mrope_sections:
        return np.broadcast_to(t, (b, s)).copy()
    streams = np.stack([t, t // 8, t % 8], axis=-1)
    return np.broadcast_to(streams, (b, s, 3)).copy()


def _embeds_batch(cfg, b=2, s=128, step=0):
    """``EmbedsWrapper``'s batch of seeded synthetic tokens, positions
    replaced by distinct grid streams."""
    src = data.EmbedsWrapper(data.SyntheticLM(cfg.vocab_size, s, b, seed=3), cfg.d_model,
                             n_pos_streams=len(cfg.mrope_sections))
    batch = src.batch(step)
    batch["positions"] = _grid_positions(cfg, b, s)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", SPARSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_registry_matches_reference(arch, sparse, smoke):
    get = "get_smoke" if smoke else "get"
    a = dataclasses.asdict(getattr(registry, get)(arch, sparse=sparse))
    b = dataclasses.asdict(getattr(jreg, get)(arch, sparse=sparse))
    assert a == b


@pytest.mark.parametrize("sections,d,theta", [((16, 24, 24), 128, 1e6), ((8, 12, 12), 64, 1e4)])
def test_mrope_matches_reference(sections, d, theta):
    """Distinct random t/h/w streams: each section rotates by its own
    stream, so a wrong split shows; fp32 within 1e-6 of the JAX
    ``apply_rope``."""
    rng = np.random.default_rng(d)
    b, s, h = 2, 40, 3
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = rng.integers(0, 4096, (b, s, 3)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    cos, sin = L.rope_angles(torch.from_numpy(pos), d, theta, sections)
    got = L.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # a split that swapped two streams would differ far beyond that
    cos2, sin2 = L.rope_angles(torch.from_numpy(pos[..., [1, 0, 2]].copy()), d, theta, sections)
    assert np.abs(L.apply_rope(torch.from_numpy(x), cos2, sin2).numpy() - np.asarray(want)).max() > 1e-2


def test_mrope_equal_streams_give_plain_rope_bits():
    """Three equal streams (text, and what the paged entry points and
    ``EmbedsWrapper`` give) are plain RoPE, bit for bit."""
    pos = torch.from_numpy(np.random.default_rng(0).integers(0, 2048, (2, 33)))
    plain = L.rope_angles(pos, 128, 1e6)
    mrope = L.rope_angles(pos[..., None].expand(2, 33, 3), 128, 1e6, (16, 24, 24))
    for a, b in zip(plain, mrope):
        assert torch.equal(a, b)


def test_other_families_still_refused():
    """Every family of the reference builds in the port (the MoE, SSM and
    hybrid ones since their port); a family the reference does not know
    is still refused, as its ``layer_groups`` refuses it."""
    cfg = registry.get_smoke("qwen3-1.7b")
    for arch in ("deepseek-moe-16b", "mamba2-130m", "zamba2-2.7b"):
        T.init_model(registry.get_smoke(arch), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        T.init_model(dataclasses.replace(cfg, family="retnet"), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", SPARSE)
def test_bridge_covers_every_parameter(arch, sparse):
    """Untied head, QKV bias (qwen2-vl only), and the token table."""
    jcfg, tree = _jax_params(arch, sparse)
    cfg = registry.get_smoke(arch, sparse=sparse)
    sd = params_from_jax(tree, cfg, "cpu")
    model = T.init_model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert all(sd[n].shape == t.shape and sd[n].dtype == t.dtype for n, t in model.state_dict().items())
    assert len([n for n in sd if n.endswith(".b")]) == (3 * cfg.num_layers if cfg.qkv_bias else 0)
    assert "head.w" in sd and "embed.tok" in sd
    np.testing.assert_array_equal(sd["head.w"].numpy(), tree["head"]["w"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sparse", SPARSE)
def test_forward_train_on_embeds_matches(arch, sparse):
    """Loss, nll and every parameter's gradient against
    ``jax.value_and_grad(T.forward_train)`` on an ``EmbedsWrapper`` batch
    with distinct position streams; B = 2, S = 128 (sparse attention over
    two blocks of 64). The token table takes no part in the loss: JAX's
    gradient is zeros, the port's is absent."""
    jcfg, cfg, params, model = _pair(arch, sparse)
    batch = _embeds_batch(cfg)
    assert "tokens" not in batch
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.forward_train(jcfg, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    )(params)
    loss, m = T.forward_train(cfg, model, batch)
    _close(loss, jloss, 1e-5)
    _close(m["nll"], jm["nll"], 1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()], allow_unused=True)
    want = params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        if n == "embed.tok":
            assert g is None and not want[n].any()
        else:
            _close(g, want[n], 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_embeds_matches(arch):
    """``prefill`` on embeddings and distinct position streams: the
    last-token logits and every layer's K/V within 1e-4 of JAX's."""
    jcfg, cfg, params, model = _pair(arch, True)
    batch = _embeds_batch(cfg, b=2, s=128)
    del batch["labels"]
    jl, jcaches = JT.prefill(jcfg, params, jax.tree.map(jnp.asarray, batch))
    tl, tcaches = T.prefill(cfg, model, batch)
    _close(tl, jl, 1e-4)
    for jc, tc in zip(jcaches, tcaches):
        for name in ("k", "v"):
            _close(tc[name], jc[name], 1e-4)


def test_embeds_cast_to_model_dtype():
    """bf16 model, fp32 embeddings: the batch is cast as JAX casts it, so
    the loss equals the one on pre-cast embeddings bit for bit."""
    cfg: ModelConfig = registry.get_smoke("musicgen-large", dtype="bfloat16", num_layers=1)
    model = T.init_model(cfg, device="cpu")
    batch = _embeds_batch(cfg, b=1, s=64)
    cast = dict(batch, embeds=torch.from_numpy(batch["embeds"]).to(torch.bfloat16))
    with torch.no_grad():
        assert torch.equal(T.forward_train(cfg, model, batch)[0], T.forward_train(cfg, model, cast)[0])
