"""The vlm and audio backbones (qwen2-vl-7b, musicgen-large) against the
JAX package on the CPU at smoke width, from their stub frontend's data
to serving: ``EmbedsWrapper``'s batches, one AdamW step on them (the
token table, which the loss does not reach, decays), the training
launcher, the greedy paged engine's streams on token inputs, and the
serve CLI's refusal. ``tests/test_torch_vlm_audio.py`` holds the configs,
M-RoPE and the model's forward and gradients, and the helpers shared here.

Tolerances: the step's are ``tests/test_torch_training.py``'s
(``_check_step``); batches and streams exact."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.mesh import make_tp_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.training import data as jdata
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.training import data
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import OptConfig, init_opt_state
from test_torch_training import _check_step, _one_device, _unsharded
from test_torch_vlm_audio import ARCHS, _embeds_batch, _jax_params, _np, _one_torch_thread, _pair  # noqa: F401


@pytest.mark.parametrize("arch", ARCHS)
def test_embeds_wrapper_batches_equal_reference(arch):
    """Bit-equal batches at steps 0 and 5, the table drawn once."""
    cfg = registry.get_smoke(arch)
    n = len(cfg.mrope_sections)
    src = data.EmbedsWrapper(data.SyntheticLM(cfg.vocab_size, 64, 3, seed=2), cfg.d_model, n_pos_streams=n)
    ref = jdata.EmbedsWrapper(jdata.SyntheticLM(cfg.vocab_size, 64, 3, seed=2), cfg.d_model, n_pos_streams=n)
    for step in (0, 5):
        got, want = src.batch(step), ref.batch(step)
        assert set(got) == set(want) == ({"embeds", "labels", "positions"} if n else {"embeds", "labels"})
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            np.testing.assert_array_equal(got[key], want[key])
    assert src.table() is src.table()
    assert src.state() == ref.state()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One AdamW step of ``make_train_step`` against the JAX package's
    jitted, mesh-free step on bridged weights, sparse, B = 4, S = 128,
    an ``EmbedsWrapper`` batch (``_check_step``'s tolerances; where it
    asks which gradients are large it reads the port's, held to JAX's by
    ``test_forward_train_on_embeds_matches``). The token table's gradient
    is zero on both sides, so its step is pure weight decay: equal to
    JAX's within 1e-7, and not where it started."""
    jcfg, cfg, params, model = _pair(arch, True)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _embeds_batch(cfg, b=4)
    jb = jax.tree.map(jnp.asarray, batch)
    loss, _ = T.forward_train(cfg, model, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named.items(), grads)}
    jstate = {"params": params, "opt": jopt.init_opt_state(jopt.OptConfig(**opt.__dict__), params)}
    jstate, jm = jax.jit(jloop.make_train_step(jcfg, jopt.OptConfig(**opt.__dict__)))(jstate, jb)
    tok0 = model.embed.tok.detach().clone()
    ms = _one_device(cfg, model)
    state = init_opt_state(opt, ms.shards)
    m = make_train_step(cfg, opt)(ms, state, batch)
    model, state = _unsharded(ms, state)
    _check_step(cfg, opt, opt.lr, grads, jstate, jm, model, state, m)
    want = np.asarray(jstate["params"]["embed"]["tok"])
    np.testing.assert_allclose(_np(model.embed.tok), want, rtol=0, atol=1e-7)
    assert not torch.equal(model.embed.tok.detach(), tok0)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_smoke(arch, tmp_path, capsys):
    """``repro_torch.launch.train --smoke --device cpu`` trains the
    backbone on ``EmbedsWrapper`` batches and checkpoints."""
    train.main(["--arch", arch, "--sparse", "--smoke", "--steps", "3", "--batch", "2", "--seq", "64",
                "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and "after 3 steps" in out
    loss = float(out.split("final loss ")[1].split()[0])
    assert np.isfinite(loss)
    assert any(tmp_path.iterdir())


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_equal_reference_engine(arch):
    """Greedy paged streams of the sparse smoke backbone, token inputs, 5
    requests over 2 slots with the prefix cache on: two share a 2-page
    prefix (a partial prefill at absolute positions), one is long enough
    that the decode schedule skips pages. The port's ``Engine`` on the
    JAX engine's bridged weights gives the JAX ``Engine``'s tokens."""
    jcfg, tree = _jax_params(arch, True)
    cfg = registry.get_smoke(arch, sparse=True)
    page = cfg.attn_block
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 2 * page).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (30, 5 * page + 10, 9)]
    prompts += [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n).astype(np.int32)]) for n in (7, 40)]
    work = list(zip(prompts, (6, 5, 7, 4, 5)))
    ecfg = dict(max_slots=2, max_len=8 * page, prefix_cache=True)
    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg),
                   params=jax.tree.map(jnp.asarray, tree))
    eng = Engine(cfg, engine_cfg=EngineConfig(**ecfg), params=params_from_jax(tree, cfg, "cpu"), device="cpu")

    def serve_all(e):
        uids = {e.submit(p, g): i for i, (p, g) in enumerate(work)}
        return {uids[f.uid]: f.tokens.tolist() for f in e.drain(max_steps=300)}

    want = serve_all(jeng)
    assert serve_all(eng) == want and len(want) == len(work)
    assert eng.stats_summary()["prefix_cache"]["hit_tokens"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_refuses_stub_frontends(arch, monkeypatch):
    """The serve CLI refuses a backbone whose frontend is a stub, with the
    JAX CLI's message."""
    argv = ["--arch", arch, "--sparse", "--smoke"]
    with pytest.raises(SystemExit) as got:
        serve.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as want:
        jserve.main()
    assert str(got.value) == str(want.value) and "stub modality frontend" in str(got.value)
