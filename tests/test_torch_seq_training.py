"""Training where tp does not divide the kv heads, the JAX rules' "seq"
attention mode, on the CPU (``make_local_mesh(d, m, ["cpu"] * n)``), held
against the JAX package with ``bridge.params_from_jax`` weights: smoke
qwen3-1.7b (2 kv heads, head_dim 64) at 2 layers, vocab 256, fp32.

(a) One ``make_train_step`` step on a ``MeshState`` at tp (1, 4) and
(2, 4), sparse and dense, equals the JAX ``Trainer``'s jitted step on
``make_tp_mesh(1)``: loss, grad norm, lr, mu, nu and the parameters within
``test_torch_training._check_step``'s tolerances (loss, grad norm and lr
1e-5; mu 1e-7 + 1e-4 relative; nu 1e-9 + 1e-4 relative; each parameter
1e-6 where the JAX gradient exceeds 1e-5, else 2 * lr). At S = 128 and
attention block 64 two of the four shards attend no query rows.
(b) The plain query-slice backward (``autograd.sparse_attention_vjp`` at
each shard's ``q_block0``, and the dense arm's ``chunked_attention`` at
each shard's ``q_offset`` under autograd), dq by rows and dk, dv summed
over tp in {2, 4, 8}, equals ``jax.vjp`` of the JAX package's
``sparse_attention_jnp`` (``flash_attention_jnp``) over the whole
sequence within 1e-5; at tp 8 two shards hold no rows and add zeros.
(c) ``chip_smoke.py`` phase 19's two planted faults (k_norm taking its
gradient from shard 0 alone; the query slices shifted by one block) each
fail (a)'s check. (d) A checkpoint written at (1, 4) resumes at (1, 1)
with the single-device history, and one written at (1, 1) resumes at
(1, 4), within 1e-5 of the uninterrupted run's losses."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.kernels import autograd as AG
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training.loop import MeshState, make_train_step
from repro_torch.training.optimizer import OptConfig, init_opt_state
from test_torch_mesh_training import _jax_step, _trainer
from test_torch_training import _check_step, _jax_grads, _unsharded

ROOT = Path(__file__).resolve().parents[1]
SEQ_MESHES = {"tp (1, 4)": (1, 4), "tp (2, 4)": (2, 4)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_local_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# (a) one step against the JAX Trainer on make_tp_mesh(1)
# ----------------------------------------------------------------------


def _seq_step(sparse, shape):
    """One step of the bridged JAX initial params on a ``MeshState`` of
    ``shape`` under tp, and what ``_check_step`` reads."""
    jcfg, params, batch, jstate, jm = _jax_step(sparse, "tp", False)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=sparse).replace(num_layers=2, vocab_size=256)
    assert L.seq_mode(cfg, shape[1]) and cfg.head_dim % shape[1] == 0
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ms = MeshState(cfg, _mesh(shape), "tp", params_from_jax(params, cfg, "cpu"))
    opt_state = init_opt_state(opt, ms.shards)
    m = make_train_step(cfg, opt)(ms, opt_state, batch)
    model, state = _unsharded(ms, opt_state)
    return (cfg, opt, opt.lr, _jax_grads(jcfg, cfg, params, batch), jstate, jm, model, state, m)


@pytest.mark.parametrize("mesh", list(SEQ_MESHES))
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_seq_mesh_step_matches_jax_trainer(sparse, mesh):
    """The sequence-parallel mode's step equals the JAX Trainer's under
    ``_check_step``'s tolerances (module docstring). The sparse run's
    query slices at S = 128, block 64: shards 0 and 2 hold no rows."""
    if sparse:
        assert L.query_slices(128, 4, 64) == [(0, 0), (0, 64), (64, 64), (64, 128)]
    _check_step(*_seq_step(sparse, SEQ_MESHES[mesh]))


# ----------------------------------------------------------------------
# (b) the query-slice backward, summed over the shards
# ----------------------------------------------------------------------


def _attention_inputs(s, hk, g, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, s, hk, g, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, hk, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((2, s, hk, g, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_query_slice_backward_sums_to_the_whole_gradient(sparse, tp):
    """S = 96: six attention blocks of 16 (sparse; local 2, global 1), or
    96 rows in chunks of 32 (dense). Each shard's rows (``query_slices``)
    give their dq rows and a part of dk and dv; the rows joined and the
    parts summed equal ``jax.vjp`` of the whole sequence's attention within
    1e-5. At tp 8 over six blocks two shards hold none: their parts are
    zeros, not NaN."""
    s, hk, g, d, block, chunk = 96, 2, 3, 16, 16, 32
    q, k, v, do = _attention_inputs(s, hk, g, d, seed=tp)
    scale = d ** -0.5
    if sparse:
        sched = JL._train_schedule(s, s, block, 2, 0, 1)

        def jfwd(qq, kk, vv):
            return JL.sparse_attention_jnp(qq, kk, vv, sched, causal=True, sm_scale=scale)
    else:
        def jfwd(qq, kk, vv):
            return JL.flash_attention_jnp(qq, kk, vv, causal=True, chunk=chunk, sm_scale=scale)

    _, vjp = jax.vjp(jfwd, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kv_index, valid = L._schedule_tensors(s, block, 2, 0, 1, "cpu")
    dq, dk, dv = torch.zeros_like(tq), torch.zeros_like(tk), torch.zeros_like(tv)
    slices = L.query_slices(s, tp, block if sparse else 1)
    assert slices[0][0] == 0 and slices[-1][1] == s
    assert (sum(a == b for a, b in slices) == 2) == (sparse and tp == 8)
    for a0, a1 in slices:
        if sparse:
            gq, gk, gv = AG.sparse_attention_vjp(tq[:, a0:a1], tk, tv, kv_index, valid, tdo[:, a0:a1], block=block,
                                                 causal=True, sm_scale=scale, q_block0=a0 // block)
        else:
            qs, kk, vv = (t.clone().requires_grad_() for t in (tq[:, a0:a1], tk, tv))
            o = L.flash_attention(qs, kk, vv, sm_scale=scale, chunk=chunk, q_offset=a0)
            gq, gk, gv = torch.autograd.grad(o, (qs, kk, vv), tdo[:, a0:a1])
        assert gq.shape[1] == a1 - a0 and torch.isfinite(gk).all() and torch.isfinite(gv).all()
        if a0 == a1:
            assert not gk.any() and not gv.any()
        dq[:, a0:a1] = gq
        dk, dv = dk + gk, dv + gv
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)


def test_attention_seq_refuses_an_unknown_mode():
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=1)
    model = T.init_model(cfg, seed=0, device="cpu")
    x = torch.zeros((1, 64, cfg.d_model))
    with pytest.raises(ValueError, match="unknown attention mode 'verify'"):
        L.attention_seq(cfg, [model.layers[0].attn] * 4, [x] * 4, [None] * 4, [None] * 4, [{"mode": "verify"}] * 4)


# ----------------------------------------------------------------------
# (c) planted faults
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["replicated leaf", "query slice shifted"])
def test_planted_seq_faults_fail_the_step_check(kind):
    """``chip_smoke.planted_seq_train_fault`` at tp (1, 4), sparse:
    smoke qwen3-1.7b has qk-norm, so "replicated leaf" is k_norm taking
    its gradient from shard 0 (which holds no query rows: its part is
    zero); "query slice shifted" has shard 3 attend its rows as the block
    before them. Each step fails (a)'s check."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    cs = _chip_smoke()
    assert cs.seq_train_leaf(cfg) == r"\.attn\.k_norm$" and kind in cs.SEQ_TRAIN_FAULTS
    with cs.planted_seq_train_fault(cfg, 4, kind):
        args = _seq_step(True, (1, 4))
    with pytest.raises(AssertionError):
        _check_step(*args)


# ----------------------------------------------------------------------
# (d) checkpoints across the mode
# ----------------------------------------------------------------------

_WHOLE: dict = {}


def _whole_history(tmp):
    """4 steps of the single-device ``Trainer`` (smoke qwen3-1.7b sparse,
    vocab 64, B = 4, S = 64: at tp 4 only shard 3 holds query rows)."""
    if "hist" not in _WHOLE:
        _WHOLE["hist"] = _trainer(tmp / "whole").run(4)
    return _WHOLE["hist"]


@pytest.mark.parametrize("first,then", [((1, 4), None), (None, (1, 4))], ids=["(1, 4) to (1, 1)", "(1, 1) to (1, 4)"])
def test_checkpoint_resumes_across_the_seq_mode(first, then, tmp_path):
    """2 steps, a checkpoint, then 2 more steps on the other layout: the
    new trainer resumes at step 2 and its losses and grad norms equal the
    uninterrupted single-device run's within 1e-5."""
    whole = _whole_history(tmp_path)
    a = _trainer(tmp_path / "ck", None if first is None else _mesh(first), "tp")
    a.run(2)
    a.checkpoint()
    b = _trainer(tmp_path / "ck", None if then is None else _mesh(then), "tp")
    assert b.step == 2 and b.opt["step"] == 2
    rest = b.run(2)
    assert [h["step"] for h in rest] == [3, 4]
    for k in ("loss", "grad_norm"):
        assert max(abs(x[k] - y[k]) / (1 + abs(y[k])) for x, y in zip(rest, whole[2:])) <= 1e-5, k
