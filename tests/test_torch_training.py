"""The port's training path against the JAX package's, on the CPU, with
numpy-seeded inputs and bridged weights (fp32, smoke width): the
transposed BSR tables, the gradients of ``BsrMatmul`` and
``BlockSparseAttention``, ``forward_train``'s loss and gradients, one
AdamW step of ``make_train_step`` (plain, microbatched, compressed, and
resumed from a bridged JAX optimizer state), the schedule, remat, and
the data streams. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import butterfly as jbf
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.training import data as jdata
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.configs import registry
from repro_torch.core import butterfly as bf
from repro_torch.kernels import autograd as AG
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import data
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.training.loop import MeshState, make_train_step
from repro_torch.training.optimizer import OptConfig, init_opt_state, lr_at, reference_leaf


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# kernels under autograd
# ----------------------------------------------------------------------

# (out, in, max_stride) at block 64: a square pattern, a wide one (gate's
# stretch) and a ragged one (down's: padded transposed slots)
PATTERNS = {"square": (512, 512, 4), "wide": (1536, 512, 2), "ragged": (512, 1536, 8)}


@pytest.mark.parametrize("shape", [(2048, 2048), (1024, 2048), (6144, 2048), (2048, 6144)])
def test_transpose_tables_equal_reference(shape):
    """Exact: the full-width q, k/v, gate/up and down patterns, block 128."""
    pat = bf.make_pattern(*shape, block=128, density=0.2)
    got = bf.transpose_tables(pat.cols, pat.nb_in)
    want = jbf.transpose_tables(pat.cols, pat.nb_in)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", list(PATTERNS))
def test_bsr_matmul_grads_match(kind):
    """dX and dBlocks of ``BsrMatmul`` (CPU: the plain forward, the
    transposed-table dX through ``ops.bsr_matmul``) against jax.grad of
    ``ref.bsr_matmul_custom_vjp`` and torch autograd of
    ``ref.bsr_matmul_gather``; fp32, tolerance 1e-5."""
    n_out, n_in, stride = PATTERNS[kind]
    pat = bf.make_pattern(n_out, n_in, block=64, max_stride=stride)
    _, _, valid = bf.transpose_tables(pat.cols, pat.nb_in)
    assert (valid.mean() < 1) == (kind == "ragged")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 37, n_in)).astype(np.float32)
    blocks = (rng.standard_normal((pat.nb_out, pat.r, 64, 64)) / np.sqrt(pat.r * 64)).astype(np.float32)
    dy = rng.standard_normal((3, 37, n_out)).astype(np.float32)

    def jloss(xx, bb):
        return jnp.sum(jref.bsr_matmul_custom_vjp(xx, bb, pat.cols) * dy)

    jdx, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(blocks))
    tx, tb = (torch.from_numpy(a).requires_grad_() for a in (x, blocks))
    y = AG.bsr_matmul(tx, tb, AG.bsr_tables(pat.cols, pat.nb_in, "cpu"))
    _close(y, jref.bsr_matmul_custom_vjp(jnp.asarray(x), jnp.asarray(blocks), pat.cols), 1e-5)
    y.backward(torch.from_numpy(dy))
    _close(tx.grad, jdx, 1e-5)
    _close(tb.grad, jdb, 1e-5)
    px, pb = (torch.from_numpy(a).requires_grad_() for a in (x, blocks))
    ref.bsr_matmul_gather(px, pb, torch.from_numpy(pat.cols)).backward(torch.from_numpy(dy))
    _close(tx.grad, px.grad.numpy(), 1e-5)
    _close(tb.grad, pb.grad.numpy(), 1e-5)


def test_block_sparse_attention_grads_match():
    """Forward and dq, dk, dv of ``BlockSparseAttention`` against jax.grad
    of the JAX package's ``sparse_attention_jnp`` on its training
    schedule; B = 2, S = 256, block 64, H = 4, Hk = 2, D = 64, fp32,
    tolerance 1e-5."""
    b, s, hk, g, d, block = 2, 256, 2, 2, 64, 64
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, s, hk, g, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hk, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, s, hk, g, d)).astype(np.float32)
    sched = JL._train_schedule(s, s, block, 2, 0, 1)
    scale = d ** -0.5

    def jfwd(qq, kk, vv):
        return JL.sparse_attention_jnp(qq, kk, vv, sched, causal=True, sm_scale=scale)

    jo, vjp = jax.vjp(jfwd, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    kv_index, valid = L._schedule_tensors(s, block, 2, 0, 1, "cpu")
    o = AG.block_sparse_attention(tq, tk, tv, kv_index, valid, block=block, causal=True, sm_scale=scale)
    _close(o, jo, 1e-5)
    o.backward(torch.from_numpy(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, 1e-5)


# ----------------------------------------------------------------------
# the model's loss and gradients, and one optimizer step
# ----------------------------------------------------------------------


def _pair(sparse=True, **over):
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=sparse).replace(**over)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=sparse).replace(**over)
    params = JT.init_model(jax.random.PRNGKey(0), jcfg)
    model = T.init_model(cfg, device="cpu", params=params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu"))
    return jcfg, cfg, params, model


def _jax_grads_by_name(tree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, "cpu")


def _batch(cfg, b=2, s=128, step=0):
    return data.SyntheticLM(cfg.vocab_size, s, b, seed=3).batch(step)


@pytest.mark.parametrize("sparse", [True, False])
def test_forward_train_loss_and_grads_match(sparse):
    """Loss, nll and every parameter's gradient against
    ``jax.value_and_grad(T.forward_train)`` on bridged weights; smoke
    width, fp32, B = 2, S = 128 (sparse attention on two blocks);
    tolerance 1e-5 on the loss, 2e-5 on the gradients."""
    jcfg, cfg, params, model = _pair(sparse)
    batch = _batch(cfg)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.forward_train(jcfg, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    )(params)
    loss, m = T.forward_train(cfg, model, batch)
    _close(loss, jloss, 1e-5)
    _close(m["nll"], jm["nll"], 1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    want = _jax_grads_by_name(jg, cfg)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        _close(g, want[n], 2e-5)


def test_remat_on_and_off_give_the_same_grads():
    """Per-layer recomputation changes no number: gradients equal bit for
    bit with ``remat`` on and off (fp32 smoke width)."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    batch = _batch(cfg)
    out = []
    for remat in (True, False):
        model = T.init_model(cfg.replace(remat=remat), device="cpu")
        loss, _ = T.forward_train(cfg.replace(remat=remat), model, batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _jax_grads(jcfg, cfg, params, batch):
    g = jax.grad(lambda p: JT.forward_train(jcfg, p, jax.tree.map(jnp.asarray, batch))[0])(params)
    return _jax_grads_by_name(g, cfg)


def _int8_boundaries(jgrads, cfg):
    """Per parameter, the elements whose scaled gradient q = |g| / scale
    sits within 1e-4 (1 + q) of a rounding boundary k + 1/2 (the two
    packages' gradients agree to about 2e-5 relative) of the reference's
    int8 quantization (one scale,
    max|g| / 127, per leaf of its tree: the same parameter of every layer),
    and that leaf's quantum. There, fp32 sums in another order may round
    to the next integer on one side only: the first moment then differs by
    one quantum times (1 - b1)."""
    leaves = {}
    for name, g in jgrads.items():
        leaves.setdefault(reference_leaf(name, cfg), []).append(name)
    out = {}
    for names in leaves.values():
        g = {n: _np(jgrads[n]).astype(np.float64) for n in names}
        scale = max(np.abs(a).max() for a in g.values()) / 127.0 or 1.0
        for n, a in g.items():
            q = np.abs(a) / scale
            out[n] = (np.abs(q % 1.0 - 0.5) < 1e-4 * (1.0 + q), scale)
    return out


def _one_device(cfg, model):
    """A (1, 1) ``MeshState`` on the CPU holding copies of ``model``'s
    weights: what ``make_train_step`` steps."""
    return MeshState(cfg, make_local_mesh(devices=["cpu"]), "fsdp", model.state_dict())


def _unsharded(ms, opt_state):
    """An ``LM`` on the mesh state's whole parameters, and its optimizer
    state unsharded, as ``_check_step`` reads them."""
    model = T.init_model(ms.cfg, device="cpu", params=ms.state_dict())
    return model, {k: v if k == "step" else ms.unshard(v) for k, v in opt_state.items()}


def _check_step(cfg, opt, lr, jgrads, jstate, jm, model, state, m, *, flips=None):
    """loss, grad_norm and lr within 1e-5; mu within 1e-7 + 1e-4 relative,
    nu within 1e-9 + 1e-4 relative, ef (a residual gf - deq) within 1e-7 +
    1e-4 of the gradient's magnitude; each parameter within 1e-6
    where the JAX gradient exceeds 1e-5 in magnitude, and within 2 * lr
    elsewhere (a gradient near 0 can take a sign-like Adam step on either
    side). With compressed gradients, ``flips`` (``_int8_boundaries``)
    names the elements on an int8 rounding boundary: there mu and ef may
    differ by one quantum (times 1 - b1 for mu), nu is not held, and the
    parameter is held to 2 * lr; they must be under 1% of all elements."""
    for key in ("loss", "grad_norm", "lr"):
        _close(np.float32(float(m[key])), jm[key], 1e-5)
    jopt_state = opt_state_from_jax(jax.tree.map(np.asarray, jstate["opt"]), cfg, "cpu")
    assert state["step"] == jopt_state["step"]
    assert ("ef" in state) == ("ef" in jopt_state) == (flips is not None)
    n_flip = n_all = 0
    for name in jopt_state["mu"]:
        edge, quantum = flips[name] if flips else (np.zeros(state["mu"][name].shape, bool), 0.0)
        n_flip, n_all = n_flip + edge.sum(), n_all + edge.size
        for key, atol, step in (("mu", 1e-7, 1 - opt.b1), ("nu", 1e-9, None), ("ef", 1e-7, 1.0)):
            if key not in state:
                continue
            got, want = _np(state[key][name]), _np(jopt_state[key][name])
            if key == "ef":  # a residual gf - deq: as precise as the gradient
                ok = np.abs(got - want) <= atol + 1e-4 * np.abs(_np(jgrads[name]))
                assert ok[~edge].all(), (key, name)
            else:
                np.testing.assert_allclose(got[~edge], want[~edge], rtol=1e-4, atol=atol, err_msg=f"{key} {name}")
            if step is not None:
                assert (np.abs(got - want)[edge] <= step * quantum * 1.001 + atol).all(), (key, name)
    assert n_flip <= 1e-2 * n_all, (n_flip, n_all)
    jp = _jax_grads_by_name(jstate["params"], cfg)
    for name, p in model.named_parameters():
        big = np.abs(_np(jgrads[name])) > 1e-5
        if flips:
            big &= ~flips[name][0]
        err = np.abs(_np(p) - _np(jp[name]))
        assert (err[big] <= 1e-6).all(), (name, err[big].max())
        assert (err <= 2 * lr).all(), (name, err.max())


@pytest.mark.parametrize("case", ["plain", "microbatches=2", "compress_grads"])
def test_train_step_matches_jax(case):
    """One ``make_train_step`` step against the JAX package's jitted,
    mesh-free step on bridged weights and a zero optimizer state: loss,
    grad_norm, lr, mu, nu (ef) and the parameters (tolerances in
    ``_check_step``). Smoke width, fp32, B = 4, S = 128."""
    jcfg, cfg, params, model = _pair()
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10, compress_grads=case == "compress_grads")
    k = 2 if case == "microbatches=2" else 1
    batch = _batch(cfg, b=4)
    jgrads = _jax_grads(jcfg, cfg, params, batch)
    jstate = {"params": params, "opt": jopt.init_opt_state(jopt.OptConfig(**opt.__dict__), params)}
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.OptConfig(**opt.__dict__), microbatches=k))
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    ms = _one_device(cfg, model)
    state = init_opt_state(opt, ms.shards)
    m = make_train_step(cfg, opt, microbatches=k)(ms, state, batch)
    model, state = _unsharded(ms, state)
    flips = _int8_boundaries(jgrads, cfg) if opt.compress_grads else None
    _check_step(cfg, opt, opt.lr, jgrads, jstate, jm, model, state, m, flips=flips)


def test_microbatches_must_divide_the_batch():
    """B = 5 rows do not split into k = 2 microbatches: the JAX package's
    step raises on its reshape, and the port's raises ``ValueError``
    before it computes anything, leaving the parameters and the optimizer
    state as they were (exact). B = 4, k = 2 is held to JAX's step by
    ``test_train_step_matches_jax[microbatches=2]``."""
    jcfg, cfg, params, model = _pair()
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(cfg, b=5)
    jstate = {"params": params, "opt": jopt.init_opt_state(jopt.OptConfig(**opt.__dict__), params)}
    with pytest.raises(TypeError):
        jloop.make_train_step(jcfg, jopt.OptConfig(**opt.__dict__), microbatches=2)(
            jstate, jax.tree.map(jnp.asarray, batch))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ms = _one_device(cfg, model)
    state = init_opt_state(opt, ms.shards)
    with pytest.raises(ValueError, match="5 rows"):
        make_train_step(cfg, opt, microbatches=2)(ms, state, batch)
    assert state["step"] == 0
    for n, p in ms.state_dict().items():
        assert torch.equal(p, before[n])


def test_resumed_step_matches_jax():
    """A step taken from a bridged JAX state (params after one JAX step
    and ``opt_state_from_jax`` of its optimizer state, step 1) equals the
    JAX package's second step (tolerances in ``_check_step``)."""
    jcfg, cfg, params, _ = _pair()
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jo = jopt.OptConfig(**opt.__dict__)
    jstep = jax.jit(jloop.make_train_step(jcfg, jo))
    jstate = {"params": params, "opt": jopt.init_opt_state(jo, params)}
    jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, _batch(cfg, step=0)))
    tree = jax.tree.map(np.asarray, jstate)
    model = T.init_model(cfg, device="cpu", params=params_from_jax(tree["params"], cfg, "cpu"))
    whole = opt_state_from_jax(tree["opt"], cfg, "cpu")
    assert whole["step"] == 1
    ms = _one_device(cfg, model)
    state = {k: v if k == "step" else {n: ms.cut(n, t) for n, t in v.items()} for k, v in whole.items()}
    batch = _batch(cfg, step=1)
    jgrads = _jax_grads(jcfg, cfg, jstate["params"], batch)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    m = make_train_step(cfg, opt)(ms, state, batch)
    model, state = _unsharded(ms, state)
    _check_step(cfg, opt, float(jm["lr"]), jgrads, jstate, jm, model, state, m)


def test_lr_schedule_matches_jax():
    """``lr_at`` over warm-up, cosine and past the end equals the JAX
    package's fp32 schedule to 2.4e-7 relative (2 ulp: the two cosines
    may round apart); and the reference's own
    contract (below 0.2 at step 0, ~1 after warm-up, <= 0.11 at the end)."""
    opt = OptConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    jo = jopt.OptConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    steps = list(range(0, 130, 3)) + [10, 110]
    got = np.array([lr_at(opt, s) for s in steps])
    want = np.array([float(jopt.lr_at(jo, jnp.asarray(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    assert lr_at(opt, 0) < 0.2 and abs(lr_at(opt, 10) - 1.0) < 0.1 and lr_at(opt, 110) <= 0.11


@pytest.mark.parametrize("source", ["synthetic", "text"])
def test_data_streams_equal_reference(source, tmp_path):
    """Exact: the same seed and step give the same batches in both
    packages, and labels are the next-token shift."""
    if source == "synthetic":
        a, b = data.SyntheticLM(300, 24, 3, seed=7), jdata.SyntheticLM(300, 24, 3, seed=7)
    else:
        p = tmp_path / "corpus.txt"
        p.write_bytes(b"a small corpus for the byte-level stream. " * 20)
        a, b = data.TextFileLM(str(p), 24, 3, seed=7), jdata.TextFileLM(str(p), 24, 3, seed=7)
    for step in (0, 5, 123):
        x, y = a.batch(step), b.batch(step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(x[key], y[key])
        np.testing.assert_array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert a.state() == b.state()
