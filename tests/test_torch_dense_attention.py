"""The port's dense causal attention (``layers.flash_attention``, the
chunked online softmax that the CPU and fp32 on the card run) against the
JAX package's ``flash_attention_jnp``, on the same numpy-seeded inputs:
GQA groups 1, 3 and 6, Sk a whole number of chunks and Sk = 140 with
chunk 128 (the reference pads the keys to a chunk and masks the padding).
Tolerances: 2e-5 in float32 (both sum the same products in fp32, in
another order); 2e-2 in bfloat16, where both round q, P and the output to
bf16 at the same points but an exp that differs in its last bit may round
P or the output one bf16 ulp apart. Gradients in float32 within 2e-5 of
``jax.grad``. No (Sq, Sk) tensor is made along the way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import layers as JL
from repro_torch.models import layers as L

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CASES = [  # (S, chunk): one chunk, several chunks, a padded last chunk
    (64, 128),
    (256, 64),
    (140, 128),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several workers
    on a few cores, where torch's default pool (one thread a core) spins
    against the other workers; results only move in the last bits, inside
    every tolerance here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(s, g, dtype, seed=0, b=2, hk=2, d=32):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hk, g, d), (b, s, hk, d), (b, s, hk, d))]
    return (
        [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
        [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs],
    )


@pytest.mark.parametrize("s,chunk", CASES)
@pytest.mark.parametrize("g", [1, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_flash_jnp(s, chunk, g, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(s, g, dtype, seed=g + s)
    scale = tq.shape[-1] ** -0.5
    want = JL.flash_attention_jnp(jq, jk, jv, causal=True, chunk=chunk, sm_scale=scale)
    got = L.flash_attention(tq, tk, tv, sm_scale=scale, chunk=chunk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("s,chunk", [(140, 128), (256, 64)])
def test_chunked_attention_grads_match_jax(s, chunk):
    """dq, dk, dv of a seeded cotangent through the chunks (each
    recomputed in the backward) against ``jax.grad``; fp32, G = 3."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(s, 3, "float32", seed=7)
    do = np.random.default_rng(8).standard_normal(tq.shape).astype(np.float32)
    scale = tq.shape[-1] ** -0.5
    want = jax.grad(
        lambda q, k, v: jnp.sum(JL.flash_attention_jnp(q, k, v, causal=True, chunk=chunk, sm_scale=scale) * do),
        argnums=(0, 1, 2),
    )(jq, jk, jv)
    ts = [t.requires_grad_() for t in (tq, tk, tv)]
    out = L.flash_attention(*ts, sm_scale=scale, chunk=chunk)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


class _Largest(TorchDispatchMode):
    """Records the largest tensor any operation returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("grad", [False, True])
def test_no_score_matrix_is_held(grad):
    """At Sq = Sk = 512 with chunks of 64, no operation of the forward or
    the backward returns a tensor of B·H·Sq·Sk elements or more: the
    largest is a chunk's (B, Hk, G, Sq, 64) scores."""
    b, s, hk, g, chunk = 1, 512, 2, 3, 64
    _, (tq, tk, tv) = _inputs(s, g, "float32", b=b, hk=hk)
    ts = [t.requires_grad_(grad) for t in (tq, tk, tv)]
    with _Largest() as mode:
        out = L.flash_attention(*ts, sm_scale=0.2, chunk=chunk)
        if grad:
            torch.autograd.grad(out.sum(), ts)
    assert mode.numel == b * hk * g * s * chunk
