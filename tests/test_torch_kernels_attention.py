"""The port's block-sparse prefill attention (plain version, the CPU path
of ``ops``) against the JAX package's oracle, its Pallas kernel in
interpret mode and, with GQA, ``sparse_attention_jnp``. Tolerance 2e-4 in
float32; 2e-2 in bfloat16, where both sides round the same bf16 inputs but
round P and the output at their own points (the plain version, which the
card's bf16 kernel is held against, normalises P before its bf16 cast; the
Pallas kernel casts unnormalised P)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attn_pattern as jap
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.core import attn_pattern as ap
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

TOL = 2e-4
DTYPES = [("float32", TOL), ("bfloat16", 2e-2)]
SHAPES = [
    # (B, H, S, D, block)
    (2, 2, 256, 64, 64),
    (1, 4, 512, 64, 128),
    (2, 1, 512, 128, 128),
]


def _arrays(shapes, seed=0, dtype="float32"):
    """The same seeded values for both frameworks, rounded to ``dtype``
    (round to nearest even on both sides)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return (
        [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
        [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs],
    )


def _schedule(s, blk, local=1, glob=1, causal=True):
    cfg = ap.AttentionPatternConfig(block=blk, local_blocks=local, global_blocks=glob)
    mask = ap.pixelfly_attention_block_mask(s, s, cfg, causal=causal)
    jmask = jap.pixelfly_attention_block_mask(
        s, s, jap.AttentionPatternConfig(block=blk, local_blocks=local, global_blocks=glob),
        causal=causal,
    )
    np.testing.assert_array_equal(mask, jmask)
    sched = ap.block_schedule(mask, blk, blk)
    jsched = jap.block_schedule(jmask, blk, blk)
    np.testing.assert_array_equal(sched.kv_index, jsched.kv_index)
    np.testing.assert_array_equal(sched.valid, jsched.valid)
    return mask, sched, jsched


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, dtype=np.float32), rtol=tol, atol=tol
    )


def _port(q, k, v, sched, blk, causal, g=1):
    """(B, H, S, D) q and (B, Hk, S, D) k/v through the port's grouped
    layout; returns (B, H, S, D)."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    o = ops.block_sparse_attention(
        q.transpose(1, 2).reshape(b, s, hk, g, d),
        k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        torch.from_numpy(sched.kv_index), torch.from_numpy(sched.valid),
        block=blk, causal=causal, sm_scale=d ** -0.5,
    )
    return o.reshape(b, s, h, d).transpose(1, 2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_plain_matches_oracle_and_interpret(shape, causal, dtype, tol):
    b, h, s, d, blk = shape
    mask, sched, jsched = _schedule(s, blk, causal=causal)
    (jq, jk, jv), (tq, tk, tv) = _arrays([(b, h, s, d)] * 3, dtype=dtype)
    got = _port(tq, tk, tv, sched, blk, causal)
    assert got.dtype == getattr(torch, dtype)
    _close(got, jref.block_sparse_attention_ref(jq, jk, jv, mask, block_q=blk, block_k=blk, causal=causal), tol)
    _close(got, jops.block_sparse_attention(jq, jk, jv, jsched, causal=causal, impl="interpret"), tol)


@pytest.mark.parametrize("g", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_gqa_matches_sparse_attention_jnp(g, dtype, tol):
    """The grouped layout at every GQA group of the dense-family configs
    (3: smollm-360m, 6: qwen2-1.5b, 8: deepseek-67b) against
    ``sparse_attention_jnp`` and the Pallas kernel in interpret mode, the
    latter on K/V repeated to every query head (query head h = hk * G + g
    reads kv head hk)."""
    b, hk, s, d, blk = 2, 2, 512, 64, 128
    _, sched, jsched = _schedule(s, blk, local=2, glob=1)
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        [(b, s, hk, g, d), (b, s, hk, d), (b, s, hk, d)], seed=3, dtype=dtype
    )
    want = JL.sparse_attention_jnp(jq, jk, jv, jsched, causal=True, sm_scale=d ** -0.5)
    got = ops.block_sparse_attention(
        tq, tk, tv, torch.from_numpy(sched.kv_index), torch.from_numpy(sched.valid),
        block=blk, causal=True, sm_scale=d ** -0.5,
    )
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol)
    heads = lambda a: a.reshape(b, s, hk * g, d).transpose(0, 2, 1, 3)  # (B, H, S, D)
    rep = lambda a: heads(jnp.repeat(a[:, :, :, None], g, axis=3))
    pallas = jops.block_sparse_attention(heads(jq), rep(jk), rep(jv), jsched, causal=True, impl="interpret")
    _close(got, pallas.transpose(0, 2, 1, 3).reshape(b, s, hk, g, d), tol)


def test_full_mask_equals_dense():
    b, h, s, d, blk = 2, 2, 256, 64, 64
    mask = np.ones((s // blk, s // blk), bool)
    sched = ap.block_schedule(mask, blk, blk)
    (jq, jk, jv), (tq, tk, tv) = _arrays([(b, h, s, d)] * 3, seed=1)
    _close(_port(tq, tk, tv, sched, blk, True), jref.dense_attention_ref(jq, jk, jv, causal=True))
    _close(ref.dense_attention_ref(tq, tk, tv, causal=True), jref.dense_attention_ref(jq, jk, jv, causal=True))


def test_block_sparse_ref_matches_reference():
    b, h, s, d, blk = 1, 2, 256, 64, 64
    mask, _, _ = _schedule(s, blk, local=2)
    (jq, jk, jv), (tq, tk, tv) = _arrays([(b, h, s, d)] * 3, seed=2)
    _close(
        ref.block_sparse_attention_ref(tq, tk, tv, mask, block_q=blk, block_k=blk, causal=True),
        jref.block_sparse_attention_ref(jq, jk, jv, mask, block_q=blk, block_k=blk, causal=True),
    )


@pytest.mark.parametrize("s", [64, 200])
def test_dense_prefill_branch_matches_flash_jnp(s):
    hk, g, d = 2, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _arrays([(2, s, hk, g, d), (2, s, hk, d), (2, s, hk, d)], seed=4)
    want = JL.flash_attention_jnp(jq, jk, jv, causal=True, chunk=128, sm_scale=d ** -0.5)
    _close(L.flash_attention(tq, tk, tv, sm_scale=d ** -0.5, chunk=128), want, 2e-5)
