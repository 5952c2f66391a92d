"""The port's paged decode reads (plain version, the CPU path of ``ops``)
and ``paged_sparse_schedule`` against the JAX package's gather paths and
its Pallas kernel in interpret mode.

The scenario matrix is the JAX suite's: GQA ratios, ragged positions
(partial last pages), a partially allocated row, an idle slot on the trash
page, and a trash page poisoned with huge values so any masking divergence
is loud. Tolerances: 1e-5 in float32, 1e-2 in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

PAGE, PPS, D = 8, 4, 16  # page size, pages per slot, head dim
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _scenario(b, hk, g, *, seed=0, dtype="float32", trash_slot=True,
              partial_slot=True):
    rng = np.random.default_rng(seed)
    n_pages = b * PPS + 1
    k = rng.standard_normal((n_pages, PAGE, hk, D))
    v = rng.standard_normal((n_pages, PAGE, hk, D))
    k[0] = 1e4  # poisoned trash page
    v[0] = -1e4
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, PPS), np.int32)
    pos = np.zeros((b,), np.int32)
    nxt = 0
    for s in range(b):
        n_alloc = 1 if (partial_slot and s == b - 1 and b > 1) else PPS
        table[s, :n_alloc] = perm[nxt:nxt + n_alloc]
        nxt += n_alloc
        pos[s] = int(rng.integers(0, n_alloc * PAGE))
    if trash_slot and b > 2:
        table[1] = 0  # idle slot: all-trash row, position 0
        pos[1] = 0
    q = rng.standard_normal((b, 1, hk, g, D))
    jarrs = [jnp.asarray(a, dtype) for a in (q, k, v)]
    tdt = getattr(torch, dtype)
    tarrs = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in jarrs]
    return (
        (*jarrs, jnp.asarray(table), jnp.asarray(pos)),
        (*tarrs, torch.from_numpy(table), torch.from_numpy(pos)),
    )


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("local,glob", [(2, 1), (1, 0), (3, 2)])
def test_schedule_equals_reference_exactly(seed, local, glob):
    rng = np.random.default_rng(seed)
    b, pps, page = 6, 8, 4
    table = rng.integers(1, 40, size=(b, pps)).astype(np.int32)
    pos = rng.integers(0, pps * page, b).astype(np.int32)
    want = JL.paged_sparse_schedule(
        jnp.asarray(table), jnp.asarray(pos), page,
        local_blocks=local, global_blocks=glob,
    )
    got = L.paged_sparse_schedule(
        torch.from_numpy(table), torch.from_numpy(pos), page,
        local_blocks=local, global_blocks=glob,
    )
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_).astype(np.int32))


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", [None, "interpret"])
def test_dense_paged_read(g, dtype, impl):
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _scenario(4, 2, g, dtype=dtype)
    want = JL.paged_decode_attention_jnp(jq, jk, jv, jt, jp, sm_scale=D ** -0.5, impl=impl)
    got = L.paged_decode_attention(tq, tk, tv, tt, tp, sm_scale=D ** -0.5)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", [None, "interpret"])
def test_sparse_paged_read(g, dtype, impl):
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _scenario(4, 2, g, dtype=dtype)
    kw = dict(sm_scale=D ** -0.5, local_blocks=2, global_blocks=1)
    want = JL.paged_sparse_decode_attention_jnp(jq, jk, jv, jt, jp, impl=impl, **kw)
    got = L.paged_sparse_decode_attention(tq, tk, tv, tt, tp, **kw)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sparse_read_random_schedules(seed):
    rng = np.random.default_rng(seed)
    b, g = int(rng.integers(2, 5)), int(rng.integers(1, 3))
    kw = dict(
        sm_scale=D ** -0.5,
        local_blocks=int(rng.integers(1, 3)),
        global_blocks=int(rng.integers(0, 2)),
    )
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _scenario(b, 2, g, seed=seed + 10)
    want = JL.paged_sparse_decode_attention_jnp(jq, jk, jv, jt, jp, impl="interpret", **kw)
    _close(L.paged_sparse_decode_attention(tq, tk, tv, tt, tp, **kw), want, 1e-5)


def test_trash_page_slot_is_benign():
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _scenario(4, 2, 1)
    kw = dict(sm_scale=D ** -0.5, local_blocks=2, global_blocks=1)
    got = L.paged_sparse_decode_attention(tq, tk, tv, tt, tp, **kw)
    assert torch.isfinite(got).all()
    want = JL.paged_sparse_decode_attention_jnp(jq, jk, jv, jt, jp, **kw)
    _close(got, want, 1e-5)
