"""The port's paged decode reads (plain version, the CPU path of ``ops``)
and ``paged_sparse_schedule`` against the JAX package's gather paths and
its Pallas kernel in interpret mode.

The scenario matrix is the JAX suite's: GQA ratios, ragged positions
(partial last pages), a partially allocated row, an idle slot on the trash
page, and a trash page poisoned with huge values so any masking divergence
is loud. Tolerances: 1e-5 in float32, 1e-2 in bfloat16.

The card's kernel splits each slot's schedule into one partial softmax per
schedule slot and combines them in schedule order; ``_split_combine``
repeats that algebra here, where the kernel cannot run, and is held against
the Pallas kernel in interpret mode and the JAX gather path.
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


@pytest.mark.parametrize("g", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", [None, "interpret"])
def test_dense_paged_read(g, dtype, impl):
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _scenario(4, 2, g, dtype=dtype)
    want = JL.paged_decode_attention_jnp(jq, jk, jv, jt, jp, sm_scale=D ** -0.5, impl=impl)
    got = L.paged_decode_attention(tq, tk, tv, tt, tp, sm_scale=D ** -0.5)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("g", [1, 2, 3, 4, 6])
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


def _split_combine(q, k, v, phys, logical, keep, pos, *, sm_scale, fold=8):
    """The CUDA kernel's two passes in float32 torch. Split: one partial
    (m, l, unnormalised acc) per (slot, kv head, schedule slot) over the
    visible keys of its page; a slot that is dropped (keep == 0) or whose
    page starts beyond pos leaves an empty partial (m = -inf, l = 0, and an
    acc of NaN that must never be read). Combine: the partials in schedule
    order, ``fold`` at a time, the running sums rescaled when a round
    raises the max; an empty partial weighs exactly 0; output acc / l with
    l == 0 -> 1. q (B, Hk, G, D); pools (n_pages, page, Hk, D); schedule
    (B, w)."""
    b, hk, g, d = q.shape
    page = k.shape[1]
    w = phys.shape[1]
    m = torch.full((b, hk, w, g), float("-inf"))
    l = torch.zeros((b, hk, w, g))
    acc = torch.full((b, hk, w, g, d), float("nan"))
    for bi in range(b):
        for t in range(w):
            base = int(logical[bi, t]) * page
            if int(keep[bi, t]) == 0 or base > int(pos[bi]):
                continue
            n_vis = min(page, int(pos[bi]) - base + 1)
            kp = k[int(phys[bi, t]), :n_vis].float()  # (n_vis, Hk, D)
            vp = v[int(phys[bi, t]), :n_vis].float()
            s = torch.einsum("hgd,khd->hgk", q[bi].float(), kp) * sm_scale
            m[bi, :, t] = s.amax(dim=-1)
            p = torch.exp(s - m[bi, :, t, :, None])
            l[bi, :, t] = p.sum(dim=-1)
            acc[bi, :, t] = torch.einsum("hgk,khd->hgd", p, vp)
    neg = float("-inf")
    mx = torch.full((b, hk, g), neg)
    out = torch.zeros((b, hk, g, d))
    total = torch.zeros((b, hk, g))
    for t0 in range(0, w, fold):
        mn = torch.maximum(mx, m[:, :, t0:t0 + fold].amax(dim=2))
        seen = (mx != neg) & (mn != neg)
        r = torch.exp((mx - mn).masked_fill(~seen, 0.0))
        out, total = out * r[..., None], total * r
        mx = mn
        for t in range(t0, min(t0 + fold, w)):
            live = m[:, :, t] != neg
            a = torch.exp((m[:, :, t] - mx).masked_fill(~live, 0.0)).masked_fill(~live, 0.0)
            out = out + torch.where(live[..., None], a[..., None] * acc[:, :, t], 0.0)
            total = total + a * l[:, :, t]
    return out / torch.where(total == 0, 1.0, total)[..., None]


@pytest.mark.parametrize("schedule", ["sparse", "dense"])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("impl", [None, "interpret"])
@pytest.mark.parametrize("fold", [8, 2])  # 2: several rounds, rescaled between
def test_split_combine_equals_reference(schedule, g, impl, fold):
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _scenario(4, 2, g)
    if schedule == "sparse":
        kw = dict(local_blocks=2, global_blocks=1)
        logical, phys, keep = L.paged_sparse_schedule(tt, tp, PAGE, **kw)
        want = JL.paged_sparse_decode_attention_jnp(
            jq, jk, jv, jt, jp, sm_scale=D ** -0.5, impl=impl, **kw)
        assert (keep == 0).any()  # XOR duplicates dropped: empty partials
    else:
        logical, phys, keep = L.paged_dense_schedule(tt)
        want = JL.paged_decode_attention_jnp(jq, jk, jv, jt, jp, sm_scale=D ** -0.5, impl=impl)
        assert (logical * PAGE > tp[:, None]).any()  # pages beyond pos: empty partials
    # the scenario holds an idle slot on the trash page and a partial row
    assert (tt[1] == 0).all() and (tt[-1, 1:] == 0).all()
    got = _split_combine(tq[:, 0], tk, tv, phys, logical, keep, tp, sm_scale=D ** -0.5, fold=fold)
    assert torch.isfinite(got).all()
    _close(got[:, None], want, 1e-5)
