"""The port's BSR matmul (plain version, the CPU path of ``ops``) against
the JAX package's gather oracle and its Pallas kernel in interpret mode.

Inputs come from numpy with a fixed seed and go to both sides. Tolerances
are the JAX suite's: 1e-4 in float32, 2e-2 in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import butterfly as bf
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_matmul import bsr_matmul_cuda

CASES = [
    # (batch, n_in, n_out, block, max_stride): r = 1 + log2(max_stride)
    pytest.param((8, 256, 256, 64, 1), id="r1-b64"),
    pytest.param((16, 512, 512, 128, 2), id="r2-b128"),
    pytest.param((7, 512, 512, 128, 4), id="r3-b128-ragged"),
    pytest.param((8, 256, 512, 64, 4), id="r3-b64-rect"),
    pytest.param((4, 256, 1024, 128, 8), id="stretched-repeat-cols"),
    pytest.param((5, 128, 160, 32, 4), id="r3-b32-ragged"),
    pytest.param((17, 256, 128, 16, 8), id="r4-b16-rect"),
    pytest.param((9, 64, 40, 8, 4), id="r3-b8-odd-nb-out"),
    pytest.param((3, 32, 256, 32, 8), id="b32-stretched-repeat-cols"),
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _mk(case, dtype, seed=0):
    m, n_in, n_out, blk, k = case
    rng = np.random.default_rng(seed)
    pat = bf.make_pattern(n_out, n_in, block=blk, max_stride=k)
    blocks = rng.standard_normal((pat.nb_out, pat.r, blk, blk)) / np.sqrt(pat.r * blk)
    x = rng.standard_normal((m, n_in))
    jx, jb = jnp.asarray(x, dtype), jnp.asarray(blocks, dtype)
    tdt = getattr(torch, dtype)
    # hand torch the same (rounded) values JAX holds
    tx = torch.from_numpy(np.array(jx, np.float32)).to(tdt)
    tb = torch.from_numpy(np.array(jb, np.float32)).to(tdt)
    return (jx, jb, jnp.asarray(pat.cols)), (tx, tb, torch.from_numpy(pat.cols))


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def test_pattern_tables_match_reference():
    for n_out, n_in, blk, k in [(2048, 2048, 128, 2), (6144, 2048, 128, 2),
                                (2048, 6144, 128, 64), (1024, 256, 128, 8)]:
        a = bf.make_pattern(n_out, n_in, block=blk, max_stride=k)
        b = jbf.make_pattern(n_out, n_in, block=blk, max_stride=k)
        assert a.max_stride == b.max_stride
        np.testing.assert_array_equal(a.cols, b.cols)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_gather(case, dtype):
    (jx, jb, jc), (tx, tb, tc) = _mk(case, dtype)
    _close(ops.bsr_matmul(tx, tb, tc), jref.bsr_matmul_gather(jx, jb, jc), TOL[dtype])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(case, dtype):
    (jx, jb, jc), (tx, tb, tc) = _mk(case, dtype)
    want = jops.bsr_matmul(jx, jb, jc, impl="interpret")
    _close(ref.bsr_matmul_gather(tx, tb, tc), want, TOL[dtype])


@pytest.mark.parametrize("case", CASES)
def test_dense_mask_and_to_dense_match_reference(case):
    (jx, jb, jc), (tx, tb, tc) = _mk(case, "float32")
    _close(ref.bsr_matmul_dense_mask(tx, tb, tc), jref.bsr_matmul_dense_mask(jx, jb, jc), 1e-4)
    n_in = case[1]
    _close(ref.bsr_to_dense(tb, tc, n_in), jref.bsr_to_dense(jb, jc, n_in), 1e-6)


def test_repeated_cols_sum():
    """A stretched pattern repeats a column block within a row; both
    slots count (gather == dense mask)."""
    (_, _, _), (tx, tb, tc) = _mk((4, 256, 1024, 128, 8), "float32")
    assert any(len(set(row)) < len(row) for row in tc.tolist())
    _close(ref.bsr_matmul_gather(tx, tb, tc), ref.bsr_matmul_dense_mask(tx, tb, tc).numpy(), 1e-4)


def test_leading_dims_flattened():
    (_, _, _), (tx, tb, tc) = _mk((8, 256, 256, 64, 2), "float32")
    y3 = ops.bsr_matmul(tx.reshape(2, 4, 256), tb, tc)
    assert y3.shape == (2, 4, 256)
    _close(y3.reshape(8, -1), ops.bsr_matmul(tx, tb, tc).numpy(), 1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    (_, _, _), (tx, tb, tc) = _mk((8, 256, 256, 64, 2), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        bsr_matmul_cuda(tx, tb, tc)
