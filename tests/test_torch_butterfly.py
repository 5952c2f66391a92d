"""The port's numpy copies of the JAX package's butterfly and budget
helpers (``repro_torch.core.butterfly``, ``repro_torch.core.budget``)
against the originals: arrays equal bit for bit from the same numpy seed,
``allocate`` and ``solve_two_type_closed_form`` within 1e-12."""

import numpy as np
import pytest
import torch

from repro.core import budget as jbudget
from repro.core import butterfly as jbf
from repro_torch.core import budget
from repro_torch.core import butterfly as bf

PATTERNS = [(2048, 2048, 128, 2), (2304, 768, 32, 2), (768, 3072, 32, 8), (1024, 256, 128, 8),
            (384, 384, 16, 4), (256, 64, 8, 4)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_out,n_in,b,k", PATTERNS)
def test_pattern_density_and_dense_mask(n_out, n_in, b, k):
    a, w = bf.make_pattern(n_out, n_in, block=b, max_stride=k), jbf.make_pattern(n_out, n_in, block=b, max_stride=k)
    assert a.density == w.density
    np.testing.assert_array_equal(a.dense_mask(), w.dense_mask())
    np.testing.assert_array_equal(
        bf.dense_mask_from_cols(a.nb_out, a.nb_in, a.cols, b), jbf.dense_mask_from_cols(w.nb_out, w.nb_in, w.cols, b))
    assert bf.density_for_max_stride(a.nb_in, k, b, n_in) == jbf.density_for_max_stride(w.nb_in, k, b, n_in)


@pytest.mark.parametrize("blk,hw", [(1, 32), (4, 32), (8, 16), (32, 32), (16, 8)])
def test_block_cover(blk, hw):
    rng = np.random.default_rng(blk * hw)
    keep = rng.random((256 // blk, 256 // blk)) < 0.05
    mask = np.repeat(np.repeat(keep, blk, 0), blk, 1).astype(np.float32)
    np.testing.assert_array_equal(bf.block_cover(mask, hw, hw), jbf.block_cover(mask, hw, hw))
    np.testing.assert_array_equal(bf.block_cover(mask, hw, 2 * hw), jbf.block_cover(mask, hw, 2 * hw))
    assert bf.block_cover_density(mask, hw) == jbf.block_cover_density(mask, hw)
    with pytest.raises(ValueError):
        bf.block_cover(mask, 3, 3)


@pytest.mark.parametrize("n,k,block", [(8, 2, 1), (16, 4, 4), (32, 32, 32), (32, 8, 2)])
def test_butterfly_factor_matrix(n, k, block):
    a = bf.butterfly_factor_matrix(n, k, np.random.default_rng(3), block=block)
    w = jbf.butterfly_factor_matrix(n, k, np.random.default_rng(3), block=block)
    np.testing.assert_array_equal(a, w)
    with pytest.raises(ValueError):
        bf.butterfly_factor_matrix(n, 1, np.random.default_rng(0))


SCHEMA = [("attn_proj", 12, 768, 768, 197), ("mlp_up", 12, 3072, 768, 197), ("mlp_down", 12, 768, 3072, 197),
          ("qkv", 28, 2048, 2048, 2048)]


@pytest.mark.parametrize("density,block,frac", [(0.15, 32, 0.25), (0.2, 128, 0.25), (0.4, 16, 0.0),
                                                (0.8, 64, 0.5)])
def test_allocate_and_dense_flops(density, block, frac):
    ours = [budget.LayerSchema(*row) for row in SCHEMA]
    theirs = [jbudget.LayerSchema(*row) for row in SCHEMA]
    assert abs(budget.dense_flops(ours) - jbudget.dense_flops(theirs)) <= 1e-12 * jbudget.dense_flops(theirs)
    a = budget.allocate(ours, density, block=block, lowrank_frac=frac)
    w = jbudget.allocate(theirs, density, block=block, lowrank_frac=frac)
    assert a.keys() == w.keys()
    for kind in a:
        x, y = a[kind], w[kind]
        assert (x.kind, x.lowrank_rank, x.max_stride, x.block) == (y.kind, y.lowrank_rank, y.max_stride, y.block)
        assert abs(x.density - y.density) <= 1e-12


@pytest.mark.parametrize("s,d,budget_params", [(197, 768, 1e6), (1024, 768, 4e6), (64, 768, 1e8),
                                               (4096, 256, 3e5), (16, 1024, 2e6)])
def test_solve_two_type_closed_form(s, d, budget_params):
    a = budget.solve_two_type_closed_form(s, d, budget_params)
    w = jbudget.solve_two_type_closed_form(s, d, budget_params)
    assert all(abs(x - y) <= 1e-12 for x, y in zip(a, w))
