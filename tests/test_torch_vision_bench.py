"""The port's twins of the paper's other benchmarks and examples
(``repro_torch.bench.{vision_speedup,flat_vs_product,block_microbench,
lra_attention,ntk_distance}``, ``repro_torch.examples``) on the CPU
against the JAX scripts in ``benchmarks/`` and ``examples/``.

What transfers from a CPU run is what the scripts derive, not their
times: the parameter ratio of each vision arm (exact), the block
microbenchmark's densities (the script's printed values, exact), the NTK
distances (within 1e-5: fp32 products in another order), the LRA arms'
outputs at S = 256 (rtol = atol = 2e-4, the attention tolerance of
``tests/test_torch_kernels_attention.py``) and its keys per query, and
the flat-vs-product inputs (factors equal bit for bit) and outputs
(1e-4). Each twin's ``main`` also runs end to end at ``--smoke``."""

import contextlib
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the JAX scripts in benchmarks/

from benchmarks import block_microbench as jmicro  # noqa: E402
from benchmarks import ntk_distance as jntk  # noqa: E402
from repro.core import attn_pattern as jap  # noqa: E402
from repro.core import butterfly as jbf  # noqa: E402
from repro.core.pixelfly import LinearSpec as JSpec  # noqa: E402
from repro.core.pixelfly import param_count as jparam_count  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import vision as JV  # noqa: E402
from repro_torch.bench import block_microbench, flat_vs_product, lra_attention, ntk_distance  # noqa: E402
from repro_torch.bench import vision_speedup  # noqa: E402
from repro_torch.examples import quickstart, sparsity_ablation  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(kind, sparse):
    """Parameter count of the JAX script's config, from shapes alone."""
    cfg = JV.VisionConfig(
        kind=kind, num_layers=4, d_model=256, num_heads=4, d_ff=1024, num_patches=64,
        num_classes=100, patch_dim=192, token_ff=128, sparse=sparse, sparse_density=0.15, sparse_block=32,
    )
    init = {"vit": JV.init_vit, "mixer": JV.init_mixer}[kind]
    return sum(np.prod(x.shape) for x in jax.tree.leaves(jax.eval_shape(lambda key: init(key, cfg), jax.random.PRNGKey(0))))


def test_vision_speedup_smoke_param_ratio_equals_jax(tmp_path):
    res = vision_speedup.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "vs.json")])
    for kind in ("mixer", "vit"):
        r = res[kind]
        dense, sparse = _jax_params(kind, False), _jax_params(kind, True)
        assert (r["dense"]["parameters"], r["sparse"]["parameters"]) == (dense, sparse)
        assert r["param_ratio"] == sparse / dense
        assert r["width"] == "bench" and r["device"] == "cpu"
        assert all(np.isfinite(r[arm]["loss"]).all() for arm in ("dense", "sparse"))
        assert r["sparse"]["sparse_linears"] > 0 and r["sparse"]["bsr_matmul_launches_per_step"] == 0
        assert (tmp_path / f"vs_{kind}.json").exists()


def test_vision_b16_configs_are_the_published_widths():
    for kind in ("vit", "mixer"):
        cfg = vision_speedup.b16_config(kind, True)
        assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_patches, cfg.patch_dim, cfg.num_classes) == (
            12, 768, 3072, 196, 768, 1000)
        assert (cfg.sparse_block, cfg.sparse_density, cfg.dtype) == (32, 0.15, "bfloat16")
    # ViT-B/16's sparse linears: qkv, proj, fc1, fc2 (nb_out, r, rank)
    for (din, dout), (nb_out, r, rank) in {(768, 2304): (72, 2, 32), (768, 768): (24, 1, 32),
                                           (768, 3072): (96, 2, 32), (3072, 768): (24, 8, 32)}.items():
        spec = vision_speedup.b16_config("vit", True).lin(din, dout)
        assert (spec.pattern().nb_out, spec.pattern().r, spec.rank) == (nb_out, r, rank)
    assert not vision_speedup.b16_config("mixer", True).lin(196, 384).sparse


def test_block_microbench_densities_equal_the_script(tmp_path):
    """The script's printed densities at n = 1024, and the port's rows."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jmicro.run(n=1024, hw_block=32, batch=32)
    want = [line for line in out.getvalue().splitlines() if "_density=" in line]
    rows = block_microbench.densities(1024, 32, np.random.default_rng(0))
    got = [f"block_microbench/{r['pattern']}/b={r['block']},0.0,expected_density={r['expected_density']:.4f}"
           f";actual_density={r['actual_density']:.4f}" for r in rows]
    assert got == want
    res = block_microbench.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "out.json")])
    assert [r["actual_density"] for r in res["densities"]] == [r["actual_density"] for r in rows]
    assert res["latency"]["bsr_ms"] > 0 and res["latency"]["r"] >= 1


def test_ntk_distances_equal_the_script(tmp_path):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((jntk.N, jntk.D)).astype(np.float32)
    w1 = (rng.standard_normal((jntk.D, jntk.H)) / np.sqrt(jntk.D)).astype(np.float32)
    w2 = (rng.standard_normal((jntk.H, 1)) / np.sqrt(jntk.H)).astype(np.float32)
    params = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    ones2 = jnp.ones((jntk.H, 1), jnp.float32)
    k_dense = jntk._ntk(jntk._masked_mlp(jnp.ones((jntk.D, jntk.H)), ones2), params, jnp.asarray(xs))
    nd = float(jnp.linalg.norm(k_dense))
    # the script's masks, built with the JAX package
    butterfly_mask = jbf.make_pattern(jntk.H, jntk.D, block=jntk.BLOCK, max_stride=4).dense_mask().T
    rank = max(1, int(butterfly_mask.mean() * jntk.D * jntk.H / (jntk.D + jntk.H) / 2))
    pf = np.clip(jbf.make_pattern(jntk.H, jntk.D, block=jntk.BLOCK, max_stride=2).dense_mask().T
                 + jntk._lowrank_mask(jntk.D, jntk.H, max(1, rank // 2)), 0, 1)
    want_masks = {"pixelfly(butterfly+lowrank)": pf, "butterfly_only": butterfly_mask,
                  "lowrank_only(global)": jntk._lowrank_mask(jntk.D, jntk.H, rank),
                  "random(magnitude-init)": (rng.random((jntk.D, jntk.H)) < butterfly_mask.mean()).astype(np.float32)}
    want = {name: float(jnp.linalg.norm(jntk._ntk(jntk._masked_mlp(jnp.asarray(m), ones2), params,
                                                  jnp.asarray(xs)) - k_dense)) / nd
            for name, m in want_masks.items()}
    got_masks = ntk_distance.masks(np.random.default_rng(0))
    for name in want_masks:
        if name != "random(magnitude-init)":  # drawn later in the run's stream
            np.testing.assert_array_equal(got_masks[name], want_masks[name])
    res = ntk_distance.main(["--device", "cpu", "--out", str(tmp_path / "out.json")])
    for name, v in want.items():
        assert abs(res["rel_ntk_dist"][name] - v) <= 1e-5, name
    assert res["closest_to_dense"] == min(want, key=want.get)


def test_lra_attention_outputs_equal_the_script_at_256(tmp_path):
    s, d = 256, lra_attention.D
    q, k, v = lra_attention.inputs(s, np.random.default_rng(0), CPU, torch.float32)
    mask, sched = lra_attention.schedule(s)
    cfg = jap.AttentionPatternConfig(block=128, local_blocks=1, max_stride=0, global_blocks=1)
    jmask = jap.pixelfly_attention_block_mask(s, s, cfg, causal=True)
    np.testing.assert_array_equal(mask, jmask)
    jsched = jap.block_schedule(jmask, 128, 128)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    want_dense = JL.flash_attention_jnp(jq, jk, jv, causal=True, chunk=512, sm_scale=d ** -0.5)
    want_sparse = JL.sparse_attention_jnp(jq, jk, jv, jsched, causal=True, sm_scale=d ** -0.5)
    got_dense = lra_attention.dense(q, k, v)
    got_sparse = lra_attention.sparse(q, k, v, torch.as_tensor(sched.kv_index), torch.as_tensor(sched.valid))
    np.testing.assert_allclose(got_dense.numpy(), np.asarray(want_dense), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_sparse.numpy(), np.asarray(want_sparse), rtol=2e-4, atol=2e-4)
    res = lra_attention.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "out.json")])
    assert res["rows"][0]["keys_per_query"] == jap.keys_per_query(jmask, 128, s)


def test_flat_vs_product_inputs_and_outputs_equal_the_script(tmp_path):
    n, block, batch = 512, 32, 8
    x, arms = flat_vs_product.inputs(n, block, batch, CPU)
    rng = np.random.default_rng(0)  # the script's draws, with the JAX package
    jx = rng.standard_normal((batch, n))
    nb = n // block
    assert [a[0] for a in arms] == [4, 16, nb]
    for k, factors, blocks, cols in arms:
        want_f = [np.eye(n) + 0.1 * jbf.butterfly_factor_matrix(nb, 2 * s // 1 if s > 1 else 2, rng, block=block)
                  for s in [1] + jbf.flat_butterfly_strides(k)]
        pat = jbf.make_pattern(n, n, block=block, max_stride=k)
        jb = rng.standard_normal((pat.nb_out, pat.r, block, block)) / np.sqrt(pat.r * block)
        for f, w in zip(factors, want_f):
            np.testing.assert_array_equal(f.numpy(), w.astype(np.float32))
        np.testing.assert_array_equal(cols.numpy(), pat.cols)
        want_p = jnp.asarray(jx, jnp.float32)
        for f in want_f:
            want_p = want_p @ jnp.asarray(f, jnp.float32)
        want_flat = jref.bsr_matmul_gather(jnp.asarray(jx, jnp.float32), jnp.asarray(jb, jnp.float32),
                                           jnp.asarray(pat.cols))
        np.testing.assert_allclose(flat_vs_product.product(x, factors).numpy(), np.asarray(want_p),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ops.bsr_matmul(x, blocks, cols).numpy(), np.asarray(want_flat),
                                   rtol=1e-4, atol=1e-4)
    res = flat_vs_product.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "out.json")])
    assert [r["factors"] for r in res["rows"]] == [3, 5, 5] and [r["r"] for r in res["rows"]] == [3, 5, 5]


def test_examples_run_at_smoke():
    res = quickstart.main(["--smoke", "--device", "cpu"])
    assert res["pixelfly"] == jparam_count(JSpec.pixelfly(1024, 4096, 0.15, block=128, dtype=jnp.float32))
    assert res["dense"] == 1024 * 4096 and res["finite"]
    rows = sparsity_ablation.main(["--smoke", "--device", "cpu"])
    assert len(rows) == 1 and np.isfinite(rows[0][2])
    cfg = sparsity_ablation.config(0.4, 0.25)
    assert cfg.sparse_block == 16 and cfg.attn_block == 64 and cfg.head_dim == 64
