"""``repro_torch.bench.lm_speedup --smoke --device cpu``: the port's twin of
``benchmarks/lm_speedup.py`` trains the JAX script's reduced config dense
and sparse for 2 warm-up and 3 timed steps each, writes its JSON, and its
parameter ratio equals that of the JAX script's two models (exact: counts
of parameters). The times are the CPU's and are not judged."""

import json

import jax
import numpy as np
import pytest
import torch

from benchmarks.lm_speedup import _cfg as jax_bench_cfg
from repro.models import transformer as JT
from repro_torch.bench import lm_speedup


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


def _jax_count(sparse):
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jax_bench_cfg(sparse)), jax.random.PRNGKey(0))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))


def test_smoke_run_writes_json_with_reference_param_ratio(tmp_path):
    out = tmp_path / "lm_speedup.json"
    lm_speedup.main(["--smoke", "--device", "cpu", "--steps", "3", "--out", str(out)])
    res = json.loads(out.read_text())
    assert (res["arch"], res["batch"], res["seq"], res["device"]) == ("gpt2-bench", 8, 128, "cpu")
    dense, sparse = res["dense"], res["sparse"]
    assert (dense["sparse"], sparse["sparse"]) == (False, True)
    for arm in (dense, sparse):
        assert len(arm["step_ms"]) == 3 and len(arm["loss"]) == 5  # 2 warm-up + 3 timed
        assert np.isfinite(arm["loss"]).all() and np.isfinite(arm["grad_norm"]).all()
        assert arm["loss_last5_mean"] == np.mean(arm["loss"][-5:])
        assert arm["device_trace"] is None and arm["max_memory_allocated_gb"] is None
    assert (dense["parameters"], sparse["parameters"]) == (_jax_count(False), _jax_count(True))
    assert res["param_ratio"] == _jax_count(True) / _jax_count(False) < 1
    assert res["speedup"] == dense["step_ms_median"] / sparse["step_ms_median"] > 0
