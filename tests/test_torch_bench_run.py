"""The port's benchmark harness (``repro_torch.bench.run``, the twin of
``benchmarks/run.py``), its roofline report and the analysis report, and
the training example (``repro_torch.examples.train_lm``, the twin of
``examples/train_lm.py``), on the CPU.

The harness has the JAX harness's suite names and CSV header, ``--only``
and ``--json``, and exits 1 when a suite fails; without a dry-run sweep
the roofline suite emits the JAX script's ``roofline/missing`` row. The
example's ``--smoke`` losses equal a JAX ``Trainer`` built with the JAX
example's config, data and ``OptConfig`` on ``make_tp_mesh(1)`` (the JAX
example's own ``main`` uses ``make_local_mesh``, which fails on jax 0.9),
from the same weights through the bridge: within 1e-5 (rtol = atol), the
tolerance of the one-step parity tests of ``test_torch_training.py``."""

import ast
import json
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.training.data import SyntheticLM as JSyntheticLM
from repro.training.loop import TrainConfig as JTrainConfig
from repro.training.loop import Trainer as JTrainer
from repro.training.optimizer import OptConfig as JOptConfig
from repro_torch.analysis import report
from repro_torch.bench import roofline_report
from repro_torch.bench import run as bench_run
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.examples import train_lm

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_suite_names() -> list[str]:
    """The keys of the ``suites`` dict in ``benchmarks/run.py``, in order."""
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "suites":
            return [k.value for k in node.value.keys]
    raise AssertionError("no suites dict in benchmarks/run.py")


def test_suite_names_equal_the_jax_harness():
    assert list(bench_run.SUITES) == _jax_suite_names()


def test_only_roofline_emits_the_missing_row(capsys):
    assert bench_run.main(["--only", "roofline"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert len(out) == 2 and out[1].startswith("roofline/missing,0.0,run the dry-run sweep first")


def test_csv_rows_and_json_records(capsys, tmp_path):
    """A CPU-sized suite at its smoke size: every row has three fields,
    the suite's own report goes to standard error, and its JSON record
    lands under --json."""
    rc = bench_run.main(["--only", "flat_vs_product", "--smoke", "--device", "cpu", "--json", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1:] and all(r.startswith("flat_vs_product/k=") and r.count(",") == 2 for r in out[1:])
    assert all(float(r.split(",")[1]) > 0 and "speedup=" in r for r in out[1:])
    rec = json.loads((tmp_path / "flat_vs_product.json").read_text())
    assert len(rec["rows"]) == len(out) - 1


def test_a_failing_suite_exits_1(capsys, monkeypatch):
    def boom(smoke, device, out):
        raise RuntimeError("boom")

    monkeypatch.setitem(bench_run.SUITES, "roofline", boom)
    assert bench_run.main(["--only", "roofline"]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == "roofline,0.0,FAILED"


def test_roofline_report_rows_and_render(tmp_path):
    """With a sweep file: the JAX script's rows and the analysis
    report's table, for an ok row and a failed one."""
    rows = [
        {"ok": True, "arch": "qwen3-1.7b", "shape": "decode_32k", "mesh": "16x16", "strategy": "tp",
         "compile_s": 12.5, "bytes_per_device": 3.2e9, "compute_s": 0.0012, "memory_s": 0.0034,
         "collective_s": 0.0005, "bottleneck": "memory", "useful_flops_ratio": 0.812},
        {"ok": False, "arch": "kimi-k2-1t-a32b", "shape": "train_4k", "multi_pod": True, "error": "OOM"},
    ]
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(rows))
    got = roofline_report.rows(path)
    assert got[0] == ("roofline/qwen3-1.7b/decode_32k/16x16", 1200.0,
                      "mem_ms=3.4;coll_ms=0.5;bottleneck=memory;useful=0.812;temp_gb=3.2")
    assert got[1] == ("roofline/kimi-k2-1t-a32b/train_4k/True", 0.0, "FAILED:OOM")
    table = report.render(str(path)).splitlines()
    assert table[0].startswith("| arch | shape | mesh |") and len(table) == 4
    assert table[2] == "| qwen3-1.7b | decode_32k | 16x16 | tp | 12.5 | 3.2 | 1.2 | 3 | 0 | memory | 0.81 |"
    assert "FAILED" in table[3] and "2x16x16" in table[3]
    assert roofline_report.rows(tmp_path / "absent.json")[0][0] == "roofline/missing"


def test_train_lm_smoke_equals_jax_trainer(capsys):
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=2, vocab_size=256)
    jt = JTrainer(jcfg, JOptConfig(lr=3e-3, warmup_steps=10, total_steps=2), JSyntheticLM(256, 32, 4, seed=0),
                  make_tp_mesh(1), JTrainConfig(steps=2, ckpt_dir=tempfile.mkdtemp(), ckpt_every=50, log_every=20))
    tree = jax.tree.map(np.asarray, jt.state["params"])
    want = jt.run()
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=2, vocab_size=256)
    got = train_lm.main(["--smoke", "--device", "cpu"], params=params_from_jax(tree, cfg, "cpu"))
    assert len(got) == len(want) == 2
    for key in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in got], [h[key] for h in want], rtol=1e-5, atol=1e-5)
    assert "in 2 steps; checkpoints in" in capsys.readouterr().out
