"""The port's ``Trainer``, checkpoints and launcher on the CPU, held to the
contracts that the JAX package's ``tests/test_training.py`` and
``tests/test_checkpoint.py`` state (convergence, exact resume, preemption,
the straggler hook, compressed gradients, integrity, retention), and the
serving path's promise to build no autograd graph now that every
parameter is trainable. Smoke width, fp32, 2 layers, a 64-token vocab."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.training import checkpoint as ck
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import TrainConfig, Trainer
from repro_torch.training.optimizer import OptConfig


def _trainer(path, steps=30, compress=False, data=None):
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=2, vocab_size=64)
    opt = OptConfig(lr=1e-2, warmup_steps=2, total_steps=steps, compress_grads=compress)
    return Trainer(
        cfg, opt, data or SyntheticLM(64, 64, 4, seed=0),
        TrainConfig(steps=steps, ckpt_dir=str(path), ckpt_every=10, log_every=1000),
        device="cpu",
    )


def _falls(hist, by):
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - by, (first, last)


def test_loss_decreases(tmp_path):
    """30 steps: the mean loss of the last 5 is 0.2 below the first 5's."""
    _falls(_trainer(tmp_path).run(), 0.2)


def test_compressed_grads_still_converge(tmp_path):
    """With int8 error-feedback compression: 0.15 below."""
    _falls(_trainer(tmp_path, compress=True).run(), 0.15)


def test_checkpoint_resume_exact(tmp_path):
    """4 steps, a checkpoint, a new Trainer on the same directory, then 2
    steps: the losses and every parameter and moment equal those of 6
    uninterrupted steps, bit for bit."""
    t1 = _trainer(tmp_path, steps=20)
    t1.run(4)
    t1.checkpoint()
    cont = t1.run(2)
    t2 = _trainer(tmp_path, steps=20)
    assert t2.step == 4
    resumed = t2.run(2)
    assert [h["loss"] for h in cont] == [h["loss"] for h in resumed]
    a, b = t1.state(), t2.state()
    for name, p in a["params"].items():
        assert torch.equal(p, b["params"][name]), name
        assert torch.equal(a["opt"]["mu"][name], b["opt"]["mu"][name]), name
    assert t1.opt["step"] == t2.opt["step"] == 6


def test_preemption_flag_checkpoints_and_stops(tmp_path):
    t = _trainer(tmp_path, steps=50)
    t.run(3)
    t._on_preempt(signal.SIGTERM, None)
    assert t.run(10) == []  # stops at once and checkpoints
    assert ck.latest_step(str(tmp_path)) == 3


class _SigtermAt:
    """A data source that sends this process SIGTERM while it makes the
    batch of step ``at``."""

    def __init__(self, inner, at):
        self.inner, self.at = inner, at

    def batch(self, step):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.inner.batch(step)

    def state(self):
        return self.inner.state()


def test_sigterm_during_run_checkpoints_at_the_next_step(tmp_path):
    """A real SIGTERM during step 3 lets that step finish; the next one
    checkpoints (step 3) and returns; the previous handler is back after."""
    before = signal.getsignal(signal.SIGTERM)
    t = _trainer(tmp_path, steps=10, data=_SigtermAt(SyntheticLM(64, 64, 4, seed=0), at=2))
    hist = t.run()
    assert len(hist) == 3 and t.step == 3
    assert ck.latest_step(str(tmp_path)) == 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_straggler_watchdog_fires_hook(tmp_path):
    events = []
    t = _trainer(tmp_path, steps=5)
    t._straggler_hook = lambda s, dt, ew: events.append((s, dt, ew))
    t._ewma = 1e-9  # every step looks like a straggler
    t.run(2)
    assert t.straggler_events >= 1 and len(events) == t.straggler_events


def test_launcher_trains_and_checkpoints_on_the_cpu(tmp_path, capsys):
    launch_train.main([
        "--arch", "qwen3-1.7b", "--sparse", "--smoke", "--steps", "3", "--batch", "2",
        "--seq", "64", "--device", "cpu", "--ckpt-dir", str(tmp_path),
    ])
    assert "final loss" in capsys.readouterr().out
    assert ck.latest_step(str(tmp_path)) == 3


# ----------------------------------------------------------------------
# checkpoint format
# ----------------------------------------------------------------------


def _tree(v=1.0):
    return {
        "params": {"a.w": torch.full((4, 4), v), "b": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
        "opt": {"step": 7},
    }


def test_bf16_round_trip_is_bit_exact(tmp_path):
    """Every bf16 bit pattern (NaN payloads and infinities included) comes
    back as written, stored as uint16 under the manifest dtype bfloat16."""
    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16)
    tree = {"params": {"x": bits.view(torch.bfloat16).reshape(256, 256)}, "opt": {"step": 3}}
    path = ck.save(str(tmp_path), 1, tree, extra={"step": 1})
    out, extra = ck.restore(str(tmp_path), tree)
    assert out["params"]["x"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["x"].view(torch.int16), bits.reshape(256, 256))
    assert out["opt"]["step"] == 3 and extra == {"step": 1}
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["arrays"]["params/x"]["dtype"] == "bfloat16"


def test_crc_mismatch_raises(tmp_path):
    path = ck.save(str(tmp_path), 1, _tree())
    f = os.path.join(path, "arrays.npz")
    loaded = dict(np.load(f))
    loaded["params/a.w"] = loaded["params/a.w"] + 1.0  # manifest CRCs now stale
    with open(f, "wb") as fh:
        np.savez(fh, **loaded)
    with pytest.raises(ck.CheckpointError, match="CRC"):
        ck.restore(str(tmp_path), _tree())


def test_shape_mismatch_raises(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["params"]["a.w"] = torch.zeros((2, 2))
    with pytest.raises(ck.CheckpointError, match="shape"):
        ck.restore(str(tmp_path), bad)


def test_keep_and_stale_tmp_cleanup(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000001.tmp"))
    for s in (1, 2, 3, 4, 5):
        ck.save(d, s, _tree(float(s)), keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    assert ck.latest_step(d) == 5
    out, _ = ck.restore(d, _tree())
    assert torch.equal(out["params"]["a.w"], torch.full((4, 4), 5.0))


# ----------------------------------------------------------------------
# serving builds no graph
# ----------------------------------------------------------------------


def test_engine_step_leaves_no_autograd_graph():
    """The parameters require grad, yet a served request leaves the KV
    pools (written in place from parameter-dependent values) without a
    grad_fn, and the model entry points return plain tensors."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=4 * cfg.attn_block), device="cpu")
    assert all(p.requires_grad for p in eng.model.parameters())
    eng.submit(np.arange(70, dtype=np.int32) % cfg.vocab_size, 4)
    assert len(eng.drain(max_steps=20)) == 1
    for pool in eng.kv.buffers:
        for t in pool.values():
            assert t.grad_fn is None and not t.requires_grad
    cache = T.init_paged_cache(cfg, 3, cfg.attn_block, device="cpu")
    toks = torch.arange(cfg.attn_block)[None] % cfg.vocab_size
    logits, _ = T.prefill_paged(cfg, eng.model, toks, torch.tensor([cfg.attn_block]), cache,
                                torch.tensor([[1]]))
    assert logits.grad_fn is None and cache[0]["k"].grad_fn is None
