"""The port's greedy ``Engine`` against the JAX package's ``Engine`` on
bridged weights, plus its allocator, rejections and refusals.

Mixed prompt lengths across several buckets, fewer slots than requests
(slots are reused mid-flight), and a ``max_len`` long enough that the
pixelfly decode schedule skips pages: the token streams must be equal.
"""

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import REJECT_TIMEOUT, REJECT_TOO_LARGE, ScheduleParams
from repro_torch.serving.sampling import SamplingParams


def _workload(vocab, plens, gens, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, p).astype(np.int32), g) for p, g in zip(plens, gens)]


def _serve(engine, work, **kw):
    uids = {engine.submit(p, g, **kw): i for i, (p, g) in enumerate(work)}
    fins = engine.drain(max_steps=500)
    return {uids[f.uid]: (f.finish_reason, f.reject_reason, f.tokens.tolist()) for f in fins}


@pytest.mark.parametrize("sparse", [True, False])
def test_streams_equal_reference_engine(sparse):
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=sparse)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=sparse)
    page = cfg.attn_block
    # 8 pages a slot: at 5+ pages in, the sparse schedule skips pages
    plens = [30, 2 * page + 22, 5 * page + 10, 70, 6 * page + 3, 9]
    gens = [6, 4, 9, 5, 3, 7]
    work = _workload(cfg.vocab_size, plens, gens)
    # one request that can never fit: rejected, not queued
    work.append((np.arange(9 * page, dtype=np.int32) % cfg.vocab_size, 2))
    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(max_slots=2, max_len=8 * page))
    want = _serve(jeng, work)
    sd = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=8 * page), params=sd, device="cpu")
    got = _serve(eng, work)
    assert got == want
    assert got[len(work) - 1][:2] == ("rejected", REJECT_TOO_LARGE)
    s = eng.stats_summary()
    assert s["requests_finished"] == len(work) - 1
    assert s["generated_tokens"] == sum(gens)
    assert s["prefill_calls"] >= 3


def _small_engine(**kw):
    cfg = registry.get_smoke("qwen3-1.7b", num_layers=1)
    return cfg, Engine(cfg, engine_cfg=EngineConfig(**kw), device="cpu")


def test_eos_finish_and_slot_reuse():
    cfg, eng = _small_engine(max_slots=1, max_len=128)
    prompt = np.arange(8, dtype=np.int32)
    eng.submit(prompt, 6)
    toks = eng.drain(max_steps=30)[0].tokens.tolist()
    eos = toks[2]
    eng.submit(prompt, 6, eos_id=eos)
    fin = eng.drain(max_steps=30)[0]
    first = toks.index(eos)
    assert fin.finish_reason == "eos" and fin.tokens.tolist() == toks[: first + 1]
    assert eng.kv.free_pages == eng.kv.n_pages - 1  # every page came back


def test_capacity_finish():
    cfg, eng = _small_engine(max_slots=1, max_len=64)
    eng.submit(np.arange(60, dtype=np.int32), 20)
    fin = eng.drain(max_steps=40)[0]
    assert fin.finish_reason == "capacity" and len(fin.tokens) == 64 - 60 + 1


def test_queue_timeout_rejects():
    cfg, eng = _small_engine(max_slots=1, max_len=128)
    eng.submit(np.arange(8, dtype=np.int32), 5)
    eng.step()  # the slot is taken
    uid = eng.submit(np.arange(4, dtype=np.int32), 3,
                     schedule=ScheduleParams(max_queue_wait_s=0.0))
    fins = {f.uid: f for f in eng.drain(max_steps=30)}
    assert fins[uid].finish_reason == "rejected"
    assert fins[uid].reject_reason == REJECT_TIMEOUT


def test_unported_options_raise(tmp_path):
    """Sampling, the prefix cache, priorities and, since the observability
    slice, the four observability options are served; what still needs
    distribution (tensor parallelism, replicas) is refused by the CLI."""
    from repro_torch.launch import serve
    from repro_torch.obs import SloConfig

    cfg, eng = _small_engine(max_slots=1, max_len=128)
    eng.submit(np.arange(4), 2, sampling=SamplingParams(temperature=0.7))
    eng.submit(np.arange(4), 2, schedule=ScheduleParams(priority=1))
    assert len(eng.drain(max_steps=30)) == 2
    Engine(cfg, engine_cfg=EngineConfig(max_slots=1, max_len=128, prefix_cache=True), device="cpu")
    obs = {"trace": True, "monitor": True, "slo": SloConfig(), "flight_dir": str(tmp_path / "fl")}
    for kw in [{k: v} for k, v in obs.items()] + [obs]:
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=1, max_len=128, **kw), device="cpu")
        eng.submit(np.arange(4), 3)
        assert len(eng.drain(max_steps=30)) == 1
    assert eng.tracer.n_recorded > 0 and eng.windowed_vars()["enabled"] and eng.slo_state()["enabled"]
    smoke = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu"]
    # --tp needs --strategy tp, as the JAX CLI (tensor-parallel serving is
    # tests/test_torch_tp_serving.py's), also with --replicas
    for flag in (["--tp", "2"], ["--replicas", "2", "--tp", "2"]):
        with pytest.raises(SystemExit, match="pass --strategy tp"):
            serve.main(smoke + flag)


def test_paged_cache_accounting_and_rollback():
    cfg = registry.get_smoke("qwen3-1.7b", num_layers=1)
    kv = PagedKVCache(cfg, max_slots=2, max_len=4 * cfg.attn_block, device="cpu")
    page, total = kv.page, kv.free_pages
    assert kv.n_pages == 2 * 4 + 1 and total == kv.n_pages - 1
    kv.alloc_upto(0, 3 * page)  # logical pages 0..3
    assert kv.free_pages == total - 4
    assert (kv.page_table[0, :4] > 0).all()  # page 0 is the trash page
    assert [kv.refcount(int(p)) for p in kv.page_table[0, :4]] == [1] * 4
    assert kv.bucket_row(0, 2 * page + 1, 4).tolist() == kv.page_table[0, :3].tolist() + [0]
    first = int(kv.page_table[0, 0])
    kv.free_slot(0)
    assert kv.free_pages == total and (kv.page_table[0] == 0).all()
    assert kv.refcount(first) == 0
    with pytest.raises(ValueError):
        kv.alloc_upto(1, 4 * page)  # beyond per-slot capacity
    # oversubscribed pool: a failed growth rolls back what it took
    small = PagedKVCache(cfg, max_slots=2, max_len=4 * page, n_pages=6, device="cpu")
    small.alloc_upto(0, 2 * page)  # 3 of 5 pages
    with pytest.raises(RuntimeError, match="out of pages"):
        small.alloc_upto(1, 3 * page)  # needs 4, 2 left
    assert small.free_pages == 2 and small.pages_owned(1) == 0
    assert (small.page_table[1] == 0).all()
    assert int(small.device_table().sum()) == int(small.page_table.sum())
