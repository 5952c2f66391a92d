"""The port's priorities, preemption and host swap (``serving.swap``)
against the JAX package, on the CPU.

The load-bearing guarantee is the JAX suite's (``tests/test_preemption.py``):
preemption only changes scheduling. A preempted and resumed sequence
emits the tokens of an unpreempted run, greedy and sampled, because its
KV pages round-trip through host memory unchanged and the sampler's noise
depends only on (seed, sample index). The rest (priority order,
hysteresis, shared-page pinning, rejections) is checked on the engine's
records, re-derived from what each JAX test states; and the port's
engine gives the JAX engine's streams (bridged weights,
``make_tp_mesh(1)``) when a priority request preempts a full pool.
"""

import time

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ScheduleParams as JScheduleParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import REJECT_TIMEOUT, REJECT_TOO_LARGE, Request, ScheduleParams
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.swap import SwapManager


def _cfg(**kw):
    return registry.get_smoke("qwen3-1.7b", num_layers=2, vocab_size=128, **kw)


def _tiny_kv():
    cfg = registry.get_smoke("qwen3-1.7b", num_layers=1, num_heads=2, num_kv_heads=1, head_dim=8, attn_block=4)
    return PagedKVCache(cfg, max_slots=2, max_len=16, device="cpu")


# ----------------------------------------------------------------------
# Priority queue (no model)
# ----------------------------------------------------------------------


def test_scheduler_orders_by_priority_then_deadline_then_fcfs():
    sch = Scheduler(1)
    prompt = np.array([1, 2, 3])
    lo_late = Request(1, prompt, 1)
    lo_soon = Request(2, prompt, 1, schedule=ScheduleParams(deadline_s=1.0), submit_s=0.0)
    hi = Request(3, prompt, 1, schedule=ScheduleParams(priority=2))
    lo_later = Request(4, prompt, 1, schedule=ScheduleParams(deadline_s=9.0), submit_s=0.0)
    for r in (lo_late, lo_soon, hi, lo_later):
        sch.submit(r)
    assert [r.uid for r in sch.peek_admissible(4)] == [3, 2, 4, 1]
    assert sch.admit(0).request.uid == 3
    sch.evict(0)
    assert sch.admit(1, request=lo_later).request.uid == 4
    assert [r.uid for r in sch.waiting] == [2, 1]
    for bad in (dict(deadline_s=0.0), dict(max_queue_wait_s=-0.1)):
        with pytest.raises(ValueError):
            ScheduleParams(**bad)


def test_scheduler_resume_rebinds_preserved_state():
    sch = Scheduler(2)
    req = Request(1, np.array([1, 2, 3]), 4)
    sch.submit(req)
    st = sch.admit(0)
    st.generated.extend([5, 6])
    st.pos = 5
    sch.evict(st.slot)
    sch.submit(req)
    sch.submit(Request(2, np.array([7]), 1))
    assert sch.peek_admissible(2)[0] is req  # the older uid leads its class
    back = sch.resume(st, request=req)
    assert back is st and back.generated == [5, 6] and back.pos == 5 and req not in sch.waiting


# ----------------------------------------------------------------------
# SwapManager (real pools, no model)
# ----------------------------------------------------------------------


def test_swap_manager_roundtrip_restores_page_bytes():
    kv = _tiny_kv()
    sm = SwapManager(kv)
    kv.alloc_upto(0, 11)  # 3 pages
    pages = kv.owned_pages(0)
    for p in pages:  # a distinct constant per page
        for pool in kv.buffers:
            for buf in pool.values():
                buf[:, p] = float(p)
    rec = sm.swap_out(0)
    assert rec.pin_pages == [] and rec.n_host == 3
    assert kv.pages_owned(0) == 0 and kv.free_pages == kv.n_pages - 1
    # the freed pages are reused and overwritten at once
    kv.alloc_upto(1, 15)
    for pool in kv.buffers:
        for buf in pool.values():
            buf[:, 1:] = -1.0
    kv.free_slot(1)
    sm.finalize(rec)
    assert not rec.pending
    kv.alloc_upto(1, 11)
    sm.swap_in(rec, 1, n_resident=0)
    for old, new in zip(pages, kv.owned_pages(1)):
        for pool in kv.buffers:
            for buf in pool.values():
                assert (buf[:, new] == float(old)).all()
    assert sm.stats.out_pages == 3 and sm.stats.in_pages == 3
    assert sm.stats.out_bytes == 3 * sm.page_bytes


def test_swap_manager_pins_shared_prefix_instead_of_copying():
    kv = _tiny_kv()
    sm = SwapManager(kv)
    kv.alloc_upto(0, 11)
    shared = kv.owned_pages(0)[:2]
    for p in shared:
        kv.incref(p)
    kv.adopt(1, shared)
    rec = sm.swap_out(0, max_pin=2)
    assert rec.pin_pages == shared and rec.n_host == 1
    assert all(kv.refcount(p) == 2 for p in shared)  # slot 1 + the pin
    for p in shared:
        kv.incref(p)
    kv.adopt(0, list(shared))
    kv.alloc_upto(0, 11)
    sm.swap_in(rec, 0, n_resident=2)
    assert all(kv.refcount(p) == 2 for p in shared)  # the pin is released
    assert sm.stats.pinned_pages == 2 and sm.stats.out_pages == 1
    rec2 = sm.swap_out(1, max_pin=2)
    assert rec2.pin_pages == shared and rec2.n_host == 0
    with pytest.raises(ValueError):
        sm.swap_in(rec2, 1, n_resident=0)
    sm.discard(rec2)
    assert all(kv.refcount(p) == 1 for p in shared)


# ----------------------------------------------------------------------
# Engine-level preemption
# ----------------------------------------------------------------------


def test_preempted_streams_bit_exact_greedy_and_sampled():
    cfg = _cfg()
    page = cfg.attn_block
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 127, size=n).astype(np.int32) for n in (page + 3, page + 5, 7)]
    sampled = SamplingParams(temperature=0.8, top_k=20, seed=7)

    def serve(preemption, n_pages):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=4 * page, n_pages=n_pages,
                                                  prefix_cache=True, preemption=preemption,
                                                  preempt_min_steps=2), device="cpu")
        uids = [eng.submit(prompts[0], 2 * page, sampling=sampled), eng.submit(prompts[1], 2 * page)]
        fins = []
        if preemption:
            for _ in range(4):
                fins += eng.step()
        uids.append(eng.submit(prompts[2], page, schedule=ScheduleParams(priority=5, deadline_s=60.0)))
        fins += eng.drain(max_steps=800)
        return uids, {f.uid: f for f in fins}, eng

    base_uids, base, _ = serve(False, 0)
    got_uids, got, eng = serve(True, 5)
    assert sum(f.preemptions for f in got.values()) >= 1
    sw = eng.swap.stats
    assert sw.swap_outs >= 1 and sw.out_bytes > 0 and sw.swap_ins == sw.swap_outs
    assert eng.stats.preemptions == eng.stats.resumes == sw.swap_outs
    for ub, ug in zip(base_uids, got_uids):
        np.testing.assert_array_equal(base[ub].tokens, got[ug].tokens)
    vip = got[got_uids[2]]
    assert vip.schedule.priority == 5 and vip.slo_met is True
    assert vip.ttft_s is not None and vip.e2e_s >= vip.ttft_s


def test_priority_request_preempts_full_pool():
    cfg = _cfg()
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=128), device="cpu")
    rng = np.random.default_rng(1)
    bg = [eng.submit(rng.integers(1, 127, 8).astype(np.int32), 60) for _ in range(2)]
    fins = []
    for _ in range(6):
        fins += eng.step()
    hi = eng.submit(rng.integers(1, 127, 8).astype(np.int32), 4,
                    schedule=ScheduleParams(priority=3, deadline_s=120.0))
    fins += eng.drain(max_steps=500)
    by_uid = {f.uid: f for f in fins}
    assert eng.stats.preemptions >= 1
    assert all(by_uid[hi].finish_step < by_uid[b].finish_step for b in bg)
    assert all(len(by_uid[b].tokens) == 60 for b in bg)
    # equal priority never preempts
    pre = eng.stats.preemptions
    for _ in range(2):
        eng.submit(rng.integers(1, 127, 8).astype(np.int32), 30)
    for _ in range(6):
        eng.step()
    eng.submit(rng.integers(1, 127, 8).astype(np.int32), 4)
    eng.drain(max_steps=500)
    assert eng.stats.preemptions == pre
    kv = eng.kv  # page conservation after the swap traffic
    assert kv.free_pages + kv.cached_pages == kv.n_pages - 1
    assert (kv._ref[1:] == 0).sum() == kv.n_pages - 1


def test_hysteresis_blocks_preemption_of_fresh_sequences():
    eng = Engine(_cfg(), engine_cfg=EngineConfig(max_slots=2, max_len=128, preempt_min_steps=10_000),
                 device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(2):
        eng.submit(rng.integers(1, 127, 8).astype(np.int32), 20)
    for _ in range(6):
        eng.step()
    eng.submit(rng.integers(1, 127, 8).astype(np.int32), 4, schedule=ScheduleParams(priority=9))
    fins = eng.drain(max_steps=300)
    assert eng.stats.preemptions == 0 and all(f.preemptions == 0 for f in fins)


def test_preemption_pins_shared_prefix_pages():
    cfg = _cfg()
    page = cfg.attn_block
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=4 * page, prefix_cache=True,
                                              preempt_min_steps=2), device="cpu")
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 127, 2 * page + 5).astype(np.int32)
    a = eng.submit(shared, page)
    eng.step()
    b = eng.submit(shared, 2 * page)
    for _ in range(4):
        eng.step()
    eng.submit(rng.integers(1, 127, 7).astype(np.int32), 4, schedule=ScheduleParams(priority=7))
    by_uid = {f.uid: f for f in eng.drain(max_steps=800)}
    sw = eng.swap.stats
    assert sw.swap_outs >= 1 and sw.pinned_pages >= 2
    n = min(len(by_uid[a].tokens), len(by_uid[b].tokens))
    np.testing.assert_array_equal(by_uid[a].tokens[:n], by_uid[b].tokens[:n])


def test_structured_rejections_and_drain_delivery():
    cfg = _cfg()
    page = cfg.attn_block
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=2 * page), device="cpu")
    rng = np.random.default_rng(4)
    uid = eng.submit(rng.integers(1, 127, 5 * page).astype(np.int32), 2)
    out = eng.drain(max_steps=5)
    assert [f.uid for f in out] == [uid] and out[0].reject_reason == REJECT_TOO_LARGE
    assert out[0].slo_met is None and len(out[0].tokens) == 0
    uid2 = eng.submit(rng.integers(1, 127, 4).astype(np.int32), 10**6)
    out2 = eng.drain(max_steps=300)
    assert out2[0].uid == uid2 and out2[0].finish_reason == "capacity"
    assert len(out2[0].tokens) == 2 * page - 4 + 1
    bg = [eng.submit(rng.integers(1, 127, 8).astype(np.int32), 40) for _ in range(2)]
    eng.step()
    impatient = eng.submit(rng.integers(1, 127, 8).astype(np.int32), 4,
                           schedule=ScheduleParams(max_queue_wait_s=0.0, deadline_s=5.0))
    time.sleep(0.01)
    by_uid = {f.uid: f for f in eng.drain(max_steps=300)}
    rej = by_uid[impatient]
    assert rej.rejected and rej.reject_reason == REJECT_TIMEOUT and rej.slo_met is False
    assert all(len(by_uid[b].tokens) == 40 for b in bg)
    assert eng.stats_summary()["rejected"]["total"] == 2


def test_engine_preemption_equals_jax_engine():
    """A full pool of sampled and greedy requests on shared prefixes, two
    priority-1 requests submitted after step 6: the port preempts, swaps
    and resumes as the JAX engine does, with equal streams."""
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=True, num_layers=2)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True, num_layers=2)
    page = cfg.attn_block
    rng = np.random.default_rng(8)
    sys_prompt = rng.integers(0, cfg.vocab_size, 2 * page).astype(np.int32)
    work = [(np.concatenate([sys_prompt, rng.integers(0, cfg.vocab_size, 5 + 7 * i).astype(np.int32)])
             if i % 2 else rng.integers(0, cfg.vocab_size, 20 + 9 * i).astype(np.int32), 24)
            for i in range(4)]
    vips = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, page + 2)]
    knobs = dict(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1)
    ecfg = dict(max_slots=3, max_len=6 * page, prefix_cache=True, preempt_min_steps=2)

    def serve(eng, sp_cls, sch_cls):
        uids = {eng.submit(p, g, sampling=sp_cls(seed=10 + i, **knobs) if i % 2 == 0 else None): i
                for i, (p, g) in enumerate(work)}
        fins = []
        for _ in range(6):
            fins += eng.step()
        for j, p in enumerate(vips):
            uids[eng.submit(p, 8, schedule=sch_cls(priority=1))] = 10 + j
        fins += eng.drain(max_steps=500)
        return {uids[f.uid]: (f.tokens.tolist(), f.preemptions, f.prefix_hit_tokens) for f in fins}

    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg))
    want = serve(jeng, JSamplingParams, JScheduleParams)
    sd = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = Engine(cfg, engine_cfg=EngineConfig(**ecfg), params=sd, device="cpu")
    got = serve(eng, SamplingParams, ScheduleParams)
    assert got == want
    assert sum(p for _, p, _ in got.values()) >= 1
    jsw = jeng.stats_summary()["preemption"]
    for k in ("swap_outs", "swap_ins", "out_pages", "in_pages", "out_bytes", "in_bytes", "pinned_pages"):
        assert getattr(eng.swap.stats, k) == jsw[k], k
