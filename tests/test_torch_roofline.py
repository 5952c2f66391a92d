"""The port's H100 roofline (``repro_torch.analysis.roofline``) against the
JAX package's ``analysis/roofline.py``, on the CPU.

- ``active_params`` and ``model_flops`` equal the JAX functions exactly
  for every registry arch, full and smoke, sparse and dense.
- ``roofline_terms`` equals JAX's on the same cost and peaks (exact).
- The counting: matmul-class FLOPs as the JAX walker counts dots, views
  free, gathers and scatters by the rows they move, and each kernel entry
  point reporting its own cost (``@metered``) with the ops inside it
  hidden (exact).
- The decode step of smoke qwen3-1.7b and smollm-360m, counted by
  ``Engine.roofline()``, against the JAX walker's ``analyze_hlo`` of the
  JAX engine's decode step on ``make_tp_mesh(1)``. The two differ by
  exactly the pages the schedule drops: the JAX CPU path (the gather)
  computes every scheduled page and masks the XOR-collision duplicates,
  the port's kernel skips them (so does the TPU kernel). The test holds
  port + dropped == JAX exactly; the gap is ROADMAP Queue 3's record.
- The counted bytes cover at least the parameters and the K/V rows the
  step reads."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.analysis import roofline as R
from repro_torch.configs import registry
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.serving.engine import Engine, EngineConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_active_params_and_model_flops_equal_jax(arch):
    for get in ("get", "get_smoke"):
        for sparse in (True, False):
            cfg = getattr(registry, get)(arch, sparse=sparse)
            jcfg = getattr(jreg, get)(arch, sparse=sparse)
            assert R.active_params(cfg) == jroof.active_params(jcfg), (get, sparse)
            for backward in (True, False):
                assert R.model_flops(cfg, 4096, backward=backward) == jroof.model_flops(
                    jcfg, 4096, backward=backward)


@pytest.mark.parametrize("flops,nbytes,coll", [(197e12, 819e9 / 2, 0.0), (1e9, 819e9, 0.0), (1e9, 1e6, 5e10)])
def test_roofline_terms_equal_jax(flops, nbytes, coll):
    jcost = jroof.HloCost(flops=flops, bytes_accessed=nbytes, collective_bytes={"all-reduce": coll},
                          n_collectives=1)
    cost = R.Cost(flops=flops, bytes_accessed=nbytes, collective_bytes={"all-reduce": coll}, n_collectives=1)
    jhw = jroof.HW()
    hw = R.HW(peak_flops=jhw.peak_flops, hbm_bw=jhw.hbm_bw, link_bw=jhw.ici_bw)
    assert R.roofline_terms(cost, hw) == jroof.roofline_terms(jcost, jhw)
    assert cost.to_dict() == jcost.to_dict()


def test_h100_peaks_by_dtype():
    hw = R.HW()
    assert (hw.peak_flops, hw.fp32_flops, hw.hbm_bw) == (989e12, 67e12, 3.35e12)
    assert hw.for_dtype("float32").peak_flops == hw.flops_for(torch.float32) == 67e12
    assert hw.for_dtype("bfloat16").peak_flops == hw.flops_for(torch.bfloat16) == 989e12
    terms = R.roofline_terms(R.Cost(989e12, 3.35e12 / 2, {}, 0))
    assert terms["bottleneck"] == "compute" and terms["compute_s"] == pytest.approx(1.0)
    assert terms["collective_s"] == 0.0


def test_count_matmul_flops_as_the_walker_counts_dots():
    a, b = torch.ones((64, 32)), torch.ones((32, 16))
    _, c = R.count(lambda: a @ b)
    assert c.flops == 2 * 64 * 32 * 16
    x, y = torch.ones((4, 8, 16)), torch.ones((4, 16, 8))
    _, c = R.count(lambda: torch.einsum("bij,bjk->bik", x, y))
    assert c.flops == 2 * 4 * 8 * 16 * 8
    lin = torch.nn.Linear(32, 16)
    with torch.no_grad():
        _, c = R.count(lambda: lin(torch.ones((5, 32))))
    assert c.flops == 2 * 5 * 32 * 16
    conv = torch.nn.Conv2d(3, 8, 3)
    with torch.no_grad():
        out, c = R.count(lambda: conv(torch.ones((2, 3, 10, 10))))
    assert c.flops == 2 * out.numel() * 3 * 3 * 3
    _, c = R.count(lambda: (a * 2.0).sum())  # no dot, no FLOPs counted
    assert c.flops == 0 and c.bytes_accessed > 0


def test_count_bytes_of_views_gathers_and_scatters():
    x = torch.ones((64, 32))
    _, c = R.count(lambda: x.t().reshape(32, 64)[:4])
    assert c.bytes_accessed == 0  # views move nothing
    table = torch.ones((1000, 16))
    idx = torch.tensor([1, 5, 7])
    _, c = R.count(lambda: torch.nn.functional.embedding(idx, table))
    assert c.bytes_accessed == 2 * 3 * 16 * 4 + 3 * 8  # the rows, not the table
    pool = torch.zeros((100, 16))
    vals = torch.ones((3, 16))
    _, c = R.count(lambda: pool.index_put_((idx,), vals))
    assert c.bytes_accessed == 2 * 3 * 16 * 4 + 3 * 8  # the rows written


def test_entry_points_report_their_own_cost_and_hide_their_ops():
    """On the CPU each entry point runs its plain version; the count is
    the entry point's formula, never the plain version's einsums."""
    from repro_torch.core import attn_pattern as ap
    from repro_torch.core.pixelfly import linear_tables

    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    spec = L.linear_spec(cfg, 256, 512, False)
    pat = spec.pattern()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((6, 256), generator=gen)
    blocks = torch.randn((pat.nb_out, pat.r, pat.block, pat.block), generator=gen)
    cols = linear_tables(spec, torch.device("cpu")).cols
    y, c = R.count(lambda: ops.bsr_matmul(x, blocks, cols))
    assert torch.equal(y, ref.bsr_matmul_gather(x, blocks, cols))
    assert (c.flops, c.bytes_accessed) == ops.bsr_matmul_cost(x, blocks, cols)
    assert c.flops == 2 * 6 * pat.nb_out * pat.r * pat.block ** 2

    # the paged read: ragged positions, an idle slot on the trash page
    b, hk, g, d, page, pps = 3, 2, 2, 64, 16, 4
    q = torch.randn((b, hk, g, d), generator=gen)
    kp, vp = (torch.randn((b * pps + 1, page, hk, d), generator=gen) for _ in range(2))
    table = torch.arange(1, b * pps + 1, dtype=torch.int32).reshape(b, pps)
    table[1] = 0
    pos = torch.tensor([pps * page - 1, 0, 2 * page + 3], dtype=torch.int32)
    logical, phys, keep = L.paged_sparse_schedule(table, pos, page, local_blocks=2, global_blocks=1)
    args = (q, kp, vp, phys, logical, keep, pos)
    _, c = R.count(lambda: ops.paged_decode_attention(*args, sm_scale=0.125))
    n_vis = sum(int(((pos[i] - logical[i] * page + 1).clamp(0, page) * keep[i]).sum()) for i in range(b))
    assert (c.flops, c.bytes_accessed) == ops.paged_decode_attention_cost(*args, sm_scale=0.125)
    assert c.flops == 4.0 * g * d * n_vis * hk

    s, block = 256, 64
    mask = ap.pixelfly_attention_block_mask(
        s, s, ap.AttentionPatternConfig(block=block, local_blocks=2, global_blocks=1), causal=True)
    sched = ap.block_schedule(mask, block, block)
    qa = torch.randn((1, s, hk, g, d), generator=gen)
    ka, va = (torch.randn((1, s, hk, d), generator=gen) for _ in range(2))
    kv_index, valid = torch.as_tensor(sched.kv_index), torch.as_tensor(sched.valid)
    kw = dict(block=block, causal=True, sm_scale=0.125)
    _, c = R.count(lambda: ops.block_sparse_attention(qa, ka, va, kv_index, valid, **kw))
    pairs = sum(block * block if sched.kv_index[i, t] < i else block * (block + 1) // 2
                for i in range(sched.nqb) for t in range(sched.max_nkv) if sched.valid[i, t])
    assert c.flops == 4.0 * d * pairs * hk * g
    assert (c.flops, c.bytes_accessed) == ops.block_sparse_attention_cost(qa, ka, va, kv_index, valid, **kw)


def test_count_is_not_reentrant():
    with pytest.raises(RuntimeError, match="reentrant"):
        R.count(lambda: R.count(lambda: None))


ECFG = dict(max_slots=4, max_len=256)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-360m"])
def test_decode_step_flops_equal_jax_walker_but_for_dropped_pages(arch):
    cfg = registry.get_smoke(arch, sparse=True)
    eng = Engine(cfg, engine_cfg=EngineConfig(**ECFG), device="cpu")
    ours = eng.roofline()
    jeng = JEngine(jreg.get_smoke(arch, sparse=True), make_tp_mesh(1), engine_cfg=JEngineConfig(**ECFG))
    theirs = jeng.roofline()
    assert theirs["available"] and ours["available"]
    assert set(ours) == set(theirs)
    # the schedule of every slot at its last position (what the port
    # counts): the pages it keeps, and the duplicates it drops
    page, ms = cfg.attn_block, ECFG["max_slots"]
    table = torch.zeros((ms, ECFG["max_len"] // page), dtype=torch.int32)
    pos = torch.full((ms,), ECFG["max_len"] - 1, dtype=torch.int32)
    _, _, keep = L.paged_sparse_schedule(table, pos, page, local_blocks=cfg.attn_local_blocks,
                                         global_blocks=cfg.attn_global_blocks)
    dropped = int((1 - keep).sum())
    assert dropped > 0
    per_key = 4.0 * cfg.num_heads * cfg.head_dim * cfg.num_layers  # q.k and p.v, every head and layer
    assert ours["flops"] + dropped * page * per_key == theirs["flops"]
    # the share the drop is of the JAX count (ROADMAP Queue 3's record)
    gap = 1.0 - ours["flops"] / theirs["flops"]
    assert 0.02 < gap < 0.1


def test_decode_step_bytes_cover_weights_and_kv():
    """At least every parameter once and the K/V rows the step reads (each
    slot's kept pages at the last position: full pages)."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    eng = Engine(cfg, engine_cfg=EngineConfig(**ECFG), device="cpu")
    rec = eng.roofline()
    params = sum(p.numel() * p.element_size() for p in eng.model.parameters())
    page, ms = cfg.attn_block, ECFG["max_slots"]
    table = torch.zeros((ms, ECFG["max_len"] // page), dtype=torch.int32)
    pos = torch.full((ms,), ECFG["max_len"] - 1, dtype=torch.int32)
    _, _, keep = L.paged_sparse_schedule(table, pos, page, local_blocks=cfg.attn_local_blocks,
                                         global_blocks=cfg.attn_global_blocks)
    kv = int(keep.sum()) * page * 2 * cfg.num_kv_heads * cfg.head_dim * 4 * cfg.num_layers
    assert rec["bytes_accessed"] >= params + kv
    assert rec["bottleneck"] == "memory" and rec["collective_bytes"] == 0
    assert rec["memory_s"] == pytest.approx(rec["bytes_accessed"] / R.HW().hbm_bw)
    assert rec["compute_s"] == pytest.approx(rec["flops"] / R.HW().fp32_flops)  # a float32 model


def test_engine_roofline_is_cached_and_traced():
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=128, trace=True), device="cpu")
    rec = eng.roofline()
    assert eng.roofline() is rec and eng.stats_summary()["roofline"] is rec
    marks = [e for e in eng.tracer.events() if e["name"] == "roofline"]
    assert len(marks) == 1
    assert marks[0]["a0"] == int(rec["arithmetic_intensity"] * 1000) and marks[0]["a1"] == 1  # memory


def test_cost_is_a_dataclass_twin_of_hlocost():
    assert [f.name for f in dataclasses.fields(R.Cost)] == [f.name for f in dataclasses.fields(jroof.HloCost)]
    assert np.isclose(R.Cost(1.0, 2.0, {"a": 3.0}, 1).total_collective_bytes, 3.0)
