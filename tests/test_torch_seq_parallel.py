"""Tensor-parallel serving where tp does not divide the kv heads, the JAX
rules' "seq" mode, on the CPU (``Engine(mesh=make_tp_mesh(tp, ["cpu"] *
tp))``), held against the JAX package with ``bridge.params_from_jax``
weights: smoke qwen3-1.7b (2 kv heads) at tp 4 and 8 serves the JAX
``Engine``'s greedy and sampled streams on ``make_tp_mesh(1)``, a prefix
hit included, with each shard's pools cut on head_dim as
``paged_pool_entry`` places them (a); its first prefill and decode logits
and the joined pools equal the JAX ``prefill_paged``/``decode_step_paged``
within 1e-4 in fp32 (b); a preemption at tp 4 leaves the streams the
single-device engine's, ``ReplicaRouter(replicas=2, tp=4)`` serves the
JAX engine's, and contiguous prefill and decode on a ``MeshState`` at
(1, 4) equal one device's, its caches cut on head_dim (c); the plain query-slice attention equals the
rows of the whole ``ref.sparse_attention`` and counts its own pairs, and
the summed plain partial scores and the plain apply equal
``ref.paged_decode_attention_gather`` (d); column-cut o, down and biased
k shards equal the unsharded ``Linear`` (e); training in the mode runs,
and a sequence-cut decode cache still raises naming item 16 (f)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh as jax_make_tp_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.core import attn_pattern as ap
from repro_torch.distributed import sharding
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_tp_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import ScheduleParams
from repro_torch.serving.sampling import SamplingParams
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import Trainer, TrainConfig
from repro_torch.training.optimizer import OptConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(num_layers=2, vocab_size=256)
    return (registry.get_smoke("qwen3-1.7b", sparse=True).replace(**kw),
            jreg.get_smoke("qwen3-1.7b", sparse=True).replace(**kw))


# prompts of 1 to 3 pages (page = attention block = 64): at tp 4 and 8 a
# bucket of 1 or 3 query blocks leaves some shards without query rows
LENGTHS = (9, 17, 130, 70)
ECFG = dict(max_slots=4, max_len=256, prefix_cache=True)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 250, size=n).astype(np.int32) for n in LENGTHS]


def _serve(eng, cls):
    """Requests 0 and 2 greedy, 1 and 3 sampled; then request 2's prompt
    again, whose first two pages the prefix cache holds. Streams by submit
    order."""
    prompts = _prompts()
    for i, p in enumerate(prompts):
        eng.submit(p, 10, sampling=cls(temperature=0.8, top_k=40, seed=100 + i) if i % 2 else None)
    out = sorted(eng.drain(max_steps=80), key=lambda f: f.uid)
    eng.submit(prompts[2], 6)
    out += eng.drain(max_steps=40)
    return [f.tokens.tolist() for f in out]


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine on one device: its streams (the contract: a tp
    engine's equal tp 1's) and its weights as numpy."""
    _, jcfg = _cfgs()
    jeng = JEngine(jcfg, jax_make_tp_mesh(1), engine_cfg=JEngineConfig(**ECFG), seed=0)
    return _serve(jeng, JSamplingParams), jax.tree.map(np.asarray, jeng.params)


def _params(cfg, tree):
    return params_from_jax(jax.tree.map(jnp.asarray, tree), cfg, "cpu")


# ----------------------------------------------------------------------
# (a) streams, pools
# ----------------------------------------------------------------------


@pytest.mark.parametrize("tp", [4, 8])
def test_seq_engine_streams_equal_jax_engine(jax_engine, tp):
    want, tree = jax_engine
    cfg, jcfg = _cfgs()
    eng = Engine(cfg, engine_cfg=EngineConfig(**ECFG), mesh=make_tp_mesh(tp, ["cpu"] * tp), params=_params(cfg, tree))
    # each shard's pools: the full shape with the JAX pool entry's axis cut
    axis = JL.paged_pool_entry(jcfg.replace(tp_size=tp), cfg.num_kv_heads, cfg.head_dim)
    assert axis == -1
    full = list(T.init_paged_cache(cfg, eng.kv.n_pages, cfg.attn_block, device="meta")[0]["k"].shape)
    full[axis] //= tp
    assert [list(shard[0][name].shape) for shard in eng.kv.buffers for name in ("k", "v")] == [full] * 2 * tp
    assert full[-2:] == [2, 64 // tp]
    got = _serve(eng, SamplingParams)
    assert got == want
    assert eng.stats_summary()["prefix_cache"]["hit_tokens"] == 2 * cfg.attn_block


# ----------------------------------------------------------------------
# (b) first logits and the pools against JAX
# ----------------------------------------------------------------------


@pytest.mark.parametrize("tp", [4, 8])
def test_seq_first_logits_and_pools_equal_jax(jax_engine, tp):
    _, tree = jax_engine
    cfg, jcfg = _cfgs()
    page, n_pages = cfg.attn_block, 17
    model = T.shard_model(cfg, make_tp_mesh(tp, ["cpu"] * tp), _params(cfg, tree))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 4 * page)).astype(np.int32)
    plens = np.array([4 * page - 5, 2 * page + 3], np.int32)
    rows = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    jc = JT.init_paged_cache(jcfg, n_pages, page)
    jl, jc = JT.prefill_paged(jcfg, tree, jnp.asarray(toks), jnp.asarray(plens), jc, jnp.asarray(rows))
    from repro_torch.serving.kv_cache import _shard_pools

    tc = _shard_pools(cfg, make_tp_mesh(tp, ["cpu"] * tp), n_pages, page)
    tl, tc = T.prefill_paged(cfg, model, torch.from_numpy(toks), torch.from_numpy(plens), tc, torch.from_numpy(rows))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    real = [1, 2, 3, 4, 5, 6, 7]  # the trash page's contents are unspecified

    def joined(name):
        return torch.cat([shard[0][name] for shard in tc], dim=-1)[:, real].numpy()

    for name in ("k", "v"):
        np.testing.assert_allclose(joined(name), np.asarray(jc[0][name])[:, real], rtol=1e-4, atol=1e-4)
    table = np.zeros((3, 8), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[1, :3] = [5, 6, 7]
    pos = np.array([plens[0], plens[1], 0], np.int32)
    tok = np.array([5, 7, 0], np.int32)
    jl2, jc = JT.decode_step_paged(jcfg, tree, jc, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(table))
    tl2, tc = T.decode_step_paged(cfg, model, tc, torch.from_numpy(tok), torch.from_numpy(pos),
                                  torch.from_numpy(table))
    np.testing.assert_allclose(tl2[:2].numpy(), np.asarray(jl2)[:2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(joined("k"), np.asarray(jc[0]["k"])[:, real], rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# (c) preemption
# ----------------------------------------------------------------------


def test_seq_preemption_swaps_head_dim_slices():
    """A high-priority request preempts a running one at tp 4: its pages'
    head_dim slices go to host memory from every shard and come back; the
    streams equal the single-device engine's, and a page's slices add up
    to a page."""
    cfg, _ = _cfgs()
    ecfg = EngineConfig(max_slots=1, max_len=256, preempt_min_steps=1)
    base = Engine(cfg, engine_cfg=ecfg, device="cpu")
    prompts = _prompts()

    def run(eng):
        eng.submit(prompts[2], 12, schedule=ScheduleParams(priority=0))
        fins = eng.step()
        eng.step()
        eng.submit(prompts[0], 6, schedule=ScheduleParams(priority=5))
        fins += eng.drain(max_steps=80)
        return {f.uid: f.tokens.tolist() for f in fins}

    want = run(base)
    eng = Engine(cfg, engine_cfg=ecfg, mesh=make_tp_mesh(4, ["cpu"] * 4), params=base.model.state_dict())
    assert run(eng) == want
    pre = eng.stats_summary()["preemption"]
    assert pre["preemptions"] >= 1 and pre["out_bytes"] == pre["out_pages"] * eng.swap.page_bytes > 0
    assert eng.swap.page_bytes == base.swap.page_bytes


def test_seq_router_streams_equal_jax_engine(jax_engine):
    """``ReplicaRouter(replicas=2, tp=4)``: two tp 4 engines in the mode
    serve the JAX engine's streams."""
    from repro_torch.serving.router import ReplicaRouter

    want, tree = jax_engine
    cfg, _ = _cfgs()
    router = ReplicaRouter(cfg, replicas=2, tp=4, engine_cfg=EngineConfig(**ECFG), params=_params(cfg, tree),
                           devices=["cpu"] * 8)
    assert [e.tp for e in router.engines] == [4, 4]
    prompts = _prompts()
    uids = [router.submit(p, 10, sampling=SamplingParams(temperature=0.8, top_k=40, seed=100 + i) if i % 2 else None)
            for i, p in enumerate(prompts)]
    got = {f.uid: f.tokens.tolist() for f in router.drain(max_steps=200)}
    assert [got[u] for u in uids] == want[:4]


@pytest.mark.parametrize("sparse_decode", [False, True])
def test_seq_contiguous_prefill_and_decode_on_a_mesh_state(sparse_decode):
    """``transformer.prefill`` and ``decode_step`` on a ``MeshState`` at tp
    (1, 4) in the sequence-parallel mode (the dry-run's prefill and decode
    cells): the caches one a shard, each with its head_dim slice (the JAX
    decode layout), and the logits those of one device within 1e-5; with a cache
    of several attention blocks the decode reads the pixelfly schedule's
    blocks, each shard its slice."""
    from repro_torch.training.loop import MeshState

    cfg, _ = _cfgs()
    model = T.init_model(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(1, 250, size=(4, 128)).astype(np.int64)
    max_len = 4 * cfg.attn_block if sparse_decode else 160
    want, caches = T.prefill(cfg, model, {"tokens": toks}, max_len=max_len)
    nxt = want.argmax(-1)
    want_d, _ = T.decode_step(cfg, model, caches, nxt, 128)
    state = MeshState(cfg, make_local_mesh(1, 4, ["cpu"] * 4), "tp", model.state_dict())
    got, mcaches = T.prefill(cfg, state, {"tokens": toks}, max_len=max_len)
    assert [tuple(c[0]["k"].shape) for c in mcaches[0]] == [(cfg.num_layers, 4, max_len, 2, 16)] * 4
    got_d, _ = T.decode_step(cfg, state, mcaches, nxt, 128)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5)
    fresh = T.init_mesh_cache(cfg, state, 4, max_len)
    assert [tuple(c[0]["k"].shape) for c in fresh[0]] == [(cfg.num_layers, 4, max_len, 2, 16)] * 4


# ----------------------------------------------------------------------
# (d) the plain versions of the kernels
# ----------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_query_slice_attention_equals_rows_of_the_whole(tp):
    """Every shard's query slice (whole blocks, ``layers.query_slices``),
    also where S / tp is not a whole number of blocks: the plain
    block-sparse attention's rows equal the whole call's, and the slices'
    counted FLOPs add up to the whole call's."""
    b, hk, g, d, block, s = 2, 2, 3, 16, 16, 16 * 12
    gen = torch.Generator().manual_seed(tp)
    q = torch.randn((b, s, hk, g, d), generator=gen)
    k = torch.randn((b, s, hk, d), generator=gen)
    v = torch.randn((b, s, hk, d), generator=gen)
    sched = ap.block_schedule(ap.pixelfly_attention_block_mask(
        s, s, ap.AttentionPatternConfig(block=block, local_blocks=2, global_blocks=1), causal=True), block, block)
    kv_index, valid = torch.as_tensor(sched.kv_index), torch.as_tensor(sched.valid)
    ops.register_schedule(kv_index, sched.kv_index, sched.valid)
    kw = dict(block=block, causal=True, sm_scale=d ** -0.5)
    whole = ref.sparse_attention(q, k, v, kv_index, valid, **kw)
    slices = L.query_slices(s, tp, block)
    assert slices[0][0] == 0 and slices[-1][1] == s and all(a % block == 0 for a, _ in slices)
    flops = 0.0
    for a0, a1 in slices:
        qs = q[:, a0:a1]
        got = ref.sparse_attention(qs, k, v, kv_index, valid, q_block0=a0 // block, **kw)
        torch.testing.assert_close(got, whole[:, a0:a1], rtol=0, atol=1e-6)
        flops += ops.block_sparse_attention_cost(qs, k, v, kv_index, valid, q_block0=a0 // block, **kw)[0]
    assert flops == ops.block_sparse_attention_cost(q, k, v, kv_index, valid, **kw)[0]


@pytest.mark.parametrize("schedule", ["sparse", "dense"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_partial_scores_then_apply_equal_the_gathered_read(schedule, tp):
    """Each shard's plain partial scores on its head_dim slice, summed in
    rank order, then each shard's plain apply on its value slice, joined
    along head_dim: ``ref.paged_decode_attention_gather`` of the whole
    pools (a poisoned trash page, an idle slot, a partly allocated row)."""
    b, hk, g, d, page, pps = 4, 2, 3, 32, 8, 8
    gen = torch.Generator().manual_seed(tp)
    n_pages = b * pps + 1
    k = torch.randn((n_pages, page, hk, d), generator=gen)
    v = torch.randn((n_pages, page, hk, d), generator=gen)
    k[0], v[0] = 1e4, -1e4
    table = (torch.randperm(n_pages - 1, generator=gen).reshape(b, pps) + 1).to(torch.int32)
    table[1] = 0
    table[2, 3:] = 0
    pos = torch.tensor([pps * page - 1, 0, 3 * page - 2, 5 * page + 1], dtype=torch.int32)
    if schedule == "sparse":
        logical, phys, keep = L.paged_sparse_schedule(table, pos, page, local_blocks=2, global_blocks=1)
    else:
        logical, phys, keep = L.paged_dense_schedule(table)
    q = torch.randn((b, hk, g, d), generator=gen)
    sched = (phys, logical, keep, pos)
    dc = d // tp
    parts = [ops.paged_decode_scores(q[..., r * dc:(r + 1) * dc], k[..., r * dc:(r + 1) * dc], *sched)
             for r in range(tp)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    out = torch.cat([ops.paged_decode_apply(total, v[..., r * dc:(r + 1) * dc], *sched, sm_scale=d ** -0.5)
                     for r in range(tp)], dim=-1)
    want = ref.paged_decode_attention_gather(q, k, v, *sched, sm_scale=d ** -0.5)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# (e) column-cut linears on a replicated input
# ----------------------------------------------------------------------


def test_column_cut_o_down_and_biased_kv_equal_unsharded():
    """At tp 8, smoke qwen3-1.7b's o (4 block rows) and down (4) are cut on
    their blocks' output columns: each shard takes the whole input row, and
    the slices gathered in feature order equal the unsharded ``Linear``
    (the low-rank term through the gathered ``V``). At tp 4, smoke
    qwen2-1.5b's k (2 block rows, a bias the JAX rules cut in contiguous
    rows) joins into the unsharded k, bias included."""
    cfg, _ = _cfgs()
    model = T.init_model(cfg, seed=3, device="cpu")
    sharded = T.shard_model(cfg, make_tp_mesh(8, ["cpu"] * 8), model.state_dict())
    blk = model.layers[0]
    shards = [sh.layers[0] for sh in sharded.shards]
    assert shards[0].attn.wo.cols == (0, 8) and shards[3].mlp.wd.cols == (24, 32)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, cfg.q_dim), generator=gen)
    with torch.no_grad():
        got = L.tp_project([s.attn.wo for s in shards], [x] * 8, whole=True)
        torch.testing.assert_close(got[5], blk.attn.wo(x), rtol=1e-5, atol=1e-5)
        h = torch.randn((3, 5, cfg.d_model), generator=gen)
        hidden = [L.mlp_hidden(s.mlp, h) for s in shards]
        got = L.tp_project([s.mlp.wd for s in shards], hidden, source=shards[0].mlp.wg)
        torch.testing.assert_close(got[7], L.apply_mlp(blk.mlp, h), rtol=1e-5, atol=1e-5)
    q2 = registry.get_smoke("qwen2-1.5b", sparse=True).replace(num_layers=1)
    m2 = T.init_model(q2, seed=4, device="cpu")
    with torch.no_grad():
        m2.layers[0].attn.wk.b.copy_(torch.randn(q2.kv_dim, generator=gen))
    s2 = T.shard_model(q2, make_tp_mesh(4, ["cpu"] * 4), m2.state_dict())
    wks = [sh.layers[0].attn.wk for sh in s2.shards]
    assert wks[1].cols == (16, 32) and wks[1].b.shape == (q2.kv_dim // 4,)
    h = torch.randn((2, 7, q2.d_model), generator=gen)
    with torch.no_grad():
        got = L.tp_whole(wks, [h] * 4)
        torch.testing.assert_close(got[2], m2.layers[0].attn.wk(h), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# (f) what still waits
# ----------------------------------------------------------------------


def test_training_and_a_sequence_cut_cache_name_item_16(tmp_path):
    """Training in the mode runs: a ``Trainer`` step at (1, 4) (S = 16, the
    dense arm at each shard's row offset), the sharded forward's loss at S
    = 128 (two attention blocks over four shards) equal to the unsharded
    one's, and the dry-run's deepseek-67b train cell at tp 16. A decode
    cache cut along the sequence still raises naming item 16, and so does
    a tp that divides neither the kv heads nor head_dim."""
    cfg, _ = _cfgs()
    trainer = Trainer(cfg, OptConfig(), SyntheticLM(cfg.vocab_size, 16, 2), TrainConfig(ckpt_dir=str(tmp_path)),
                      mesh=make_local_mesh(1, 4, ["cpu"] * 4), strategy="tp")
    (h,) = trainer.run(1)
    assert h["step"] == 1 and np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
    whole = T.init_model(cfg, seed=0, device="cpu")
    model = T.shard_model(cfg, make_tp_mesh(4, ["cpu"] * 4), whole.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 129)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    with torch.no_grad():
        got, want = (float(T.forward_train(cfg, m, batch)[0]) for m in (model, whole))
    assert abs(got - want) <= 1e-5 * (1 + abs(want)), (got, want)
    smol = registry.get("smollm-360m", sparse=True)
    shape = next(s for s in registry.shapes_for("smollm-360m", sparse=True) if s.name == "long_500k")
    mesh = dryrun.meta_mesh()
    st = sharding.Strategy(mesh, registry.DEFAULT_STRATEGY["smollm-360m"])
    with pytest.raises(ValueError, match="cut along the sequence.*item 16"):
        dryrun.check_cell(dryrun._prep_cfg(smol, mesh, st), shape, st)
    big = registry.get("deepseek-67b", sparse=True)
    st = sharding.Strategy(mesh, registry.DEFAULT_STRATEGY.get("deepseek-67b", "tp"))
    train = next(s for s in registry.shapes_for("deepseek-67b", sparse=True) if s.kind == "train")
    assert st.tp_size == 16 and L.seq_mode(big, 16)
    dryrun.check_cell(dryrun._prep_cfg(big, mesh, st), train, st)
    with pytest.raises(ValueError, match="neither its 2 kv heads nor its head_dim 64"):
        sharding.check_tp(cfg, 128)
