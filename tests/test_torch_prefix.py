"""The port's prefix cache against the JAX package, on the CPU: the
refcounted page sharing of ``PagedKVCache``, copy on write, the radix
tree (``serving.prefix``), partial prefill (``prefill_paged`` with
``prefix_rows``, ``layers.prefix_flash_attention``, ``_pixelfly_visible``)
and the engine's prefix-aware admission.

The contracts are the JAX suite's (``tests/test_prefix_cache.py``),
re-derived for the port; partial prefill and the attention are held
against the JAX functions on the same inputs (tolerance 1e-5 in float32),
and the engine with the cache on against the JAX engine (bridged weights,
``make_tp_mesh(1)``): equal streams, equal hits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.core import attn_pattern as ap
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler


def _cfg(**kw):
    return registry.get_smoke("qwen3-1.7b", num_layers=2, vocab_size=128, **kw)


def _tiny_cfg(page=4):
    return registry.get_smoke(
        "qwen3-1.7b", num_layers=1, num_heads=2, num_kv_heads=1, head_dim=8, attn_block=page
    )


# ----------------------------------------------------------------------
# Refcounted allocator
# ----------------------------------------------------------------------


def test_cow_page_copies_device_content_and_remaps():
    cfg = _tiny_cfg()
    kv = PagedKVCache(cfg, max_slots=2, max_len=4 * cfg.attn_block, device="cpu")
    kv.alloc_upto(0, kv.page - 1)
    src = int(kv.page_table[0, 0])
    for pool in kv.buffers:
        pool["k"][:, src] = 7.5
        pool["v"][:, src] = -3.25
    kv.incref(src)  # a second reference, as if mapped into another slot
    free_before = kv.free_pages
    dst = kv.cow_page(0, 0)
    assert dst != src and kv.page_table[0, 0] == dst
    assert kv.refcount(dst) == 1 and kv.refcount(src) == 1
    assert kv.free_pages == free_before - 1
    for pool in kv.buffers:
        assert torch.equal(pool["k"][:, dst], pool["k"][:, src])
        assert (pool["v"][:, dst] == -3.25).all()
    kv.unpin(src)  # the phantom holder drops its pin -> parked
    assert kv.is_cached(src)


def test_alloc_upto_atomic_rollback_on_exhaustion():
    cfg = _tiny_cfg()
    page = cfg.attn_block
    kv = PagedKVCache(cfg, max_slots=2, max_len=4 * page, n_pages=6, device="cpu")
    kv.alloc_upto(0, 3 * page - 1)
    with pytest.raises(RuntimeError):
        kv.alloc_upto(1, 3 * page - 1)
    assert kv.pages_owned(1) == 0 and (kv.page_table[1] == 0).all() and kv.free_pages == 2
    kv.alloc_upto(1, page - 1)
    first = int(kv.page_table[1, 0])
    with pytest.raises(RuntimeError):
        kv.alloc_upto(1, 4 * page - 1)
    assert kv.pages_owned(1) == 1 and kv.page_table[1, 0] == first and kv.free_pages == 1
    assert kv.refcount(first) == 1
    kv.free_slot(0), kv.free_slot(1)
    assert kv.free_pages == kv.n_pages - 1


# ----------------------------------------------------------------------
# Radix tree
# ----------------------------------------------------------------------


def test_radix_match_insert_and_suffix_cap():
    cfg = _tiny_cfg()
    page = cfg.attn_block
    kv = PagedKVCache(cfg, max_slots=2, max_len=4 * page, device="cpu")
    pc = PrefixCache(kv)
    prompt = np.random.default_rng(0).integers(0, 50, 3 * page + 2).astype(np.int32)
    assert pc.match(prompt) == []
    kv.alloc_upto(0, prompt.size - 1)
    pc.insert(prompt, kv.page_table[0])
    assert pc.nodes == 3  # full blocks only
    assert pc.match(prompt) == [int(kv.page_table[0, i]) for i in range(3)]
    assert len(pc.match(prompt[: 3 * page])) == 2  # >= 1 suffix token left
    assert len(pc.match(prompt[: page + 1])) == 1
    other = prompt.copy()
    other[page + 3] += 1
    assert len(pc.match(other)) == 1


def test_radix_lru_evicts_leaves_first():
    cfg = _tiny_cfg()
    page = cfg.attn_block
    kv = PagedKVCache(cfg, max_slots=3, max_len=4 * page, device="cpu")
    pc = PrefixCache(kv)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 50, 2 * page + 1).astype(np.int32)
    b = rng.integers(50, 100, 2 * page + 1).astype(np.int32)
    for slot, prompt in ((0, a), (1, b)):
        kv.alloc_upto(slot, prompt.size - 1)
        pc.insert(prompt, kv.page_table[slot])
        kv.free_slot(slot, keep=pc.page_in_tree)
    assert kv.cached_pages == 4 and kv.free_pages == kv.n_pages - 5
    a_pages = pc.match(a)  # B is now least recently used
    assert pc.ensure_free(kv.free_pages + 2)
    assert pc.match(b) == [] and pc.match(a) == a_pages
    assert pc.ensure_free(kv.free_pages + 2)
    assert not pc.ensure_free(kv.free_pages + 1)
    assert kv.cached_pages == 0 and pc.stats.evicted_pages == 4


# ----------------------------------------------------------------------
# Partial prefill and its attention
# ----------------------------------------------------------------------


@pytest.mark.parametrize("local,glob,stride", [(2, 1, 0), (1, 0, 0), (1, 2, 4), (3, 1, 2)])
def test_elementwise_pixelfly_mask_matches_reference(local, glob, stride):
    block = 4
    for nb in (1, 2, 4, 8, 16):
        ref = ap.pixelfly_attention_block_mask(
            nb * block, nb * block,
            ap.AttentionPatternConfig(block=block, local_blocks=local, max_stride=stride, global_blocks=glob),
            causal=True,
        )
        qb = torch.arange(nb)
        got = L._pixelfly_visible(
            (qb[:, None] * block + block - 1), (qb[None, :] * block),
            block=block, local_blocks=local, global_blocks=glob, max_stride=stride,
        )
        np.testing.assert_array_equal(got.numpy(), ref)
        want = JL._pixelfly_visible(
            jnp.asarray(qb.numpy()[:, None] * block + block - 1), jnp.asarray(qb.numpy()[None, :] * block),
            block=block, local_blocks=local, global_blocks=glob, max_stride=stride,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_prefix_flash_attention_equals_jax(sparse, chunk):
    """Ragged prefix lengths (0, 1, 2 and 3 blocks of a 3-block prefix
    buffer whose tail is poisoned trash), GQA 2, sparse and dense masks."""
    rng = np.random.default_rng(4)
    b, sq, hk, g, d, block = 4, 32, 2, 2, 16, 8
    lp = 3 * block
    q = rng.standard_normal((b, sq, hk, g, d)).astype(np.float32)
    ks, vs = (rng.standard_normal((b, sq, hk, d)).astype(np.float32) for _ in range(2))
    kp, vp = (rng.standard_normal((b, lp, hk, d)).astype(np.float32) for _ in range(2))
    plen = np.array([0, block, 2 * block, 3 * block], np.int32)
    for i, n in enumerate(plen):
        kp[i, n:], vp[i, n:] = 1e4, -1e4
    block_cfg = (block, 2, 1, 0) if sparse else None
    kw = dict(sm_scale=d ** -0.5, chunk=chunk, block_cfg=block_cfg)
    want = JL.prefix_flash_attention_jnp(*(jnp.asarray(a) for a in (q, ks, vs, kp, vp, plen)), **kw)
    got = L.prefix_flash_attention(*(torch.from_numpy(a) for a in (q, ks, vs, kp, vp, plen)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_partial_prefill_matches_full_prefill_and_jax(sparse):
    """Suffix-only prefill over shared prefix pages: the last-token logits
    and the suffix K/V pages equal the full prefill's and the JAX partial
    prefill's (1e-5), and the shared prefix pages are not written: the
    padding tail scattered with the suffix lands on fresh pages."""
    jcfg = jreg.get_smoke("qwen3-1.7b", num_layers=2, vocab_size=128, sparse_attention=sparse)
    cfg = _cfg(sparse_attention=sparse)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    model = T.init_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    page = cfg.attn_block
    plen = 2 * page + 17
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, plen).astype(np.int32)
    kv = PagedKVCache(cfg, max_slots=2, max_len=4 * page, device="cpu")
    kv.alloc_upto(0, plen - 1)
    tokens = np.zeros((1, 4 * page), np.int32)
    tokens[0, :plen] = prompt
    ref_logits, _ = T.prefill_paged(cfg, model, torch.from_numpy(tokens), torch.tensor([plen]),
                                    kv.buffers, torch.from_numpy(kv.bucket_row(0, plen, 4))[None])
    npre = 2
    pre = [int(kv.page_table[0, i]) for i in range(npre)]
    for p in pre:
        kv.incref(p)
    kv.adopt(1, pre)
    kv.alloc_upto(1, plen - 1)
    before = [{n: t[:, pre].clone() for n, t in pool.items()} for pool in kv.buffers]
    suf = np.zeros((1, page), np.int32)
    suf[0, : plen - npre * page] = prompt[npre * page:]
    args = dict(prefix_rows=np.asarray([pre], np.int32), prefix_lens=np.asarray([npre * page], np.int32))
    rows = kv.suffix_row(1, npre, plen, 1)[None]
    got_logits, _ = T.prefill_paged(
        cfg, model, torch.from_numpy(suf), torch.tensor([plen - npre * page]), kv.buffers,
        torch.from_numpy(rows), **{k: torch.from_numpy(v) for k, v in args.items()},
    )
    torch.testing.assert_close(got_logits, ref_logits, rtol=1e-5, atol=1e-5)
    for pool, old in zip(kv.buffers, before):
        for n in ("k", "v"):
            torch.testing.assert_close(pool[n][:, kv.page_table[1, npre]], pool[n][:, kv.page_table[0, npre]],
                                       rtol=1e-5, atol=1e-5)
            assert torch.equal(pool[n][:, pre], old[n])  # shared pages untouched
    # the JAX partial prefill on the same weights and pool contents
    jbufs = [{n: jnp.asarray(t.numpy()) for n, t in pool.items()} for pool in kv.buffers]
    jlogits, _ = JT.prefill_paged(jcfg, jparams, jnp.asarray(suf), jnp.asarray([plen - npre * page]), jbufs,
                                  jnp.asarray(rows), **{k: jnp.asarray(v) for k, v in args.items()})
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# Engine
# ----------------------------------------------------------------------


def _shared_prefix_trace(cfg, rng, n, sys_pages=(1, 2)):
    page = cfg.attn_block
    sys_prompts = [rng.integers(0, cfg.vocab_size, k * page).astype(np.int32) for k in sys_pages]
    out = []
    for _ in range(n):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(3, page))).astype(np.int32)
        r = int(rng.integers(0, len(sys_prompts) + 1))
        prompt = tail if r == len(sys_prompts) else np.concatenate([sys_prompts[r], tail])
        out.append((prompt, int(rng.integers(2, 6))))
    return out


def _serve_bursts(eng, trace, sampling_for, seed=7):
    """Submit ``trace`` in random bursts between steps (the same bursts for
    every engine given the same seed) -> {index: (tokens, hit tokens)}."""
    srng = np.random.default_rng(seed)
    uids, out, pending, k = {}, {}, list(trace), 0
    while pending or not eng.scheduler.idle:
        burst = int(srng.integers(1, 4))
        for prompt, gen in pending[:burst]:
            uids[eng.submit(prompt, gen, sampling=sampling_for(k))] = k
            k += 1
        pending = pending[burst:]
        for f in eng.step():
            out[uids[f.uid]] = (f.tokens.tolist(), f.prefix_hit_tokens)
    return out


@pytest.mark.parametrize("sampled", [False, True])
def test_engine_prefix_on_off_identical_streams(sampled):
    cfg = _cfg(sparse_attention=True)
    page = cfg.attn_block
    trace = _shared_prefix_trace(cfg, np.random.default_rng(23), 10)

    def sampling_for(k):
        return SamplingParams(temperature=0.9, top_k=25, top_p=0.9, seed=1000 + k) if sampled and k % 2 else None

    streams = {}
    for on in (False, True):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=3, max_len=4 * page, prefix_cache=on),
                     seed=3, device="cpu")
        streams[on] = _serve_bursts(eng, trace, sampling_for)
        assert eng.kv.free_pages + eng.kv.cached_pages == eng.kv.n_pages - 1
        assert (eng.kv.cached_pages > 0) == on
    assert {k: v[0] for k, v in streams[True].items()} == {k: v[0] for k, v in streams[False].items()}
    assert any(hit for _, hit in streams[True].values())
    assert all(hit == 0 for _, hit in streams[False].values())


def test_engine_prefix_hit_prefills_only_suffix(monkeypatch):
    cfg = _cfg()
    page = cfg.attn_block
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=4 * page, prefix_cache=True), device="cpu")
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(0, cfg.vocab_size, 2 * page).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, 9).astype(np.int32) for _ in range(2)]
    eng.submit(np.concatenate([sys_prompt, tails[0]]), 2)
    assert eng.drain(max_steps=20)[0].prefix_hit_tokens == 0
    calls = []
    real = T.prefill_paged

    def counting(cfg_, model, tokens, plens, caches, rows, **kw):
        pre = kw.get("prefix_rows")
        calls.append((tuple(tokens.shape), None if pre is None else tuple(pre.shape)))
        return real(cfg_, model, tokens, plens, caches, rows, **kw)

    monkeypatch.setattr(T, "prefill_paged", counting)
    eng.reset_stats()
    eng.submit(np.concatenate([sys_prompt, tails[1]]), 2)
    f1 = eng.drain(max_steps=20)[0]
    assert f1.prefix_hit_tokens == 2 * page
    assert calls == [((1, page), (1, 2))]  # one partial prefill: 1 suffix page, 2 prefix pages
    st = eng.stats
    assert st.prefill_tokens == 9
    assert st.prefix_hit_tokens == 2 * page and st.prefix_prompt_tokens == 2 * page + 9


def test_engine_decode_pages_indexed_for_multi_turn_chat():
    cfg = _cfg()
    page = cfg.attn_block
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=6 * page, prefix_cache=True), device="cpu")
    rng = np.random.default_rng(5)
    user1 = rng.integers(0, cfg.vocab_size, page).astype(np.int32)
    eng.submit(user1, page + 1)
    f1 = eng.drain(max_steps=200)[0]
    assert eng.stats.decode_indexed_pages == 1
    eng.submit(np.concatenate([user1, f1.tokens, rng.integers(0, cfg.vocab_size, page).astype(np.int32)]), 4)
    assert eng.drain(max_steps=40)[0].prefix_hit_tokens == 2 * page
    assert eng.stats.prefix_hit_pages == 2


def test_engine_prefix_eviction_never_blocks_admission():
    cfg = _cfg()
    page = cfg.attn_block
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=2 * page, prefix_cache=True), device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(2):
        eng.submit(rng.integers(0, cfg.vocab_size, page + 3).astype(np.int32), 2)
    eng.drain(max_steps=30)
    assert eng.kv.cached_pages >= 2
    for _ in range(2):
        eng.submit(rng.integers(0, cfg.vocab_size, 2 * page - 2).astype(np.int32), 2)
    assert len(eng.drain(max_steps=40)) == 2
    assert eng._prefix.stats.evicted_pages > 0
    assert eng.kv.free_pages + eng.kv.cached_pages == eng.kv.n_pages - 1


def test_engine_cow_guard_preserves_stream():
    cfg = _cfg()
    page = cfg.attn_block
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, page + 4, dtype=np.int32)
    ecfg = EngineConfig(max_slots=2, max_len=2 * page, prefix_cache=True)
    ref_eng = Engine(cfg, engine_cfg=ecfg, device="cpu")
    ref_eng.submit(prompt, 5)
    ref = ref_eng.drain(max_steps=20)[0].tokens
    eng = Engine(cfg, engine_cfg=ecfg, device="cpu")
    eng.submit(prompt, 5)
    eng.step()
    slot = eng.scheduler.active()[0].slot
    shared = int(eng.kv.page_table[slot, 1])  # the partial write page
    eng.kv.incref(shared)  # phantom second owner
    eng.step()  # the next decode write targets the shared page -> copy
    assert eng.stats.cow_copies == 1
    assert int(eng.kv.page_table[slot, 1]) != shared and eng.kv.refcount(shared) == 1
    np.testing.assert_array_equal(eng.drain(max_steps=20)[0].tokens, ref)
    eng.kv.unpin(shared)


def test_cow_reserve_survives_oversubscribed_pool():
    cfg = _cfg()
    page = cfg.attn_block
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, page + 4, dtype=np.int32)
    small = rng.integers(0, cfg.vocab_size, 4, dtype=np.int32)
    ref_eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=2 * page), device="cpu")
    ref_eng.submit(prompt, 5)
    ref = ref_eng.drain(max_steps=30)[0].tokens
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=2 * page, prefix_cache=True,
                                              n_pages=4, preemption=False), device="cpu")
    eng.submit(prompt, 5)
    eng.drain(max_steps=30)
    assert eng.kv.cached_pages == 1
    eng.submit(prompt, 5)
    eng.step()
    slot = eng.scheduler.active()[0].slot
    assert eng._cow_reserve[slot] == 1 and eng._page_need[slot] == 3
    eng.submit(small, 3)
    eng.step()  # the small request would eat the reserve: it waits
    assert len(eng.scheduler.active()) == 1 and len(eng.scheduler.waiting) == 1
    shared = int(eng.kv.page_table[slot, 1])
    eng.kv.incref(shared)
    eng.step()
    assert eng.stats.cow_copies == 1
    assert eng._cow_reserve[slot] == 0 and eng._page_need[slot] == 2
    fins = {f.uid: f for f in eng.drain(max_steps=60)}
    eng.kv.unpin(shared)
    np.testing.assert_array_equal(fins[2].tokens, ref)
    assert fins[3].finish_reason in ("length", "eos")


def test_pool_filling_request_declines_hit_instead_of_deadlocking():
    cfg = _cfg()
    page = cfg.attn_block
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, page + 4, dtype=np.int32)
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=2 * page, prefix_cache=True,
                                              n_pages=3, preemption=False), device="cpu")
    eng.submit(prompt, 5)
    eng.drain(max_steps=30)
    assert eng.kv.cached_pages == 1
    eng.submit(prompt, 5)
    fins = eng.drain(max_steps=30)
    assert len(fins) == 1 and fins[0].prefix_hit_tokens == 0


def test_engine_prefix_mix_equals_jax_engine():
    """A shared-prefix trace in bursts, half of it sampled, prefix cache
    on: the port's streams and hit tokens equal the JAX engine's."""
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=True, num_layers=2)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True, num_layers=2)
    page = cfg.attn_block
    trace = _shared_prefix_trace(cfg, np.random.default_rng(29), 8, sys_pages=(2, 3))
    knobs = dict(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1)
    ecfg = dict(max_slots=3, max_len=6 * page, prefix_cache=True)
    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg))
    want = _serve_bursts(jeng, trace, lambda k: JSamplingParams(seed=50 + k, **knobs) if k % 2 else None)
    sd = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = Engine(cfg, engine_cfg=EngineConfig(**ecfg), params=sd, device="cpu")
    got = _serve_bursts(eng, trace, lambda k: SamplingParams(seed=50 + k, **knobs) if k % 2 else None)
    assert got == want
    assert sum(hit > 0 for _, hit in got.values()) >= 3


# ----------------------------------------------------------------------
# Anti-starvation aging
# ----------------------------------------------------------------------


def test_scheduler_skip_counters():
    sch = Scheduler(1)
    reqs = [Request(i, np.array([1, 2]), 2) for i in range(3)]
    for r in reqs:
        sch.submit(r)
    sch.note_skips([reqs[0], reqs[2]])
    sch.note_skips([reqs[0]])
    assert [sch.skip_count(r) for r in reqs] == [2, 0, 1]
    sch.admit(0)  # admitting clears the counter
    assert sch.skip_count(reqs[0]) == 0


def test_engine_aging_stops_admitting_around_starved_request():
    """After ``max_skips`` passes of being admitted around, a skipped
    request becomes a barrier; with aging off every small request jumps
    it."""
    cfg = _cfg()
    page = cfg.attn_block

    def serve(max_skips):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=3, max_len=3 * page, n_pages=6,
                                                  max_skips=max_skips), device="cpu")
        rng = np.random.default_rng(13)
        eng.submit(rng.integers(0, cfg.vocab_size, 2 * page + 4), 3 * page)  # holds 3 pages
        eng.step()
        big = eng.submit(rng.integers(0, cfg.vocab_size, 2 * page + 4), 3)  # needs 3, 2 free
        smalls = [eng.submit(rng.integers(0, cfg.vocab_size, 6), 2) for _ in range(4)]
        return big, smalls, {f.uid: f for f in eng.drain(max_steps=300)}

    big, smalls, fins = serve(max_skips=1)
    early = [u for u in smalls if fins[u].admit_step < fins[big].admit_step]
    assert len(early) <= 2 and len(early) < len(smalls)
    big, smalls, fins = serve(max_skips=0)
    assert all(fins[u].admit_step < fins[big].admit_step for u in smalls)
