"""The port's sampler (``repro_torch.serving.sampling``) and its engine's
sampled steps against the JAX package, on the CPU.

- Threefry noise: ``fold_in`` and the random bits equal ``jax.random``'s
  uint32 bits exactly, over many seeds (at and above 2^32 too) and sample
  indices. The Gumbel floats are within 2 ulp of JAX's, with the ulp taken
  at max(|g|, 1): the uniforms are equal bit for bit, and each log differs
  from XLA's float32 log by its rounding, which near g = 0 (where the
  outer log's argument is ~1) is up to one ulp of 1, not of g.
- ``sample_logits`` gives JAX's tokens on the same logits: candidates 64
  and uncapped, top_k, top_p, penalty, temperature 0, ties planted at the
  C-th boundary (value descending, id ascending, as ``lax.top_k``).
- The JAX suite's sampling contracts (``tests/test_sampling.py``),
  re-derived for the port: oracle parity, truncation properties, the
  candidate cap, greedy identity at temperature 0, seeded determinism
  across schedules, one host fetch per step, early-EOS reclamation.
- The port's ``Engine`` gives the JAX ``Engine``'s streams (bridged
  weights, ``make_tp_mesh(1)``) on a sampled mix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_tp_mesh
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import sampling as jsampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry
from repro_torch.serving import sampling as S
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.sampling import SamplingParams, base_key_data, reference_sample, sample_logits

SEEDS = [0, 1, 7, 2**31, 2**32 - 1, 2**32, 2**32 + 5, (1 << 40) + 3, 2**63 - 1, 123456789012345]
IDXS = [0, 1, 2, 5, 63, 1000, 65535, 2**31 - 1]


def _tkey(seed):
    return torch.from_numpy(base_key_data(seed).astype(np.int64))[None]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_equal_jax(seed):
    kd = jnp.asarray(base_key_data(seed))
    np.testing.assert_array_equal(base_key_data(seed), jsampling.base_key_data(seed))
    idx = torch.tensor(IDXS)
    keys = S.fold_in(_tkey(seed).expand(len(IDXS), 2), idx)
    bits = S.random_bits(keys, 257)
    for r, i in enumerate(IDXS):
        jk = jax.random.fold_in(kd, i)
        assert keys[r].numpy().astype(np.uint32).tolist() == np.asarray(jk).tolist()
        want = np.asarray(jax.random.bits(jk, (257,), jnp.uint32))
        np.testing.assert_array_equal(bits[r].numpy().astype(np.uint32), want)


@pytest.mark.parametrize("seed", SEEDS[::2])
def test_gumbel_within_2ulp_of_jax(seed):
    n = 4096
    keys = S.fold_in(_tkey(seed).expand(len(IDXS), 2), torch.tensor(IDXS))
    got = S.gumbel(keys, n).numpy()
    for r, i in enumerate(IDXS):
        want = np.asarray(
            jax.random.gumbel(jax.random.fold_in(jnp.asarray(base_key_data(seed)), i), (n,), jnp.float32)
        )
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert (np.abs(got[r] - want) <= 2 * ulp).all()
        assert np.isfinite(got[r]).all()


# ----------------------------------------------------------------------
# sample_logits against JAX's
# ----------------------------------------------------------------------


def _rows(v, grid, draws, logits, seen):
    b = len(grid) * draws
    rows = dict(
        logits=np.broadcast_to(logits, (b, v)).copy(),
        temp=np.empty((b,), np.float32),
        top_k=np.empty((b,), np.int32),
        top_p=np.empty((b,), np.float32),
        rep=np.empty((b,), np.float32),
        key=np.empty((b, 2), np.uint32),
        idx=np.empty((b,), np.int32),
        seen=np.broadcast_to(seen, (b, v)).copy(),
    )
    for gi, sp in enumerate(grid):
        for d in range(draws):
            r = gi * draws + d
            rows["temp"][r] = sp.temperature
            rows["top_k"][r] = sp.top_k
            rows["top_p"][r] = sp.top_p
            rows["rep"][r] = sp.repetition_penalty
            rows["key"][r] = base_key_data(sp.seed)
            rows["idx"][r] = d
    return rows


def _both(rows, valid_vocab, candidates):
    names = ("logits", "temp", "top_k", "top_p", "rep", "key", "idx", "seen")
    want = np.asarray(
        jsampling.sample_logits(*(jnp.asarray(rows[n]) for n in names), valid_vocab, candidates)
    )
    t = {n: torch.from_numpy(rows[n].astype(np.int64) if n in ("key", "top_k", "idx") else rows[n])
         for n in names}
    got = sample_logits(*(t[n] for n in names), valid_vocab, candidates).numpy()
    return got, want


GRID = [
    SamplingParams(),
    SamplingParams(temperature=0.5, seed=11),
    SamplingParams(temperature=1.3, top_k=7, seed=12),
    SamplingParams(temperature=0.9, top_p=0.8, seed=13),
    SamplingParams(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1, seed=2**40 + 1),
    SamplingParams(temperature=1.0, repetition_penalty=1.4, seed=15),
    SamplingParams(top_k=5, top_p=0.5, repetition_penalty=1.3),  # greedy with a penalty
]


@pytest.mark.parametrize("candidates", [64, None])
@pytest.mark.parametrize("valid_vocab", [None, 1000])
def test_sample_logits_equals_jax(candidates, valid_vocab):
    rng = np.random.default_rng(0)
    v = 1024
    logits = rng.normal(0.0, 3.0, size=(v,)).astype(np.float32)
    seen = rng.random(v) < 0.2
    got, want = _both(_rows(v, GRID, 24, logits, seen), valid_vocab, candidates)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("candidates", [64, None])
def test_sample_logits_ties_at_the_candidate_boundary(candidates):
    """Ranks 50..90 all hold the same value (the 64th candidate sits among
    them), and the top value is tied too: candidates must be taken value
    descending, id ascending, as ``lax.top_k`` takes them."""
    rng = np.random.default_rng(1)
    v = 512
    logits = rng.normal(-4.0, 0.5, size=(v,)).astype(np.float32)
    ids = rng.permutation(v)
    logits[ids[:50]] = np.linspace(4.0, 1.0, 50, dtype=np.float32)
    logits[ids[50:91]] = 0.5
    logits[ids[1]] = logits[ids[0]]
    grid = [SamplingParams(temperature=50.0, seed=3), SamplingParams(temperature=50.0, top_k=60, seed=4),
            SamplingParams(temperature=0.0)]
    got, want = _both(_rows(v, grid, 64, logits, np.zeros(v, bool)), None, candidates)
    np.testing.assert_array_equal(got, want)
    # the greedy rows pick the lower of the two tied maxima
    assert (got[-64:] == min(ids[0], ids[1])).all()


def test_sampler_matches_host_reference():
    """The port's oracle (numpy filtering, same noise) and its sampler
    pick the same token in every (params, draw) cell."""
    rng = np.random.default_rng(0)
    v, draws = 48, 16
    logits = rng.normal(0.0, 3.0, size=(v,)).astype(np.float32)
    seen = rng.random(v) < 0.2
    got, want_jax = _both(_rows(v, GRID, draws, logits, seen), None, None)
    want = [reference_sample(logits, sp, sample_idx=d, seen=seen) for sp in GRID for d in range(draws)]
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, want_jax)


# ----------------------------------------------------------------------
# Truncation properties (JAX suite contracts)
# ----------------------------------------------------------------------


def _draw_many(logits_row, sp: SamplingParams, n: int, candidates=None) -> np.ndarray:
    v = logits_row.shape[-1]
    return sample_logits(
        torch.from_numpy(np.broadcast_to(logits_row, (n, v)).astype(np.float32).copy()),
        torch.full((n,), sp.temperature),
        torch.full((n,), sp.top_k, dtype=torch.int64),
        torch.full((n,), sp.top_p),
        torch.full((n,), sp.repetition_penalty),
        _tkey(sp.seed).expand(n, 2),
        torch.arange(n),
        torch.zeros((n, v), dtype=torch.bool),
        None,
        candidates,
    ).numpy()


def test_sampling_params_validation_and_kind():
    assert SamplingParams().kind == "greedy" and SamplingParams().is_plain
    assert SamplingParams(temperature=0.7, top_k=5, top_p=0.9).kind == "temperature+top_k+top_p"
    assert SamplingParams(top_k=5, top_p=0.5).kind == "greedy"
    pen = SamplingParams(repetition_penalty=1.2)
    assert pen.is_greedy and not pen.is_plain and pen.kind == "greedy+rep_pen"
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5),
                dict(repetition_penalty=0.0), dict(seed=-1)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    # the key depends on the seed alone
    np.testing.assert_array_equal(base_key_data(7), base_key_data(7))
    assert not np.array_equal(base_key_data(7), base_key_data(8))


def test_top_k_truncates_and_covers():
    logits = np.linspace(4.0, -4.0, 16).astype(np.float32)
    toks = _draw_many(logits, SamplingParams(temperature=5.0, top_k=4, seed=3), 256)
    assert set(np.unique(toks)) == set(range(4))


def test_top_p_keeps_smallest_mass_prefix():
    logits = np.log(np.array([0.5, 0.3, 0.1, 0.05, 0.05], np.float32))
    toks = _draw_many(logits, SamplingParams(temperature=1.0, top_p=0.85, seed=5), 512)
    assert set(np.unique(toks)) == {0, 1, 2}
    toks = _draw_many(logits, SamplingParams(temperature=1.0, top_p=0.45, seed=5), 64)
    assert set(np.unique(toks)) == {0}
    toks = _draw_many(logits, SamplingParams(temperature=2.0, seed=6), 2048)
    assert set(np.unique(toks)) == set(range(5))  # top_p off reaches the tail


def test_candidate_cap_truncates_to_top_c():
    logits = np.linspace(3.0, -3.0, 32).astype(np.float32)
    sp = SamplingParams(temperature=8.0, seed=9)
    toks = _draw_many(logits, sp, 256, candidates=4)
    assert set(np.unique(toks)) == set(range(4))  # confined and covered
    want = [reference_sample(logits, sp, sample_idx=d, candidates=4) for d in range(8)]
    np.testing.assert_array_equal(toks[:8], want)


def test_repetition_penalty_discourages_seen_tokens():
    logits = torch.zeros((1, 8))
    logits[0, 0], logits[0, 1] = 2.0, 1.9
    seen = torch.zeros((1, 8), dtype=torch.bool)
    seen[0, 0] = True

    def greedy_with(rep):
        return int(sample_logits(logits, torch.zeros(1), torch.zeros(1, dtype=torch.int64), torch.ones(1),
                                 torch.full((1,), rep), _tkey(0), torch.zeros(1, dtype=torch.int64), seen)[0])

    assert greedy_with(1.0) == 0
    assert greedy_with(1.5) == 1


# ----------------------------------------------------------------------
# Engine
# ----------------------------------------------------------------------


def _cfg(**kw):
    return registry.get_smoke("qwen3-1.7b", num_layers=2, vocab_size=128, **kw)


def test_engine_rejects_top_k_beyond_candidate_cap():
    eng = Engine(_cfg(), engine_cfg=EngineConfig(max_slots=1, max_len=64, sampler_candidates=8), device="cpu")
    with pytest.raises(ValueError, match="candidate cap"):
        eng.submit(np.arange(4), 2, sampling=SamplingParams(temperature=1.0, top_k=9))
    eng.submit(np.arange(4), 2, sampling=SamplingParams(temperature=1.0, top_k=8))
    eng.submit(np.arange(4), 2, sampling=SamplingParams(top_k=9))  # greedy never reads top_k


def test_temperature_zero_exact_greedy_parity():
    """temperature 0 with top_k/top_p knobs set gives the plain greedy
    streams, and counts as greedy."""
    cfg = _cfg(sparse_attention=True)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(3, 8), dtype=np.int32)
    plain = Engine(cfg, engine_cfg=EngineConfig(max_slots=3, max_len=128), device="cpu")
    knobs = Engine(cfg, engine_cfg=EngineConfig(max_slots=3, max_len=128), device="cpu")
    for b in range(3):
        plain.submit(prompts[b], 5)
        knobs.submit(prompts[b], 5, sampling=SamplingParams(top_k=3, top_p=0.9, seed=b))
    want = [f.tokens.tolist() for f in sorted(plain.drain(max_steps=50), key=lambda f: f.uid)]
    got = [f.tokens.tolist() for f in sorted(knobs.drain(max_steps=50), key=lambda f: f.uid)]
    assert got == want
    assert knobs.stats_summary()["by_sampler"] == {"greedy": {"requests": 3, "tokens": 15}}


def test_seeded_determinism_across_admission_and_buckets():
    cfg = _cfg(sparse_attention=True)
    page = cfg.attn_block
    rng = np.random.default_rng(23)
    reqs = [
        (rng.integers(0, cfg.vocab_size, p).astype(np.int32),
         SamplingParams(temperature=0.9, top_k=25, top_p=0.95, seed=100 + i))
        for i, p in enumerate([6, 11, page + 3, 9, 2 * page + 1])
    ]
    eng_a = Engine(cfg, engine_cfg=EngineConfig(max_slots=4, max_len=4 * page), device="cpu")
    uids_a = {eng_a.submit(p, 6, sampling=sp): i for i, (p, sp) in enumerate(reqs)}
    toks_a = {uids_a[f.uid]: f.tokens.tolist() for f in eng_a.drain(max_steps=80)}
    eng_b = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=4 * page), device="cpu")
    fins_b, uids_b = [], {}
    for i in reversed(range(len(reqs))):
        p, sp = reqs[i]
        uids_b[eng_b.submit(p, 6, sampling=sp)] = i
        fins_b += eng_b.step() + eng_b.step()
    fins_b += eng_b.drain(max_steps=120)
    toks_b = {uids_b[f.uid]: f.tokens.tolist() for f in fins_b}
    assert toks_a == toks_b and sorted(toks_a) == list(range(len(reqs)))
    assert list(eng_a.stats_summary()["by_sampler"]) == ["temperature+top_k+top_p"]


def test_sampled_decode_same_host_fetches_as_greedy():
    """The sampler runs on the device: a sampled trace makes exactly as
    many prefill calls, decode steps and device fetches as the greedy one
    (one fetch per prefill call and per decode step), and the sampler
    never reads a device value on the host."""
    cfg = _cfg()
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(3, 8), dtype=np.int32)

    def serve(sampling):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=3, max_len=64), device="cpu")
        for b in range(3):
            eng.submit(prompts[b], 6, sampling=sampling)
        assert len(eng.drain(max_steps=40)) == 3
        st = eng.stats_summary()
        return {"host_syncs": st["dispatch_guard"]["host_syncs"],
                **{k: st[k] for k in ("prefill_calls", "decode_steps")}}

    greedy = serve(None)
    assert greedy["host_syncs"] == greedy["prefill_calls"] + greedy["decode_steps"]
    real_item = torch.Tensor.item
    calls = []
    # MonkeyPatch deletes the class attribute again on exit (``item`` is
    # inherited, not in torch.Tensor.__dict__), so no later test in this
    # process sees it set on torch.Tensor
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "item", lambda self: (calls.append("item"), real_item(self))[1])
        sampled = serve(SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=5))
    assert sampled == greedy
    assert calls == []  # no .item() anywhere on the sampled path


def test_eos_early_finish_reclaims_budget_pages():
    cfg = _cfg()
    page = cfg.attn_block
    rng = np.random.default_rng(31)
    prompt_a = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    prompt_b = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)

    def run(eos_id):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=2 * page, n_pages=3), device="cpu")
        ua = eng.submit(prompt_a, page, eos_id=eos_id)
        ub = eng.submit(prompt_b, page)
        fins = {f.uid: f for f in eng.drain(max_steps=200)}
        return fins[ua], fins[ub], eng.stats

    fin_a, fin_b, st = run(None)
    assert st.pages_reclaimed_early == 0
    eos = int(fin_a.tokens[1])
    k = [int(t) for t in fin_a.tokens].index(eos)
    fin_a2, fin_b2, st2 = run(eos)
    assert fin_a2.finish_reason == "eos" and len(fin_a2.tokens) == k + 1
    assert st2.pages_reclaimed_early == 1
    assert fin_b2.admit_step < fin_b.admit_step


def test_engine_sampled_mix_equals_jax_engine():
    """Temperature 0.8, top_k 40, top_p 0.95, repetition penalty 1.1 and
    per-request seeds, beside temperature-0 rows (one with a penalty),
    over several buckets and slot reuse: the port's streams equal the JAX
    engine's on bridged weights."""
    jcfg = jreg.get_smoke("qwen3-1.7b", sparse=True, num_layers=2)
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True, num_layers=2)
    page = cfg.attn_block
    rng = np.random.default_rng(5)
    work = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), g)
            for n, g in ((30, 8), (page + 9, 6), (3 * page + 2, 7), (12, 9), (2 * page, 5), (5, 6))]
    knobs = dict(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1)

    def params(i, cls):
        if i % 3 == 2:
            return cls(repetition_penalty=1.2) if i == 2 else None
        return cls(seed=1000 + 977 * i, **knobs)

    ecfg = dict(max_slots=3, max_len=6 * page)
    jeng = JEngine(jcfg, make_tp_mesh(1), engine_cfg=JEngineConfig(**ecfg))
    juids = {jeng.submit(p, g, sampling=params(i, JSamplingParams)): i for i, (p, g) in enumerate(work)}
    want = {juids[f.uid]: f.tokens.tolist() for f in jeng.drain(max_steps=200)}
    sd = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg, "cpu")
    eng = Engine(cfg, engine_cfg=EngineConfig(**ecfg), params=sd, device="cpu")
    uids = {eng.submit(p, g, sampling=params(i, SamplingParams)): i for i, (p, g) in enumerate(work)}
    got = {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=200)}
    assert got == want
    assert set(eng.stats_summary()["by_sampler"]) == {"temperature+top_k+top_p+rep_pen", "greedy", "greedy+rep_pen"}
