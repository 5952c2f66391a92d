"""The port's sharding rules and shard-local modules against the JAX
package's (``repro_torch.distributed.sharding`` vs ``repro.distributed.
sharding``), on the CPU.

(a) ``Strategy``, ``param_specs``, ``batch_specs`` and ``cache_specs``
(both layouts) give the JAX specs leaf for leaf, exactly, for every arch
of the registry at smoke and full width (the JAX side from
``jax.eval_shape``, the port's from a meta-device build), both strategies,
on the (1, 2), (1, 8), (16, 16) and (2, 16, 16) meshes (JAX: an
``AbstractMesh``, as ``tests/test_mesh_serving.py`` builds it); a leaf
stacked over a layer group drops its first entry through
``bridge.port_names``. (b) ``shard_state_dict`` and its inverse give back
the state dict bit for bit. (c) Each shard-local module at tp = 2 on the
smoke qwen3-1.7b (fp32) against the unsharded module: the pixelfly linear
on its row slice of the pattern, the heads-mode attention (prefill and
paged decode, plain versions), the vocab-sharded embedding, the logits,
and the output projections (pixelfly column-parallel, dense row-parallel).
(f) The JAX ``paged_impl_for_mesh``'s fallback at tp > 1, which the
port's shard-local pools do without.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed import sharding as jsharding
from repro.kernels.ops import paged_impl_for_mesh as jax_paged_impl_for_mesh
from repro.models import transformer as JT
from repro_torch.bridge import port_names
from repro_torch.configs import registry
from repro_torch.core.pixelfly import linear_tables
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch import mesh as pmesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig

MESHES = {
    "1x2": (("data", "model"), (1, 2)),
    "1x8": (("data", "model"), (1, 8)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite runs several workers
    on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract_mesh(axes, shape):
    try:
        return jax.sharding.AbstractMesh(shape, axes)
    except TypeError:  # jax 0.4.x: tuple of (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


def _strategies(kind):
    for key, (axes, shape) in MESHES.items():
        yield key, jsharding.Strategy(_abstract_mesh(axes, shape), kind), sharding.Strategy(
            pmesh.Mesh(axes, shape), kind
        )


def _cfgs(arch, width, sparse):
    if width == "smoke":
        return jreg.get_smoke(arch, sparse=sparse), registry.get_smoke(arch, sparse=sparse)
    return jreg.get(arch, sparse=sparse), registry.get(arch, sparse=sparse)


def _path(p) -> tuple[str, ...]:
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


def _meta_state_dict(cfg):
    with torch.device("meta"):
        return T.LM(cfg, gen=torch.Generator(), device=torch.device("meta")).state_dict()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_param_specs_equal_jax(arch, width, sparse):
    jcfg, cfg = _cfgs(arch, width, sparse)
    pshape = jax.eval_shape(lambda k: JT.init_model(k, jcfg), jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(pshape)[0]
    sd = _meta_state_dict(cfg)
    for kind in ("tp", "fsdp"):
        for key, jst, st in _strategies(kind):
            assert (st.kind, st.model_axis, st.fsdp, st.batch, st.tp_size) == (
                jst.kind, jst.model_axis, jst.fsdp, jst.batch, jst.tp_size), key
            jspecs = jax.tree_util.tree_flatten_with_path(jsharding.param_specs(jst, pshape))[0]
            got = sharding.param_specs(st, sd)
            want = {}
            for (path, leaf), (_, spec) in zip(leaves, jspecs):
                names, stacked = port_names(cfg, _path(path))
                spec = tuple(spec) + (None,) * (len(leaf.shape) - len(tuple(spec)))
                for name in names:
                    want[name] = spec[1:] if stacked else spec
            assert set(got) == set(want), (arch, key)
            for name, spec in want.items():
                assert tuple(got[name]) == spec, (arch, kind, key, name)


@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_batch_and_cache_specs_equal_jax(arch, width):
    """``batch_specs`` on token batches of several sizes, ``cache_specs``
    on the decode caches (every family) and the paged pools (the
    attention families; the JAX package refuses paged SSM state)."""
    jcfg, cfg = _cfgs(arch, width, True)
    batches = [{"tokens": np.zeros((b, 64), np.int32), "labels": np.zeros((b, 64), np.int32),
                "step": np.zeros((), np.int32)} for b in (1, 2, 16, 32, 512)]
    caches = {"decode": (jax.eval_shape(lambda: JT.init_cache(jcfg, 32, 256)),
                         T.init_cache(cfg, 32, 256, device="meta"))}
    if not cfg.has_ssm:
        caches["paged"] = (jax.eval_shape(lambda: JT.init_paged_cache(jcfg, 9, jcfg.attn_block)),
                           T.init_paged_cache(cfg, 9, cfg.attn_block, device="meta"))
    for kind in ("tp", "fsdp"):
        for key, jst, st in _strategies(kind):
            for batch in batches:
                want = jsharding.batch_specs(jst, batch)
                got = sharding.batch_specs(st, batch)
                assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}, key
            for layout, (jc, pc) in caches.items():
                want = jax.tree_util.tree_flatten_with_path(jsharding.cache_specs(jst, jc, layout=layout))[0]
                got = sharding.cache_specs(st, pc, layout=layout)
                flat = {(str(i), name): tuple(spec) for i, group in enumerate(got) for name, spec in group.items()}
                assert flat == {_path(p): tuple(s) for p, s in want}, (arch, key, layout)
    with pytest.raises(ValueError):
        sharding.cache_specs(st, [], layout="nope")


def _smoke(sparse=True, **kw):
    return registry.get_smoke("qwen3-1.7b", sparse=sparse, **kw)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_shard_state_dict_round_trip(sparse, tp):
    cfg = _smoke(sparse, num_kv_heads=4)
    sd = T.init_model(cfg, seed=3, device="cpu").state_dict()
    mesh = pmesh.make_tp_mesh(tp, ["cpu"] * tp)
    st = sharding.Strategy(mesh, "tp")
    parts = sharding.shard_state_dict(st, mesh, sd)
    assert len(parts) == tp
    specs = sharding.param_specs(st, sd)
    back = sharding.unshard_state_dict(st, parts, specs)
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
    # the layouts the shard-local forms compute: every pixelfly B by its
    # block rows, the token table by vocabulary rows
    for name, t in sd.items():
        d = sharding.model_dim(st, specs[name])
        if name.endswith((".blocks", ".V", "embed.tok")):
            assert d == 0 and parts[1][name].shape[0] == t.shape[0] // tp, name
        if name.endswith((".U", ".scale", "q_norm", "k_norm", ".gamma")):
            assert d is None and parts[1][name] is t, name
    # the model's shards are those state dicts
    model = T.shard_model(cfg, mesh, sd)
    full = sharding.unshard_state_dict(st, [sh.state_dict() for sh in model.shards], specs)
    assert all(torch.equal(full[n], t) for n, t in sd.items())


def _tp2(sparse=True, **kw):
    cfg = _smoke(sparse, **kw)
    model = T.init_model(cfg, seed=1, device="cpu")
    sharded = T.shard_model(cfg, pmesh.make_tp_mesh(2, ["cpu", "cpu"]), model.state_dict())
    return cfg, model, sharded


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=tol, atol=tol)


TOL = 1e-5  # fp32: the shards sum the same products in another order


@torch.no_grad()
def test_pixelfly_linear_shard_holds_global_row_slice():
    cfg, model, sharded = _tp2()
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    for name in ("attn.wq", "attn.wk", "attn.wv", "mlp.wg", "mlp.wu"):
        full = model.layers[0].get_submodule(name)
        parts = [sh.layers[0].get_submodule(name) for sh in sharded.shards]
        cols = full.spec.pattern().cols
        nb = cols.shape[0] // 2
        for r, lin in enumerate(parts):
            assert lin.rows == (r * nb, (r + 1) * nb)
            got_cols = linear_tables(lin.spec, x.device, lin.rows).cols
            assert np.array_equal(got_cols.numpy(), cols[r * nb : (r + 1) * nb])
        _close(torch.cat([lin(x) for lin in parts], dim=-1), full(x), TOL)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@torch.no_grad()
def test_output_projections_and_mlp(sparse):
    """``o`` and ``down`` through ``tp_project`` (column-parallel pixelfly,
    row-parallel dense) and the SwiGLU slices against the whole MLP."""
    cfg, model, sharded = _tp2(sparse)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 4, cfg.d_model, generator=g)
    blk, parts = model.layers[1], [sh.layers[1] for sh in sharded.shards]
    hidden = [L.mlp_hidden(p.mlp, x) for p in parts]
    _close(torch.cat(hidden, dim=-1), L.mlp_hidden(blk.mlp, x), TOL)
    for y in L.tp_project([p.mlp.wd for p in parts], hidden):
        _close(y, L.apply_mlp(blk.mlp, x), TOL)
    o = torch.randn(2, 4, cfg.q_dim, generator=g)
    heads = list(o.chunk(2, dim=-1))
    for y in L.tp_project([p.attn.wo for p in parts], heads):
        _close(y, blk.attn.wo(o), TOL)


@torch.no_grad()
def test_heads_mode_attention_prefill_and_paged_decode():
    """Each shard's heads (its q and kv heads, qk-norm and RoPE per head)
    through ``attention_heads``: the block-sparse prefill and the paged
    decode read (plain versions) on its pools give the unsharded
    attention's heads of that shard."""
    cfg, model, sharded = _tp2()
    g = torch.Generator().manual_seed(4)
    b, s, page = 2, 2 * cfg.attn_block, cfg.attn_block
    x = torch.randn(b, s, cfg.d_model, generator=g)
    cos, sin = L.rope_angles(torch.arange(s)[None].expand(b, s), cfg.head_dim, cfg.rope_theta)
    attn, parts = model.layers[0].attn, [sh.layers[0].attn for sh in sharded.shards]
    o, (k, v) = L.attention_heads(cfg, attn, x, cos, sin, mode="prefill")
    hd = cfg.q_dim // 2
    hk = cfg.num_kv_heads // 2
    for r, part in enumerate(parts):
        o_r, (k_r, v_r) = L.attention_heads(cfg, part, x, cos, sin, mode="prefill")
        _close(o_r, o[..., r * hd : (r + 1) * hd], TOL)
        _close(k_r, k[:, :, r * hk : (r + 1) * hk], TOL)
        _close(v_r, v[:, :, r * hk : (r + 1) * hk], TOL)
    # paged decode: pools holding the prefill's K/V, one slot a row
    n_pages = 1 + b * 4
    pool = {n: torch.randn(n_pages, page, cfg.num_kv_heads, cfg.head_dim, generator=g) for n in ("k", "v")}
    table = torch.arange(1, n_pages, dtype=torch.int32).reshape(b, 4)
    pos = torch.tensor([s, s - 7], dtype=torch.int32)
    index = L.decode_index(cfg, table, pos, page)
    xd = torch.randn(b, 1, cfg.d_model, generator=g)
    cd, sd_ = L.rope_angles(pos.long()[:, None], cfg.head_dim, cfg.rope_theta)
    shard_pools = [{n: t[:, :, r * hk : (r + 1) * hk].clone() for n, t in pool.items()} for r in range(2)]
    o, _ = L.attention_heads(cfg, attn, xd, cd, sd_, mode="decode_paged", cache=pool, index=index, pos=pos)
    for r, part in enumerate(parts):
        o_r, _ = L.attention_heads(cfg, part, xd, cd, sd_, mode="decode_paged", cache=shard_pools[r],
                                   index=index, pos=pos)
        _close(o_r, o[..., r * hd : (r + 1) * hd], TOL)
        for n in ("k", "v"):  # the token's K/V landed in the shard's heads
            assert torch.equal(shard_pools[r][n], pool[n][:, :, r * hk : (r + 1) * hk])


@torch.no_grad()
def test_vocab_sharded_embedding_and_logits():
    cfg, model, sharded = _tp2()
    toks = torch.tensor([[0, 5, 255, 256, 300, cfg.padded_vocab - 1]])
    got = L.embed_tokens_tp([sh.embed for sh in sharded.shards], [toks, toks], sharded.vocab_first)
    want = L.embed_tokens(model.embed, toks)
    for e in got:
        assert torch.equal(e, want)  # one term is the row, the others zero
    h = torch.randn(3, cfg.d_model, generator=torch.Generator().manual_seed(5))
    logits = C.gather([L.lm_logits(cfg, sh.head, sh.embed, h) for sh in sharded.shards], -1, h.device)
    _close(logits, L.lm_logits(cfg, model.head, model.embed, h), TOL)


def test_paged_impl_for_mesh_against_jax():
    """The JAX ``paged_impl_for_mesh`` falls back from the Pallas read to
    the gather at tp > 1 (a ``pallas_call`` has no GSPMD partitioning
    rule). The port has no such function: each shard holds whole pools of
    its own kv heads, so a tensor-parallel engine's read is its device's
    at every tp ("cuda" on the card, the JAX "pallas"; "plain" on the CPU,
    the JAX "gather")."""
    for tp in (1, 2, 4, 8, 16):
        assert jax_paged_impl_for_mesh("gather", tp) == "gather"
        assert jax_paged_impl_for_mesh("pallas", tp) == ("pallas" if tp == 1 else "gather")
    assert not hasattr(ops, "paged_impl_for_mesh")
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=1, vocab_size=256)
    for tp in (1, 2):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=64), mesh=pmesh.make_tp_mesh(tp, ["cpu"] * tp))
        assert (eng.tp, eng.paged_impl) == (tp, "plain")


def test_meshes():
    """The mesh constructors: descriptors of the production meshes, a
    tp mesh that counts its distinct devices, and too few devices."""
    prod = pmesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256 and prod.distinct_devices == 0
    multi = pmesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert pmesh.fsdp_axes(multi) == ("pod", "data") == pmesh.batch_axes(multi)
    m = pmesh.make_tp_mesh(4, ["cpu"] * 4)
    assert m.shape == {"data": 1, "model": 4} and m.distinct_devices == 1
    assert [str(d) for d in m.model_devices()] == ["cpu"] * 4
    with pytest.raises(ValueError, match="tp=4 needs 4 devices, have 3"):
        pmesh.make_tp_mesh(4, ["cpu"] * 3)
    local = pmesh.make_local_mesh(model=2, devices=["cpu"] * 4)
    assert local.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="axes"):
        local.model_devices()
