"""Card-only tests: each CUDA kernel of the port against its plain PyTorch
version on the same CUDA tensors, and the smoke-width engine's greedy
streams on the card against the CPU's. bf16 takes the tensor-core paths
(and, for bsr at M <= 16, the cluster-reduced decode kernel), float32 the
SIMT kernels; tolerances: bsr 2e-2 bf16 / 1e-4 fp32, attention 2e-2 /
2e-4, paged decode 1e-2 / 1e-5.

Marked ``gpu``. Whether a card is present is decided in the ``cuda``
fixture, never at import, so every test process collects the same tests;
without a card they skip. Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import attn_pattern as ap
from repro_torch.core import butterfly as bf
from repro_torch.kernels import ref
from repro_torch.kernels.bsr_attention import block_sparse_attention_cuda
from repro_torch.kernels.bsr_matmul import bsr_matmul_cuda
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.models.layers import linear_spec, paged_dense_schedule, paged_sparse_schedule
from repro_torch.serving.engine import Engine, EngineConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dtype, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("m", [1, 8, 37, 300])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_bsr_matmul_kernel(cuda, m, block, dtype, tol):
    rng = np.random.default_rng(m + block)
    pat = bf.make_pattern(4 * block, 8 * block, block=block, max_stride=4)
    x = _t(rng.standard_normal((m, 8 * block)), dtype, cuda)
    blocks = _t(rng.standard_normal((pat.nb_out, pat.r, block, block)) / np.sqrt(pat.r * block), dtype, cuda)
    cols = torch.as_tensor(pat.cols, device=cuda)
    got = bsr_matmul_cuda(x, blocks, cols)
    assert _err(got, ref.bsr_matmul_gather(x, blocks, cols)) <= tol


def _main_bsr(label, m, dtype, dev, seed=0):
    """x, blocks, cols of one full-width qwen3-1.7b linear: q (r = 2) or
    down (r = 7), b = 128."""
    full = registry.get("qwen3-1.7b", sparse=True)
    n_in, n_out = {"q": (full.d_model, full.q_dim), "down": (full.d_ff, full.d_model)}[label]
    pat = linear_spec(full, n_in, n_out, False).pattern()
    rng = np.random.default_rng(seed + m)
    x = _t(rng.standard_normal((m, n_in)), dtype, dev)
    blocks = _t(rng.standard_normal((pat.nb_out, pat.r, pat.block, pat.block)) / np.sqrt(pat.r * pat.block),
                dtype, dev)
    return x, blocks, torch.as_tensor(pat.cols, device=dev), pat


@pytest.mark.parametrize("m", [1, 8, 16, 17, 300, 4095, 4096])
@pytest.mark.parametrize("label,r", [("q", 2), ("down", 7)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_bsr_matmul_kernel_main_shapes(cuda, m, label, r, dtype, tol):
    x, blocks, cols, pat = _main_bsr(label, m, dtype, cuda)
    assert (pat.r, pat.block) == (r, 128)
    got = bsr_matmul_cuda(x, blocks, cols)
    assert _err(got, ref.bsr_matmul_gather(x, blocks, cols)) <= tol


@pytest.mark.parametrize("m", [8, 16, 4096])
def test_bsr_matmul_kernel_same_bits_twice(cuda, m):
    x, blocks, cols, _ = _main_bsr("down", m, torch.bfloat16, cuda)
    assert torch.equal(bsr_matmul_cuda(x, blocks, cols), bsr_matmul_cuda(x, blocks, cols))


def test_bsr_matmul_kernel_refuses_misaligned(cuda):
    x, blocks, cols, _ = _main_bsr("q", 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        bsr_matmul_cuda(x[:, 1:], blocks, cols)  # a view, not contiguous
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = buf[1:].view(x.shape)  # contiguous, 2 bytes off
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bsr_matmul_cuda(shifted, blocks, cols)


def test_bsr_matmul_kernel_refuses_small_blocks(cuda):
    x = torch.zeros((4, 64), device=cuda)
    with pytest.raises(ValueError, match="64 and 128"):
        bsr_matmul_cuda(x, torch.zeros((2, 1, 32, 32), device=cuda),
                        torch.zeros((2, 1), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_paged_decode_kernel(cuda, g, dtype, tol):
    rng = np.random.default_rng(g)
    b, hk, d, page, pps = 5, 2, 64, 16, 8
    n_pages = b * pps + 1
    k = rng.standard_normal((n_pages, page, hk, d))
    v = rng.standard_normal((n_pages, page, hk, d))
    k[0], v[0] = 1e4, -1e4  # poisoned trash page
    table = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(b, pps).astype(np.int32)
    table[1] = 0  # idle slot
    table[2, 2:] = 0  # partially allocated row
    pos = np.array([pps * page - 1, 0, 2 * page - 3, 5 * page + 7, 37], np.int32)
    q = _t(rng.standard_normal((b, hk, g, d)), dtype, cuda)
    kp, vp = _t(k, dtype, cuda), _t(v, dtype, cuda)
    table_t = torch.as_tensor(table, device=cuda)
    pos_t = torch.as_tensor(pos, device=cuda)
    logical, phys, keep = paged_sparse_schedule(table_t, pos_t, page, local_blocks=2, global_blocks=1)
    got = paged_decode_attention_cuda(q, kp, vp, phys, logical, keep, pos_t, sm_scale=d ** -0.5)
    want = ref.paged_decode_attention_gather(q, kp, vp, phys, logical, keep, pos_t, sm_scale=d ** -0.5)
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) <= tol


PAGED_MAIN = dict(b=8, hk=8, d=128, page=128, pps=16)  # qwen3-1.7b, 16 pages a slot


def _paged_main(g, dtype, dev, *, schedule, seed=0, table=None, pos=None):
    """Inputs of the paged decode read at the main shape: a poisoned trash
    page 0, a random page table with an idle slot (1) and a partially
    allocated row (2), ragged positions; ``table``/``pos`` override them.
    ``schedule`` is "sparse" (the pixelfly pages, w = 7) or "dense" (every
    page of the table, w = 16). Returns the kernel's positional arguments."""
    b, hk, d, page, pps = (PAGED_MAIN[x] for x in ("b", "hk", "d", "page", "pps"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = b * pps + 1
    k = torch.randn((n_pages, page, hk, d), generator=gen, device=dev)
    v = torch.randn((n_pages, page, hk, d), generator=gen, device=dev)
    k[0], v[0] = 1e4, -1e4
    if table is None:
        table = torch.randperm(n_pages - 1, generator=gen, device=dev).reshape(b, pps) + 1
        table[1] = 0
        table[2, 3:] = 0
    if pos is None:
        pos = torch.randint(0, pps * page, (b,), generator=gen, device=dev)
        pos[1] = 0
        pos[2] = 3 * page - 5
    table = torch.as_tensor(table, device=dev).to(torch.int32)
    pos = torch.as_tensor(pos, device=dev).to(torch.int32)
    if schedule == "sparse":
        logical, phys, keep = paged_sparse_schedule(table, pos, page, local_blocks=2, global_blocks=1)
    else:
        logical, phys, keep = paged_dense_schedule(table)
    q = torch.randn((b, hk, g, d), generator=gen, device=dev)
    return tuple(x.to(dtype) for x in (q, k, v)) + (phys, logical, keep, pos)


def _paged_check(args, tol):
    """Kernel against the plain version at the reference tolerance,
    assert_allclose style (rtol = atol = tol): one bf16 ulp of an output of
    magnitude 2 or more is 2^-6, so a few visible keys need the rtol."""
    scale = args[0].shape[-1] ** -0.5
    got = paged_decode_attention_cuda(*args, sm_scale=scale)
    want = ref.paged_decode_attention_gather(*args, sm_scale=scale)
    assert torch.isfinite(got.float()).all()
    excess = ((got.float() - want.float()).abs() - tol * want.float().abs()).max().item()
    assert excess <= tol, f"max abs err {_err(got, want):.3e}, beyond tol {tol:g} (rtol = atol)"
    return got


@pytest.mark.parametrize("schedule", ["sparse", "dense"])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_paged_decode_kernel_main_shapes(cuda, schedule, g, dtype, tol):
    args = _paged_main(g, dtype, cuda, schedule=schedule, seed=g)
    assert args[3].shape[1] == {"sparse": 7, "dense": 16}[schedule]
    _paged_check(args, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_paged_decode_kernel_one_schedule_slot(cuda, dtype, tol):
    b, page = PAGED_MAIN["b"], PAGED_MAIN["page"]
    table = torch.arange(1, b + 1).reshape(b, 1)
    pos = torch.tensor([0, 1, 5, 63, 64, 100, 126, 127])
    args = _paged_main(2, dtype, cuda, schedule="dense", table=table, pos=pos)
    assert args[3].shape == (b, 1) and int(pos.max()) < page
    _paged_check(args, tol)


@pytest.mark.parametrize("schedule", ["sparse", "dense"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_paged_decode_kernel_every_slot_idle(cuda, schedule, dtype, tol):
    b, pps = PAGED_MAIN["b"], PAGED_MAIN["pps"]
    args = _paged_main(2, dtype, cuda, schedule=schedule,
                       table=torch.zeros((b, pps)), pos=torch.zeros(b))
    # every slot sees key 0 of the poisoned trash page and nothing else
    got = _paged_check(args, tol)
    want = args[2][0, 0].float()[None, :, None, :].expand(got.shape)
    assert torch.equal(got.float(), want)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_paged_decode_kernel_one_visible_page(cuda, dtype, tol):
    """Every slot's position lies in its first page, so 15 of the 16 pages
    of the dense schedule lie beyond it and leave empty partials."""
    b, page = PAGED_MAIN["b"], PAGED_MAIN["page"]
    pos = torch.tensor([0, 3, 17, 31, 64, 90, 126, 127])
    args = _paged_main(4, dtype, cuda, schedule="dense", pos=pos)
    logical = args[4]
    assert ((logical * page <= args[6][:, None]).sum(dim=1) == 1).all()
    _paged_check(args, tol)


@pytest.mark.parametrize("schedule", ["sparse", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_same_bits_twice(cuda, schedule, dtype):
    args = _paged_main(2, dtype, cuda, schedule=schedule, seed=7)
    scale = PAGED_MAIN["d"] ** -0.5
    assert torch.equal(paged_decode_attention_cuda(*args, sm_scale=scale),
                       paged_decode_attention_cuda(*args, sm_scale=scale))


def test_paged_decode_kernel_refuses_misaligned(cuda):
    q, k, v, *sched = _paged_main(2, torch.bfloat16, cuda, schedule="sparse")
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    shifted = buf[1:].view(k.shape)  # contiguous, 2 bytes off
    shifted.copy_(k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention_cuda(q, shifted, v, *sched, sm_scale=0.1)
    # rows of D + 1 elements: a head stride of 258 bytes
    n, page, hk, d = k.shape
    wide_k = torch.zeros((n, page, hk, d + 1), dtype=k.dtype, device=cuda)[..., :d]
    wide_v = torch.zeros((n, page, hk, d + 1), dtype=k.dtype, device=cuda)[..., :d]
    with pytest.raises(ValueError, match="16-byte chunks"):
        paged_decode_attention_cuda(q, wide_k, wide_v, *sched, sm_scale=0.1)


@pytest.mark.parametrize("d,block", [(64, 64), (128, 128)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_block_sparse_attention_kernel(cuda, d, block, g, dtype, tol):
    rng = np.random.default_rng(d + g)
    b, hk, s = 2, 2, 8 * block
    mask = ap.pixelfly_attention_block_mask(
        s, s, ap.AttentionPatternConfig(block=block, local_blocks=2, global_blocks=1), causal=True
    )
    sched = ap.block_schedule(mask, block, block)
    q = _t(rng.standard_normal((b, s, hk * g, d)), dtype, cuda)
    k = _t(rng.standard_normal((b, s, hk, d)), dtype, cuda)
    v = _t(rng.standard_normal((b, s, hk, d)), dtype, cuda)
    kv_index = torch.as_tensor(sched.kv_index, device=cuda)
    valid = torch.as_tensor(sched.valid, device=cuda)
    got = block_sparse_attention_cuda(q, k, v, kv_index, valid, block=block, causal=True, sm_scale=d ** -0.5)
    want = ref.sparse_attention(q.reshape(b, s, hk, g, d), k, v, kv_index, valid,
                                block=block, causal=True, sm_scale=d ** -0.5)
    assert _err(got, want.reshape(b, s, hk * g, d)) <= tol


def _attention_inputs(b, s, hk, g, d, block, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    mask = ap.pixelfly_attention_block_mask(
        s, s, ap.AttentionPatternConfig(block=block, local_blocks=2, global_blocks=1), causal=True
    )
    sched = ap.block_schedule(mask, block, block)
    q = _t(rng.standard_normal((b, s, hk * g, d)), dtype, dev)
    k = _t(rng.standard_normal((b, s, hk, d)), dtype, dev)
    v = _t(rng.standard_normal((b, s, hk, d)), dtype, dev)
    kv_index = torch.as_tensor(sched.kv_index, device=dev)
    valid = torch.as_tensor(sched.valid, device=dev)
    return q, k, v, kv_index, valid


@pytest.mark.parametrize("d,block,s", [(128, 128, 2048), (64, 64, 1024)])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_block_sparse_attention_kernel_main_shapes(cuda, d, block, s, g, dtype, tol):
    b, hk = 2, 2
    q, k, v, kv_index, valid = _attention_inputs(b, s, hk, g, d, block, dtype, cuda, seed=g + d)
    kw = dict(block=block, causal=True, sm_scale=d ** -0.5)
    got = block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw)
    want = ref.sparse_attention(q.reshape(b, s, hk, g, d), k, v, kv_index, valid, **kw)
    assert torch.isfinite(got.float()).all()
    assert _err(got, want.reshape(b, s, hk * g, d)) <= tol
    if dtype == torch.bfloat16:
        assert torch.equal(got, block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw))


def test_block_sparse_attention_kernel_refuses_misaligned(cuda):
    q, k, v, kv_index, valid = _attention_inputs(1, 256, 2, 2, 64, 64, torch.bfloat16, cuda, seed=0)
    kw = dict(block=64, causal=True, sm_scale=0.125)
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    shifted = buf[1:].view(k.shape)
    shifted.copy_(k)
    with pytest.raises(ValueError, match="16-byte aligned"):
        block_sparse_attention_cuda(q, shifted, v, kv_index, valid, **kw)
    q, k, v, kv_index, valid = _attention_inputs(1, 256, 2, 2, 64, 32, torch.bfloat16, cuda, seed=0)
    with pytest.raises(ValueError, match="multiple of 64"):
        block_sparse_attention_cuda(q, k, v, kv_index, valid, block=32, causal=True, sm_scale=0.125)


def test_engine_streams_equal_cpu(cuda):
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    page = cfg.attn_block
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), g)
            for n, g in [(40, 6), (5 * page + 9, 8), (2 * page + 1, 5), (7 * page, 4)]]

    def serve(device):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=8 * page), device=device)
        uids = {eng.submit(p, n): i for i, (p, n) in enumerate(work)}
        return {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=200)}

    assert serve("cuda") == serve("cpu")
