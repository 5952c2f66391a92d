"""Card-only tests: each CUDA kernel of the port against its plain PyTorch
version on the same CUDA tensors, the smoke-width engine's streams on the
card against the CPU's (greedy, and sampled with the prefix cache and a
preemption), and the serving pieces that run as plain torch ops on the
card: the threefry noise and the sampler (equal to the CPU's), the
copy-on-write page copy and the swap round trip through pinned memory,
the partial-prefill attention (1e-5 fp32, 2e-2 bf16), and the engine's
observability on the card (a valid trace, streams equal with tracing on
and off, the allocator's bytes in use, no kernel-library build or load
after warm-up), and the fixed-batch ``Server`` against the engine. bf16 takes the tensor-core paths
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

from repro_torch.analysis.guards import compile_events_total
from repro_torch.configs import registry
from repro_torch.core import attn_pattern as ap
from repro_torch.core import butterfly as bf
from repro_torch.kernels import ref
from repro_torch.kernels.bsr_attention import block_sparse_attention_cuda
from repro_torch.kernels.bsr_matmul import bsr_matmul_cuda
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.launch.serve import Server
from repro_torch.models import layers as L
from repro_torch.models.layers import linear_spec, paged_dense_schedule, paged_sparse_schedule
from repro_torch.obs import SloConfig, validate_trace_file
from repro_torch.serving import sampling as S
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import ScheduleParams
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.swap import SwapManager

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


# (in blocks, out blocks, max_stride) of the patterns below: "wide" is
# 8 -> 4 blocks; "square-ragged"'s 5 output blocks leave the last tile of
# the several-blocks-a-tile kernels (b < 64) ragged; 2 -> 8 blocks at
# stride 8 stretches the pattern so that a row repeats a column block
BSR_PATTERNS = {"wide": (8, 4, 4), "square-ragged": (8, 5, 4), "stretched-repeat-cols": (2, 8, 8)}
BSR_CASES = [(64, "wide"), (128, "wide")] + [
    (b, p) for b in (8, 16, 32) for p in ("square-ragged", "stretched-repeat-cols")]


@pytest.mark.parametrize("m", [1, 8, 16, 17, 37, 300])
@pytest.mark.parametrize("block,pattern", BSR_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_bsr_matmul_kernel(cuda, m, block, pattern, dtype, tol):
    """Every block the kernel takes: b = 64, 128 (the tensor-core and split
    kernels), and b = 8, 16, 32, where the SIMT kernel (fp32; bf16 at
    b = 8 or M <= 16) and the several-blocks-a-tile tensor-core kernel
    (bf16, b = 16, 32, M > 16) run."""
    nbi, nbo, k = BSR_PATTERNS[pattern]
    rng = np.random.default_rng(m + block)
    pat = bf.make_pattern(nbo * block, nbi * block, block=block, max_stride=k)
    if pattern.startswith("stretched"):
        assert any(len(set(row)) < len(row) for row in pat.cols.tolist())
    x = _t(rng.standard_normal((m, nbi * block)), dtype, cuda)
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


@pytest.mark.parametrize("block,m", [(128, 8), (128, 16), (128, 4096)] + [
    (b, m) for b in (8, 16, 32) for m in (16, 300)])
def test_bsr_matmul_kernel_same_bits_twice(cuda, block, m):
    """bf16 twice on the same inputs gives the same bits: qwen3-1.7b's down
    at b = 128, a 8 -> 24 block pattern at the small blocks."""
    if block == 128:
        x, blocks, cols, _ = _main_bsr("down", m, torch.bfloat16, cuda)
    else:
        rng = np.random.default_rng(block)
        pat = bf.make_pattern(24 * block, 8 * block, block=block, max_stride=4)
        x = _t(rng.standard_normal((m, 8 * block)), torch.bfloat16, cuda)
        blocks = _t(rng.standard_normal((pat.nb_out, pat.r, block, block)) / 4, torch.bfloat16, cuda)
        cols = torch.as_tensor(pat.cols, device=cuda)
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
    """Blocks below 8 (which ``LinearSpec.pixelfly`` never gives) raise."""
    x = torch.zeros((4, 64), device=cuda)
    with pytest.raises(ValueError, match="takes the blocks"):
        bsr_matmul_cuda(x, torch.zeros((2, 1, 4, 4), device=cuda),
                        torch.zeros((2, 1), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 7])
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
@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 7, 8])
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


# (64, 128, 2048): musicgen-large's head dim under the block-128 pattern
@pytest.mark.parametrize("d,block,s", [(128, 128, 2048), (64, 64, 1024), (64, 128, 2048)])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 7, 8])
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


@pytest.mark.parametrize("d,block", [(64, 128), (128, 128), (64, 64)])
@pytest.mark.parametrize("g", [2, 3, 4, 6, 7, 8])
def test_block_sparse_attention_groups_equal_one_head_blocks(cuda, d, block, g):
    """bf16: a thread block takes 4, 2 or 1 heads of a GQA group (the
    largest dividing G) and G / that many sub-groups run side by side. A
    row's arithmetic does not depend on which heads share its block, so
    the grouped launch gives the bits of the G = 1 launch on K/V repeated
    to every query head (one head a block, the layout untouched by the
    grid's sub-group axis)."""
    b, hk, s = 2, 2, 1024
    q, k, v, kv_index, valid = _attention_inputs(b, s, hk, g, d, block, torch.bfloat16, cuda, seed=g)
    kw = dict(block=block, causal=True, sm_scale=d ** -0.5)
    got = block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw)
    k1, v1 = (t.repeat_interleave(g, dim=2).contiguous() for t in (k, v))
    assert torch.equal(got, block_sparse_attention_cuda(q, k1, v1, kv_index, valid, **kw))


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


# the configs the port added after qwen3-1.7b: (arch, linear) -> (n_in, n_out)
FAMILY = {
    "smollm-360m": {"q": ("d_model", "q_dim"), "kv": ("d_model", "kv_dim"),
                    "gate": ("d_model", "d_ff"), "down": ("d_ff", "d_model")},
    "qwen2-1.5b": {"q": ("d_model", "q_dim"), "kv": ("d_model", "kv_dim"),
                   "gate": ("d_model", "d_ff"), "down": ("d_ff", "d_model")},
    # 28 -> 28, 28 -> 4, 28 -> 148 and 148 -> 28 blocks of 128
    "qwen2-vl-7b": {"q": ("d_model", "q_dim"), "kv": ("d_model", "kv_dim"),
                    "gate": ("d_model", "d_ff"), "down": ("d_ff", "d_model")},
    # multi-head: kv is q's shape
    "musicgen-large": {"q": ("d_model", "q_dim"), "gate": ("d_model", "d_ff"), "down": ("d_ff", "d_model")},
}
FAMILY_CASES = [(a, lin) for a in FAMILY for lin in FAMILY[a]]


@pytest.mark.parametrize("arch,label", FAMILY_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_bsr_matmul_family_patterns(cuda, arch, label, dtype, tol):
    """The kernel forward at smollm-360m's block-64 patterns (odd nb_out
    15 and 5, r = 1 for kv) and qwen2-1.5b's block-128 ones, at M = 8 (the
    cluster-split decode kernel in bf16) and M = 700 (the tensor-core
    kernel, a ragged last row tile); then ``BsrMatmul``'s dX and dBlocks
    at M = 700 against torch autograd of ``ref.bsr_matmul_gather`` (y and
    dX within tol, rtol = atol; dBlocks relative to its largest entry)."""
    from repro_torch.kernels import autograd as AG

    full = registry.get(arch, sparse=True)
    n_in, n_out = (getattr(full, f) for f in FAMILY[arch][label])
    pat = linear_spec(full, n_in, n_out, False).pattern()
    assert pat.block == full.sparse_block
    rng = np.random.default_rng(n_in + n_out)
    blocks = _t(rng.standard_normal((pat.nb_out, pat.r, pat.block, pat.block)) / np.sqrt(pat.r * pat.block),
                dtype, cuda)
    cols = torch.as_tensor(pat.cols, device=cuda)
    for m in (8, 700):
        x = _t(rng.standard_normal((m, n_in)), dtype, cuda)
        assert _allclose(bsr_matmul_cuda(x, blocks, cols), ref.bsr_matmul_gather(x, blocks, cols), tol)
    x, blocks = x.requires_grad_(), blocks.requires_grad_()
    dy = _t(rng.standard_normal((700, n_out)), dtype, cuda)
    y = AG.bsr_matmul(x, blocks, AG.bsr_tables(pat.cols, pat.nb_in, cuda))
    dx, db = torch.autograd.grad(y, (x, blocks), dy)
    dx_ref, db_ref = torch.autograd.grad(ref.bsr_matmul_gather(x, blocks, cols), (x, blocks), dy)
    assert _allclose(dx, dx_ref, tol)
    assert _rel(db, db_ref) <= tol


@pytest.mark.parametrize("g,d", [(2, 128), (3, 64), (6, 128)])
def test_dense_attention_flash_equals_chunked(cuda, g, d):
    """bf16 dense attention on the card (PyTorch's flash kernel through
    ``layers.flash_attention``) against ``layers.chunked_attention`` (the
    JAX package's algorithm) on the same CUDA tensors, S = 1024, chunk
    256: the output within 2e-2 (rtol = atol; each rounds q, P and the
    output to bf16 at its own points), dq, dk, dv within 2e-2 relative to
    their largest entry."""
    b, s, hk = 2, 1024, 2
    gen = torch.Generator(device=cuda).manual_seed(g)
    q = torch.randn((b, s, hk, g, d), generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
            for _ in range(2))
    do = torch.randn((b, s, hk, g, d), generator=gen, device=cuda).to(torch.bfloat16)
    kw = dict(sm_scale=d ** -0.5, chunk=256)
    o = L.flash_attention(q, k, v, **kw)
    o_ref = L.chunked_attention(q, k, v, **kw)
    assert o.dtype == torch.bfloat16 and _allclose(o, o_ref, 2e-2)
    for a, w in zip(torch.autograd.grad(o, (q, k, v), do), torch.autograd.grad(o_ref, (q, k, v), do)):
        assert _rel(a, w) <= 2e-2


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-1.5b", "qwen2-vl-7b", "musicgen-large"])
def test_family_engine_streams_equal_cpu(cuda, arch):
    """fp32 sparse smoke models of smollm-360m (G = 3), qwen2-1.5b (QKV
    bias), qwen2-vl-7b (M-RoPE, untied head) and musicgen-large
    (multi-head), the same seeded weights: equal greedy streams on the
    card and on the CPU, with a max_len whose decode schedule skips
    pages."""
    cfg = registry.get_smoke(arch, sparse=True)
    page = cfg.attn_block
    rng = np.random.default_rng(2)
    work = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), g)
            for n, g in [(40, 6), (5 * page + 9, 8), (2 * page + 1, 5), (7 * page, 4)]]

    def serve(device):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=8 * page), device=device)
        uids = {eng.submit(p, n): i for i, (p, n) in enumerate(work)}
        return {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=200)}

    assert serve("cuda") == serve("cpu")


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


def _obs_work(cfg):
    rng = np.random.default_rng(3)
    page = cfg.attn_block
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), g)
            for n, g in [(40, 6), (3 * page + 9, 8), (2 * page + 1, 5), (page, 7), (9, 6)]]


def test_traced_engine_on_card_valid_trace_equal_streams(cuda, tmp_path):
    """Tracing, the live window, the SLO monitor and the flight recorder
    on the card: the streams equal the bare engine's, the trace
    validates with one decode_step span a decode step, and the allocator
    reports the bytes in use."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    work = _obs_work(cfg)
    streams, engines = {}, {}
    for on in (False, True):
        obs = dict(trace=True, monitor=30.0, slo=SloConfig(), flight_dir=str(tmp_path / "fl")) if on else {}
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=8 * cfg.attn_block, **obs),
                     device=cuda)
        uids = {eng.submit(p, n, schedule=ScheduleParams(deadline_s=600.0)): i
                for i, (p, n) in enumerate(work)}
        streams[on] = {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=200)}
        engines[on] = eng
    assert streams[True] == streams[False]
    eng = engines[True]
    out = tmp_path / "trace.json"
    n = eng.export_perfetto(str(out))
    rep = validate_trace_file(str(out))
    s = eng.stats_summary()
    assert rep["events"] == n and rep["slot_tracks"] == 2 and rep["counter_series"] == 3
    ends = [e for e in eng.tracer.events() if e["kind"] == 1]
    assert sum(e["name"] == "decode_step" for e in ends) == s["decode_steps"]
    assert sum(e["name"] == "host_sync" for e in ends) == s["decode_steps"]
    in_use = eng.metrics["repro_mem_device_bytes_in_use"].value
    assert in_use >= eng.kv.memory_bytes() > 0
    assert eng.windowed_vars()["memory"]["device_bytes_in_use"] == in_use
    assert s["slo"]["met"] == s["slo"]["with_deadline"] == len(work)


def test_no_kernel_library_build_or_load_after_warm_up(cuda):
    """compile_events_total() moves only while a kernel library is first
    built or loaded: after the first request's steps, every step reads 0,
    and each step's count is on its spans and in the registry."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=8 * cfg.attn_block, trace=True),
                 device=cuda)
    eng.submit(np.arange(3 * cfg.attn_block, dtype=np.int32) % cfg.vocab_size, 3)
    eng.drain(max_steps=50)  # warm-up: every kernel's library is loaded by now
    eng.reset_stats()
    for p, n in _obs_work(cfg):
        eng.submit(p, n)
    steps = 0
    while not eng.scheduler.idle:
        before = compile_events_total()
        eng.step()
        assert compile_events_total() == before
        steps += 1
    assert steps > 0 and eng.stats_summary()["dispatch_guard"]["step_compiles"] == 0
    spans = [e for e in eng.tracer.events() if e["kind"] == 1 and e["name"] in ("admission", "decode_step")]
    assert spans and all(e["a1"] == 0 for e in spans)


def test_server_on_card_equals_engine_grid(cuda):
    """The fixed-batch oracle on the card: its greedy grid equals the
    engine's at fp32 smoke width (the verify recipe's check)."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    grid = Server(cfg, device=cuda).generate(prompts, 16)
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=4, max_len=32 + 16 + 1), device=cuda)
    uids = [eng.submit(p, 16) for p in prompts]
    by = {f.uid: f.tokens for f in eng.drain(max_steps=100)}
    np.testing.assert_array_equal(grid, np.stack([by[u] for u in uids]))


def test_engine_sampled_prefix_preemption_streams_equal_cpu(cuda):
    """Sampled and greedy requests on a shared prefix, prefix cache on,
    and a priority request that preempts a full pool: the same streams
    on the card as on the CPU."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    page = cfg.attn_block
    rng = np.random.default_rng(1)
    sys_prompt = rng.integers(0, cfg.vocab_size, 2 * page).astype(np.int32)
    work = [np.concatenate([sys_prompt, rng.integers(0, cfg.vocab_size, 3 + 11 * i).astype(np.int32)])
            for i in range(4)]

    def serve(device):
        eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=8 * page, prefix_cache=True,
                                                  preempt_min_steps=2), device=device)
        uids = {eng.submit(p, 20, sampling=SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                                          repetition_penalty=1.1, seed=i) if i % 2 else None): i
                for i, p in enumerate(work)}
        fins = []
        for _ in range(5):
            fins += eng.step()
        uids[eng.submit(work[0][:9], 6, schedule=ScheduleParams(priority=1))] = 9
        fins += eng.drain(max_steps=300)
        assert eng.stats.preemptions >= 1
        return {uids[f.uid]: (f.tokens.tolist(), f.prefix_hit_tokens) for f in fins}

    assert serve("cuda") == serve("cpu")


SEEDS = [0, 7, 2**32 - 1, 2**32 + 5, 2**63 - 1]


def test_threefry_noise_on_card_equals_cpu(cuda):
    keys = torch.from_numpy(np.stack([S.base_key_data(sd) for sd in SEEDS]).astype(np.int64))
    idx = torch.tensor([0, 1, 1000, 65535, 2**31 - 1])
    k_cpu = S.fold_in(keys, idx)
    k_dev = S.fold_in(keys.to(cuda), idx.to(cuda))
    assert torch.equal(k_dev.cpu(), k_cpu)
    assert torch.equal(S.random_bits(k_dev, 4096).cpu(), S.random_bits(k_cpu, 4096))
    g_cpu, g_dev = S.gumbel(k_cpu, 4096).numpy(), S.gumbel(k_dev, 4096).cpu().numpy()
    ulp = np.spacing(np.maximum(np.abs(g_cpu), np.float32(1.0)))
    assert (np.abs(g_dev - g_cpu) <= 2 * ulp).all()


@pytest.mark.parametrize("candidates", [64, None])
def test_sample_logits_on_card_equals_cpu_full_vocab(cuda, candidates):
    """Eight slots at the full vocabulary (152064 padded, 151936 valid),
    with the engine's knob mix, ties planted at the 64th candidate."""
    v, valid, n = 152064, 151936, 8
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((n, v), generator=gen) * 3
    logits[:, 100:200] = logits[:, :100].amax() - 1.0  # a band of ties
    seen = torch.rand((n, v), generator=gen) < 0.01
    temp = torch.tensor([0.8, 0.8, 0.0, 1.3, 0.8, 0.0, 0.5, 2.0])
    top_k = torch.tensor([40, 0, 0, 7, 40, 5, 64, 0])
    top_p = torch.tensor([0.95, 1.0, 1.0, 0.9, 0.95, 0.5, 1.0, 0.8])
    rep = torch.tensor([1.1, 1.0, 1.0, 1.0, 1.1, 1.3, 1.4, 1.0])
    keys = torch.from_numpy(np.stack([S.base_key_data(100 + i) for i in range(n)]).astype(np.int64))
    idx = torch.arange(n) * 17
    for step in range(3):
        args = (logits, temp, top_k, top_p, rep, keys, idx + step, seen)
        want = S.sample_logits(*args, valid, candidates)
        got = S.sample_logits(*(a.to(cuda) for a in args), valid, candidates)
        assert torch.equal(got.cpu(), want)


def test_cow_and_swap_round_trip_through_pinned_memory(cuda):
    """cow_page copies a page in every layer's pools in place; swap-out
    stages the victim's pages, copies them to pinned host memory behind a
    CUDA event, and frees them; a prefill that reuses the freed pages at
    once (before finalize) must not reach the host copy; swap-in restores
    the bytes exactly."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    page = cfg.attn_block
    kv = PagedKVCache(cfg, max_slots=2, max_len=4 * page, device=cuda)
    sm = SwapManager(kv)
    kv.alloc_upto(0, 3 * page - 1)
    pages = kv.owned_pages(0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for pool in kv.buffers:
        for buf in pool.values():
            buf[:, pages] = torch.randn(buf[:, pages].shape, generator=gen, device=cuda).to(buf.dtype)
    snap = [{n: b[:, pages].clone() for n, b in pool.items()} for pool in kv.buffers]
    kv.incref(pages[1])
    dst = kv.cow_page(0, 1)
    for pool, old in zip(kv.buffers, snap):
        for n, buf in pool.items():
            assert torch.equal(buf[:, dst], old[n][:, 1])
    kv.unpin(pages[1])  # the outside pin goes: the page is parked
    pages = kv.owned_pages(0)
    rec = sm.swap_out(0)
    assert rec.pending and all(t.is_pinned() for pool in rec.host for t in pool.values())
    # a prefill takes the freed pages and overwrites them before finalize
    kv.alloc_upto(1, 4 * page - 1)
    for pool in kv.buffers:
        for buf in pool.values():
            buf[:, kv.owned_pages(1)] = 7.0
    sm.finalize(rec)
    kv.free_slot(1)
    kv.alloc_upto(1, 3 * page - 1)
    sm.swap_in(rec, 1, n_resident=0)
    for pool, old in zip(kv.buffers, snap):
        for n, buf in pool.items():
            assert torch.equal(buf[:, kv.owned_pages(1)], old[n])
    assert sm.stats.in_pages == sm.stats.out_pages == 3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("sparse", [False, True])
def test_prefix_flash_attention_on_card_equals_cpu(cuda, dtype, tol, sparse):
    """The partial-prefill attention at the full model's head shape (Hk 8,
    G 2, D 128, block 128): 8 requests, a 1024-token prefix buffer with
    ragged valid lengths and a 256-token suffix."""
    gen = torch.Generator().manual_seed(1)
    b, sq, hk, g, d, block = 8, 256, 8, 2, 128, 128
    lp = 8 * block
    q = torch.randn((b, sq, hk, g, d), generator=gen).to(dtype)
    ks, vs = (torch.randn((b, sq, hk, d), generator=gen).to(dtype) for _ in range(2))
    kp, vp = (torch.randn((b, lp, hk, d), generator=gen).to(dtype) for _ in range(2))
    plen = torch.tensor([0, 1, 2, 3, 5, 8, 8, 4]) * block
    kw = dict(sm_scale=d ** -0.5, chunk=1024, block_cfg=(block, 2, 1, 0) if sparse else None)
    want = L.prefix_flash_attention(q, ks, vs, kp, vp, plen, **kw)
    got = L.prefix_flash_attention(*(t.to(cuda) for t in (q, ks, vs, kp, vp, plen)), **kw)
    assert _err(got.cpu(), want) <= tol


# ----------------------------------------------------------------------
# training: the two kernels under autograd, a train step, checkpoints
# ----------------------------------------------------------------------


def _rel(a, b):
    """Max abs error over max(1, max |b|): for sums over many tokens."""
    return _err(a, b) / max(1.0, b.float().abs().max().item())


def _allclose(a, b, tol):
    """|a - b| <= tol + tol * |b| everywhere (rtol = atol = tol): a bf16
    result of magnitude 4-8 is one rounding away at 2^-5."""
    return bool(((a.float() - b.float()).abs() <= tol + tol * b.float().abs()).all())


def _grad_pattern(label):
    """The pattern of a full-width qwen3-1.7b linear (q, gate, down; b = 128)
    or a ViT-B/16 one (vit-qkv, vit-fc2; b = 32)."""
    from repro_torch.bench.vision_speedup import b16_config

    if label.startswith("vit-"):
        vit = b16_config("vit", True)
        d, f = vit.d_model, vit.d_ff
        return vit.lin(*{"vit-qkv": (d, 3 * d), "vit-fc2": (f, d)}[label]).pattern()
    full = registry.get("qwen3-1.7b", sparse=True)
    n_in, n_out = {"q": (full.d_model, full.q_dim), "gate": (full.d_model, full.d_ff),
                   "down": (full.d_ff, full.d_model)}[label]
    return linear_spec(full, n_in, n_out, False).pattern()


@pytest.mark.parametrize("label", ["q", "gate", "down", "vit-qkv", "vit-fc2"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_bsr_matmul_grads_on_card(cuda, label, dtype, tol):
    """``BsrMatmul`` on the card (the kernel forward, the kernel dX on the
    transposed tables, the batched dBlocks) against torch autograd of
    ``ref.bsr_matmul_gather`` on the same CUDA tensors, M = 1024, at the
    full-width q, gate and down patterns (down's transpose is ragged) and
    ViT-B/16's qkv and fc2 at b = 32 (fc2's transpose has 96 input blocks
    of fan-in 2); y and dX within tol (rtol = atol, as phase 3 of
    ``chip_smoke.py``: dX sums up to 6 x 128 products, magnitudes up to
    ~8), dBlocks within tol relative to its largest entry."""
    from repro_torch.kernels import autograd as AG

    pat = _grad_pattern(label)
    b = pat.block
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((1024, pat.nb_in * b)), dtype, cuda).requires_grad_()
    blocks = _t(rng.standard_normal((pat.nb_out, pat.r, b, b)) / np.sqrt(pat.r * b),
                dtype, cuda).requires_grad_()
    dy = _t(rng.standard_normal((1024, pat.nb_out * b)), dtype, cuda)
    y = AG.bsr_matmul(x, blocks, AG.bsr_tables(pat.cols, pat.nb_in, cuda))
    dx, db = torch.autograd.grad(y, (x, blocks), dy)
    y_ref = ref.bsr_matmul_gather(x, blocks, torch.as_tensor(pat.cols, device=cuda))
    dx_ref, db_ref = torch.autograd.grad(y_ref, (x, blocks), dy)
    assert _allclose(y, y_ref, tol)
    assert _allclose(dx, dx_ref, tol)
    assert _rel(db, db_ref) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_block_sparse_attention_grads_on_card(cuda, dtype, tol):
    """``BlockSparseAttention`` on the card (the kernel forward, the JAX
    package's gradient of the gathered attention backward) against torch
    autograd of ``ref.sparse_attention``, B = 1, S = 1024, H = 16, Hk = 8,
    D = 128, block 128: the output within the kernel's tolerance, dq, dk,
    dv within it relative to their largest entry (the backward repeats the
    plain version's arithmetic; its index scatter-adds sum in any order)."""
    from repro_torch.kernels import autograd as AG

    b, s, hk, g, d, block = 1, 1024, 8, 2, 128, 128
    kv_index, valid = L._schedule_tensors(s, block, 2, 0, 1, str(cuda))
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((b, s, hk, g, d), generator=gen, device=cuda).to(dtype).requires_grad_()
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=cuda).to(dtype).requires_grad_()
            for _ in range(2))
    do = torch.randn((b, s, hk, g, d), generator=gen, device=cuda).to(dtype)
    kw = dict(block=block, causal=True, sm_scale=d ** -0.5)
    o = AG.block_sparse_attention(q, k, v, kv_index, valid, **kw)
    got = torch.autograd.grad(o, (q, k, v), do)
    o_ref = ref.sparse_attention(q, k, v, kv_index, valid, **kw)
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    assert _err(o, o_ref) <= tol
    for a, w in zip(got, want):
        assert _rel(a, w) <= tol


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-vl-7b", "musicgen-large"])
def test_train_step_on_card_equals_cpu(cuda, arch):
    """One fp32 ``make_train_step`` step of the smoke model, seed 0, on the
    card (kernels) and on the CPU (plain versions): loss and grad_norm
    within 1e-4 relative; parameters within 1e-6 where the CPU gradient
    exceeds 1e-5 in magnitude and within 2 * lr elsewhere. The vlm and
    audio backbones train on ``EmbedsWrapper`` batches, the token table
    with a zero gradient."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training.data import EmbedsWrapper, SyntheticLM
    from repro_torch.training.loop import MeshState, make_train_step
    from repro_torch.training.optimizer import OptConfig, init_opt_state

    cfg = registry.get_smoke(arch, sparse=True)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticLM(cfg.vocab_size, 128, 4, seed=0)
    if not cfg.embed_inputs:
        data = EmbedsWrapper(data, cfg.d_model, n_pos_streams=len(cfg.mrope_sections))
    batch = data.batch(0)
    out = {}
    for dev in ("cpu", cuda):
        model = T.init_model(cfg, seed=0, device=dev)
        if dev == "cpu":
            params = dict(model.named_parameters())
            loss, _ = T.forward_train(cfg, model, batch)
            g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if x is None else x for (n, p), x in zip(params.items(), g)}
        ms = MeshState(cfg, make_local_mesh(devices=[dev]), "fsdp", model.state_dict())
        m = make_train_step(cfg, opt)(ms, init_opt_state(opt, ms.shards), batch)
        out[str(dev)] = (m, ms.state_dict())
    (mc, pc), (mg, pg) = out["cpu"], out[str(cuda)]
    for key in ("loss", "grad_norm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-4 * abs(float(mc[key]))
    for n, p in pc.items():
        err = (pg[n].float() - p.float()).abs()
        big = grads[n].abs() > 1e-5
        assert (err[big] <= 1e-6).all(), n
        assert err.max().item() <= 2 * opt.lr, n


def test_model_moved_to_card_uses_tables_there(cuda):
    """A smoke model built on the CPU and moved with ``Module.to``: every
    linear finds its BSR tables on the card, and the fp32 training loss
    equals the CPU model's within 1e-4 relative."""
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticLM

    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    batch = SyntheticLM(cfg.vocab_size, 128, 2, seed=0).batch(0)
    model = T.init_model(cfg, seed=0, device="cpu")
    with torch.no_grad():
        want = T.forward_train(cfg, model, batch)[0].item()
        got = T.forward_train(cfg, model.to(cuda), batch)[0].item()
    assert abs(got - want) <= 1e-4 * abs(want)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A smoke Trainer on the card: 2 steps, a checkpoint, 1 more step; a
    new Trainer restores step 2 with every parameter and moment equal bit
    for bit, and its next step's loss equals the first trainer's."""
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import TrainConfig, Trainer
    from repro_torch.training.optimizer import OptConfig

    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)

    def trainer():
        return Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                       SyntheticLM(cfg.vocab_size, 128, 4, seed=0),
                       TrainConfig(ckpt_dir=str(tmp_path), ckpt_every=1000), device=cuda)

    a = trainer()
    a.run(2)
    a.checkpoint()
    snap = a.state()
    loss3 = a.run(1)[0]["loss"]
    b = trainer()
    assert b.step == 2 and b.opt["step"] == 2
    got = b.state()
    for n, p in got["params"].items():
        assert torch.equal(p, snap["params"][n]) and torch.equal(got["opt"]["mu"][n], snap["opt"]["mu"][n]), n
    assert b.run(1)[0]["loss"] == loss3


# ----------------------------------------------------------------------
# vision: ViT and MLP-Mixer on the card (bsr_matmul at b = 32 and 16)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["vit", "mixer"])
@pytest.mark.parametrize("block", [32, 16])
def test_vision_forward_backward_on_card_equals_cpu(cuda, kind, block):
    """A smoke sparse fp32 ViT or Mixer (2 layers, d_model 128, 64 patches,
    so the Mixer's token MLP is sparse too), the same weights (a random
    head) and data on the card and the CPU: logits within 1e-4, the loss
    within 1e-5 relative, every gradient within 1e-4 relative to its
    largest entry; the card's backward launches bsr_matmul for the
    forward and the dX of every sparse linear."""
    from repro_torch.core.pixelfly import Linear
    from repro_torch.kernels.bsr_matmul import KERNEL
    from repro_torch.models import vision as V

    cfg = V.VisionConfig(kind=kind, num_layers=2, d_model=128, num_heads=4, d_ff=256, num_patches=64,
                         num_classes=10, patch_dim=48, token_ff=64, sparse=True, sparse_density=0.4,
                         sparse_block=block)
    cpu = V.init_vision(cfg, seed=0, device="cpu")
    with torch.no_grad():
        cpu.head.w.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    card = V.init_vision(cfg, device=cuda, params=cpu.state_dict())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64, 48)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 4))
    out = {}
    launches = KERNEL.launches
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        logits = model(x.to(dev))
        loss = torch.nn.functional.cross_entropy(logits, y.to(dev))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name] = (logits.detach().cpu(), loss.item(), [g.cpu() for g in grads])
    (lc, fc, gc), (lg, fg, gg) = out["cpu"], out["card"]
    assert _allclose(lg, lc, 1e-4)
    assert abs(fg - fc) <= 1e-5 * abs(fc)
    for a, w in zip(gg, gc):
        assert _err(a, w) <= 1e-4 * w.abs().max().item()
    sparse = sum(isinstance(m, Linear) and m.spec.sparse for m in card.modules())
    assert KERNEL.launches - launches == 2 * sparse


# ----------------------------------------------------------------------
# head dim 80 (zamba2-2.7b), and the MoE, SSM and hybrid smoke models
# ----------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_block_sparse_attention_kernel_head_dim_80(cuda, b, dtype, tol):
    """zamba2-2.7b's attention: G = 1, H = Hk = 32, D = 80, S = 2048,
    block 128, causal, against the plain version."""
    q, k, v, kv_index, valid = _attention_inputs(b, 2048, 32, 1, 80, 128, dtype, cuda, seed=80 + b)
    kw = dict(block=128, causal=True, sm_scale=80 ** -0.5)
    got = block_sparse_attention_cuda(q, k, v, kv_index, valid, **kw)
    want = ref.sparse_attention(q.reshape(b, 2048, 32, 1, 80), k, v, kv_index, valid, **kw)
    assert torch.isfinite(got.float()).all()
    assert _err(got, want.reshape(b, 2048, 32, 80)) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_block_sparse_attention_grads_head_dim_80(cuda, dtype, tol):
    """``BlockSparseAttention`` at D = 80 (the kernel forward, the plain
    gradient backward) against autograd of ``ref.sparse_attention``, as
    ``test_block_sparse_attention_grads_on_card`` at D = 128."""
    from repro_torch.kernels import autograd as AG

    b, s, hk, g, d, block = 1, 1024, 32, 1, 80, 128
    kv_index, valid = L._schedule_tensors(s, block, 2, 0, 1, str(cuda))
    gen = torch.Generator(device=cuda).manual_seed(80)
    q = torch.randn((b, s, hk, g, d), generator=gen, device=cuda).to(dtype).requires_grad_()
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=cuda).to(dtype).requires_grad_()
            for _ in range(2))
    do = torch.randn((b, s, hk, g, d), generator=gen, device=cuda).to(dtype)
    kw = dict(block=block, causal=True, sm_scale=d ** -0.5)
    o = AG.block_sparse_attention(q, k, v, kv_index, valid, **kw)
    got = torch.autograd.grad(o, (q, k, v), do)
    o_ref = ref.sparse_attention(q, k, v, kv_index, valid, **kw)
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    assert _err(o, o_ref) <= tol
    for a, w in zip(got, want):
        assert _rel(a, w) <= tol


@pytest.mark.parametrize("d", [32, 96, 256])
def test_block_sparse_attention_kernel_refuses_other_head_dims(cuda, d):
    q, k, v, kv_index, valid = _attention_inputs(1, 256, 2, 1, d, 64, torch.bfloat16, cuda, seed=0)
    with pytest.raises(ValueError, match="head dims 64, 80, 128"):
        block_sparse_attention_cuda(q, k, v, kv_index, valid, block=64, causal=True, sm_scale=0.1)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b", "mamba2-130m", "zamba2-2.7b"])
def test_moe_ssm_smoke_streams_card_equals_cpu(cuda, arch):
    """fp32 sparse smoke models, the same seeded weights on both devices:
    the MoE two through the paged engine (ragged prompts, whose padding
    reaches the router), the SSM two through the ``Server`` (one prefill
    pass); equal greedy streams."""
    cfg = registry.get_smoke(arch, sparse=True)
    got = {}
    for dev in ("cpu", cuda):
        if cfg.family == "moe":
            page = cfg.attn_block
            eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=2, max_len=16 * page), seed=0, device=dev)
            work = [(np.random.default_rng(n).integers(0, cfg.vocab_size, n).astype(np.int32), 6)
                    for n in (9 * page + 20, 2 * page + 1, 40)]
            uids = {eng.submit(p, n): i for i, (p, n) in enumerate(work)}
            got[str(dev)] = {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=500)}
        else:
            prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 133)).astype(np.int32)
            got[str(dev)] = Server(cfg, seed=0, device=dev).generate(prompts, 8).tolist()
    assert got["cpu"] == got[str(cuda)]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-130m", "zamba2-2.7b"])
def test_moe_ssm_train_step_on_card_equals_cpu(cuda, arch):
    """One fp32 ``make_train_step`` step of the sparse smoke model, held as
    ``test_train_step_on_card_equals_cpu`` holds the dense family's."""
    test_train_step_on_card_equals_cpu(cuda, arch)


def _guard_engine(dev, n_reqs=3, max_new=32):
    """A smoke engine (2 layers, fp32) with ``n_reqs`` greedy requests
    admitted and one decode step taken: the next steps are steady."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=2, vocab_size=128)
    eng = Engine(cfg, engine_cfg=EngineConfig(max_slots=4, max_len=256), device=dev)
    rng = np.random.default_rng(11)
    for _ in range(n_reqs):
        eng.submit(rng.integers(0, cfg.vocab_size, 70).astype(np.int32), max_new)
    assert not eng.step() and len(eng.scheduler.active()) == n_reqs
    return eng


def test_guard_clean_on_card_decode_loop(cuda):
    """Steady-state decode on the card inside ``DispatchGuard`` (the sync
    debug mode armed): no kernel-library build, no implicit sync, one
    explicit fetch a step; the engine drains afterwards."""
    from repro_torch.analysis.guards import DispatchGuard

    eng = _guard_engine(cuda)
    with DispatchGuard(max_compiles=0) as g:
        for _ in range(6):
            assert not eng.step()
    assert (g.compiles, g.implicit_syncs, g.explicit_syncs) == (0, 0, 6)
    assert torch.cuda.get_sync_debug_mode() == 0  # unwound
    assert len(eng.drain(max_steps=200)) == 3


@pytest.mark.parametrize("leak", ["item", "cpu"])
def test_guard_trips_on_card(cuda, leak):
    """An ``.item()`` (a patched Tensor method) or a ``.cpu()`` (caught by
    the sync debug mode) injected into the decode step raises
    ``HostSyncError``."""
    from repro_torch.analysis.guards import DispatchGuard, HostSyncError
    from repro_torch.models import transformer as T

    eng = _guard_engine(cuda)
    decode_step = T.decode_step_paged

    def leaky(*a, **kw):
        out = decode_step(*a, **kw)
        if leak == "item":
            out[0][0, 0].item()
        else:
            out[0].cpu()
        return out

    T.decode_step_paged = leaky
    try:
        with pytest.raises(HostSyncError):
            with DispatchGuard(max_compiles=0) as g:
                eng.step()
    finally:
        T.decode_step_paged = decode_step
    assert g.implicit_syncs == 1
    assert torch.cuda.get_sync_debug_mode() == 0


def test_roofline_on_card_equals_cpu(cuda):
    """``Engine.roofline()`` is available on the card and counts the same
    FLOPs and bytes as on the CPU, for the same model and engine: the
    kernels report their own cost, the ops inside their plain versions
    are not counted."""
    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    ecfg = EngineConfig(max_slots=4, max_len=256)
    card = Engine(cfg, engine_cfg=ecfg, device=cuda).roofline()
    cpu = Engine(cfg, engine_cfg=ecfg, device="cpu").roofline()
    assert card["available"] and card["flops"] > 0
    assert (card["flops"], card["bytes_accessed"]) == (cpu["flops"], cpu["bytes_accessed"])


@pytest.mark.parametrize("sampled", [False, True])
def test_router_streams_on_card_equal_one_engine(cuda, sampled):
    """``ReplicaRouter(replicas=2)`` on one card, its replicas sharing one
    engine's weights: streams equal that engine's, by router uid, and the
    requests split 3 and 3."""
    from repro_torch.serving.router import ReplicaRouter

    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=2, vocab_size=256)
    ecfg = EngineConfig(max_slots=4, max_len=128)
    eng = Engine(cfg, engine_cfg=ecfg, device=cuda)
    rng = np.random.default_rng(5)
    work = [rng.integers(1, 250, int(n)).astype(np.int32) for n in (9, 17, 5, 12, 30, 64)]

    def sp(i):
        return SamplingParams(temperature=0.8, top_k=40, seed=100 + i) if sampled else None

    uids = {eng.submit(p, 12, sampling=sp(i)): i for i, p in enumerate(work)}
    want = {uids[f.uid]: f.tokens.tolist() for f in eng.drain(max_steps=200)}
    router = ReplicaRouter(cfg, replicas=2, engine_cfg=ecfg, params=eng.model.state_dict(), devices=[cuda, cuda])
    ruids = {router.submit(p, 12, sampling=sp(i)): i for i, p in enumerate(work)}
    got = {ruids[f.uid]: f.tokens.tolist() for f in router.drain(max_steps=200)}
    assert got == want
    assert [e.stats.finished for e in router.engines] == [3, 3]


def test_guard_on_card_passes_host_tensors(cuda):
    """With the card in use a CPU tensor is host memory: converting it is
    no sync and passes; a tensor on the card trips, and ``device_get``
    of it is one explicit sync."""
    from repro_torch.analysis import guards
    from repro_torch.analysis.guards import DispatchGuard, HostSyncError

    on_card = torch.arange(4.0, device=cuda)
    with DispatchGuard(max_compiles=None) as g:
        assert float(torch.tensor(2.0)) == 2.0 and torch.arange(3).tolist() == [0, 1, 2]
        assert guards.device_get(on_card).tolist() == [0.0, 1.0, 2.0, 3.0]
        with pytest.raises(HostSyncError):
            on_card[1].item()
    assert (g.implicit_syncs, g.explicit_syncs) == (1, 1)


# ----------------------------------------------------------------------
# tensor-parallel serving: the kernels at a shard's shapes, the tp engine
# ----------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("linear", ["q", "kv", "gate/up", "down"])
@pytest.mark.parametrize("m", [8, 300])
def test_bsr_matmul_kernel_tp_shard_shapes(cuda, tp, linear, m):
    """Full-width qwen3-1.7b's linears as tp shards hold them: each rank's
    block rows of the global pattern (q 16, kv 8, gate/up 48, down 16 rows
    of 128 over tp), bf16, against the plain version (2e-2)."""
    full = registry.get("qwen3-1.7b", sparse=True)
    dims = {"q": (full.d_model, full.q_dim), "kv": (full.d_model, full.kv_dim),
            "gate/up": (full.d_model, full.d_ff), "down": (full.d_ff, full.d_model)}[linear]
    pat = linear_spec(full, *dims, False).pattern()
    nb = pat.nb_out // tp
    rng = np.random.default_rng(tp * 100 + m)
    x = _t(rng.standard_normal((m, dims[0])), torch.bfloat16, cuda)
    for r in range(tp):
        cols = torch.as_tensor(pat.cols[r * nb : (r + 1) * nb], device=cuda)
        blocks = _t(rng.standard_normal((nb, pat.r, pat.block, pat.block)) / np.sqrt(pat.r * pat.block),
                    torch.bfloat16, cuda)
        y = bsr_matmul_cuda(x, blocks, cols)
        assert y.shape == (m, nb * pat.block)
        torch.testing.assert_close(y.float(), ref.bsr_matmul_gather(x, blocks, cols).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("tp", [2, 4])
def test_attention_kernels_tp_shard_shapes(cuda, tp):
    """Each shard's heads of full-width qwen3-1.7b (H 16 / tp, Hk 8 / tp,
    D 128, bf16): the paged decode read on a shard's pool and the
    block-sparse prefill, against their plain versions (1e-2, 2e-2)."""
    h, hk, d, page = 16 // tp, 8 // tp, 128, 128
    g = h // hk
    rng = np.random.default_rng(tp)
    b, pps = 8, 16
    n_pages = b * pps + 1
    k = _t(rng.standard_normal((n_pages, page, hk, d)), torch.bfloat16, cuda)
    v = _t(rng.standard_normal((n_pages, page, hk, d)), torch.bfloat16, cuda)
    table = torch.as_tensor(rng.permutation(n_pages - 1)[: b * pps].reshape(b, pps) + 1, dtype=torch.int32,
                            device=cuda)
    pos = torch.as_tensor(rng.integers(0, pps * page, b), dtype=torch.int32, device=cuda)
    q = _t(rng.standard_normal((b, hk, g, d)), torch.bfloat16, cuda)
    logical, phys, keep = paged_sparse_schedule(table, pos, page, local_blocks=2, global_blocks=1)
    args = (q, k, v, phys, logical, keep, pos)
    torch.testing.assert_close(paged_decode_attention_cuda(*args, sm_scale=d ** -0.5).float(),
                               ref.paged_decode_attention_gather(*args, sm_scale=d ** -0.5).float(),
                               rtol=1e-2, atol=1e-2)
    s = 1024
    sched = ap.block_schedule(ap.pixelfly_attention_block_mask(
        s, s, ap.AttentionPatternConfig(block=page, local_blocks=2, global_blocks=1), causal=True), page, page)
    qs = _t(rng.standard_normal((1, s, h, d)), torch.bfloat16, cuda)
    ks = _t(rng.standard_normal((1, s, hk, d)), torch.bfloat16, cuda)
    vs = _t(rng.standard_normal((1, s, hk, d)), torch.bfloat16, cuda)
    kv_index, valid = torch.as_tensor(sched.kv_index, device=cuda), torch.as_tensor(sched.valid, device=cuda)
    kw = dict(block=page, causal=True, sm_scale=d ** -0.5)
    got = block_sparse_attention_cuda(qs, ks, vs, kv_index, valid, **kw)
    want = ref.sparse_attention(qs.reshape(1, s, hk, g, d), ks, vs, kv_index, valid, **kw).reshape(1, s, h, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("sampled", [False, True])
def test_tp2_engine_streams_on_card_equal_tp1(cuda, sampled):
    """Smoke qwen3-1.7b (fp32) at tp 2 on the card twice (a (1, 2) mesh of
    one device): streams equal the tp 1 engine's on the same weights, the
    three kernels launch, and every shard's pool lies on the card."""
    from repro_torch.kernels import bsr_attention, bsr_matmul, paged_attention
    from repro_torch.launch.mesh import make_tp_mesh

    cfg = registry.get_smoke("qwen3-1.7b", sparse=True).replace(num_layers=2, vocab_size=256)
    ecfg = EngineConfig(max_slots=4, max_len=256, prefix_cache=True)
    one = Engine(cfg, engine_cfg=ecfg, device=cuda)
    eng = Engine(cfg, engine_cfg=ecfg, params=one.model.state_dict(), mesh=make_tp_mesh(2, [cuda, cuda]))
    assert eng.paged_impl == "cuda" and eng.distinct_devices == 1
    assert all(buf.is_cuda for pool in eng.kv.pools() for buf in pool.values())
    rng = np.random.default_rng(6)
    work = [rng.integers(1, 250, int(n)).astype(np.int32) for n in (9, 70, 5, 130, 30, 64)]

    def serve_all(e):
        uids = {}
        for i, p in enumerate(work):
            sp = SamplingParams(temperature=0.8, top_k=40, seed=100 + i) if sampled else None
            uids[e.submit(p, 10, sampling=sp)] = i
        return {uids[f.uid]: f.tokens.tolist() for f in e.drain(max_steps=200)}

    want = serve_all(one)
    kernels = (bsr_matmul.KERNEL, paged_attention.KERNEL, bsr_attention.KERNEL)
    for k in kernels:
        k.launches = 0
    assert serve_all(eng) == want
    assert all(k.launches > 0 for k in kernels)


@pytest.mark.parametrize("strategy", ["fsdp", "tp"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_count_on_card_equals_meta(cuda, strategy, kind):
    """A smoke cell of ``launch.dryrun`` on a (2, 2) mesh of the card counts
    what its meta count counts: FLOPs, bytes, collectives and memory (the
    kernels report their own cost, meta runs none of them)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    from repro_torch.models import transformer as T

    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    shape = ShapeSpec("x", 256, 4, kind)
    meta = D.count_cell(cfg, shape, Mesh(("data", "model"), (2, 2), ["meta"] * 4), strategy=strategy)
    sd = T.init_model(cfg, seed=0, device=cuda).state_dict()
    card = D.count_cell(cfg, shape, make_local_mesh(2, 2, [cuda] * 4), strategy=strategy, params=sd)
    a, b = meta["cost"], card["cost"]
    assert (a.flops, a.bytes_accessed, a.collective_bytes) == (b.flops, b.bytes_accessed, b.collective_bytes)
    for key in ("argument_bytes", "temp_bytes", "output_bytes"):
        assert meta[key] == card[key], key


def test_sharded_prefill_decode_tp2_on_card_equals_cpu(cuda):
    """``transformer.prefill`` and 6 greedy ``decode_step`` calls on a tp
    (1, 2) ``MeshState`` of the card (smoke, fp32) give the CPU's tokens,
    and the block-sparse attention and BSR kernels launch."""
    from repro_torch.kernels import bsr_attention, bsr_matmul
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training.loop import MeshState

    cfg = registry.get_smoke("qwen3-1.7b", sparse=True)
    sd = T.init_model(cfg, seed=0, device="cpu").state_dict()
    toks = np.random.default_rng(3).integers(1, 250, size=(4, 128)).astype(np.int64)

    def greedy(dev):
        state = MeshState(cfg, make_local_mesh(1, 2, [dev, dev]), "tp", sd)
        lp, caches = T.prefill(cfg, state, {"tokens": torch.as_tensor(toks, device=dev)}, max_len=256)
        out, nxt = [], lp.argmax(-1)
        for i in range(6):
            out.append(nxt.tolist())
            ld, _ = T.decode_step(cfg, state, caches, nxt, 128 + i)
            nxt = ld.argmax(-1)
        return out

    want = greedy(torch.device("cpu"))
    kernels = (bsr_matmul.KERNEL, bsr_attention.KERNEL)
    for k in kernels:
        k.launches = 0
    assert greedy(cuda) == want
    assert all(k.launches > 0 for k in kernels)
