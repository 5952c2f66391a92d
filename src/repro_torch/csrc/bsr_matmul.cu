// Flat-block-butterfly (BSR) sparse matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel bsr_matmul_pallas (src/repro/kernels/bsr_matmul.py,
// body _kernel): y[:, i*b:(i+1)*b] = sum_t x[:, cols[i,t]*b : +b] @ blocks[i,t]
// with fp32 accumulation; duplicate cols entries of a stretched pattern sum.
//
// What bounds it on this card: at decode (M <= 16 rows) every weight block
// is read once and used for at most 16 rows, about 2-16 FLOPs per byte, far
// below the ~295 FLOPs/byte where the H100 stops being memory bound, so the
// bound is the weight bytes (and, for ~1 MB of weights, the latency of one
// round trip to memory). At prefill (M in the thousands) the bytes of x and
// y and the FLOPs are within 2x of each other at the tensor-core rate.
//
// The TPU version carried an fp32 accumulator across a sequential grid
// axis over the r slots. Blocks run in parallel in no order here, so every
// design below loops over the slots inside a block, or reduces across
// blocks in a fixed order.
//
// bf16, M > 16: bsr_matmul_tc_kernel. One thread block (4 warps) owns a
// 128-row x b-column output tile (row tile m, output block i) and walks the
// r slots as r * b / 64 k-slices of depth 64. Each slice stages the
// gathered x slice x[m-tile, cols[i,t]*b + k0 : +64] (128 contiguous bytes
// a row) and rows k0..k0+63 of blocks[i,t] (row-major (k, n)) with 16-byte
// cp.async into a 3-stage ring, so the loads of the next two slices are in
// flight while the tensor cores work on this one. Warps are 2 x 2; each
// owns a 64 x b/2 tile of fp32 accumulators in registers across all r
// slots. A comes through ldmatrix, B through ldmatrix.trans from the
// row-major weight tile, and mma.sync m16n8k16 bf16 -> fp32 multiplies:
// 8 ldmatrix.x4 (4 KB of shared memory) feed 32 MMAs, so at 128 bytes a
// cycle shared memory keeps pace with the tensor cores (8 warps of 32 x 64
// need 6 for 16, and were slower on the H100). What bounds it is the
// traffic from L2: every output block reads its r x slices and every row
// tile the weights again, 64 FLOPs per byte at this 128 x 128 tile.
// Shared rows are padded by 16 bytes, so the 8 row addresses of an
// ldmatrix fall in 8 different bank groups. Rows past M are zero-filled by
// the copy and not stored. The output is cast to bf16 once. Grid x runs
// over the output blocks, so the blocks that share an x tile run together
// and find it in L2. Shared memory 107,520 bytes (b = 128) and 240
// registers a thread: two blocks an SM.
// mma.sync and not wgmma: with a gather per slot and only 2-7 slots, the
// tile loop is short; mma.sync over a cp.async ring is the simpler design
// that reaches the tensor cores, and wgmma + TMA is later work.
//
// bf16, M <= 16: bsr_matmul_decode_kernel. The weights of output block i
// are the r * b contiguous rows of blocks[i]. A cluster of 8 thread blocks
// splits them into 8 runs of r * b / 8 rows (32 rows of 256 bytes for q),
// so a q-shaped call runs 16 x 8 = 128 blocks. Lanes read 16 bytes (8 bf16)
// of a weight row each, neighbouring lanes on neighbouring addresses, 8
// loads in flight per thread, the first of them issued before the block's
// slice of x (M x its rows, fp32) is staged in shared memory, once. Each
// thread keeps an M x 8 fp32 sum (M rounded up to 8 or 16: 126 or 192
// registers); lanes that share columns are summed by shuffles, warps write
// their sums to shared memory, and after a cluster barrier block c sums
// columns c*b/8 .. +b/8 over the 8 blocks' shared memory (distributed
// shared memory), in rank then warp order. No atomics: the order of every
// sum is fixed, so two launches give the same bits. With ~1 MB of weights
// a call (q), latency and not bytes sets its time: the launch, the
// dependent reads of cols and x, and the cluster barrier.
//
// fp32 (any M): the SIMT kernels below, true fp32 FMAs (no TF32): a BM = 64
// shared-memory tiled kernel, and for M <= 16 a skinny kernel that splits
// each output block into 32-column strips, stages x one slot at a time and
// lets each warp stream every 8th weight row.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// ---- fp32: SIMT kernels ------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBK = 32;        // depth of one staged slice

template <typename T, int BM, int B>
__global__ void __launch_bounds__(kThreads)
    bsr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ blocks,
                      const int* __restrict__ cols, T* __restrict__ y, int M,
                      int n_in, int nb_out, int r) {
  constexpr int RM = BM / 16;  // output rows per thread
  constexpr int CN = B / 16;   // output columns per thread
  __shared__ float xs[BM][kBK + 1];
  __shared__ float ws[kBK][B];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i = blockIdx.y;  // output block
  const int m0 = blockIdx.x * BM;

  float acc[RM][CN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[a][c] = 0.f;

  for (int t = 0; t < r; ++t) {
    const int c0 = cols[i * r + t] * B;  // first input column of slot t
    const T* w = blocks + (static_cast<size_t>(i) * r + t) * B * B;
    for (int k0 = 0; k0 < B; k0 += kBK) {
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int row = e / kBK;
        const int kk = e % kBK;
        const int m = m0 + row;
        xs[row][kk] =
            m < M ? repro::to_float(x[static_cast<size_t>(m) * n_in + c0 + k0 + kk])
                  : 0.f;
      }
      for (int e = tid; e < kBK * B; e += kThreads) {
        const int kk = e / B;
        const int c = e % B;
        ws[kk][c] = repro::to_float(w[static_cast<size_t>(k0 + kk) * B + c]);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[RM];
        float bv[CN];
#pragma unroll
        for (int a = 0; a < RM; ++a) av[a] = xs[ty * RM + a][kk];
#pragma unroll
        for (int c = 0; c < CN; ++c) bv[c] = ws[kk][tx + 16 * c];
#pragma unroll
        for (int a = 0; a < RM; ++a)
#pragma unroll
          for (int c = 0; c < CN; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
      }
      __syncthreads();
    }
  }

  const size_t n_out = static_cast<size_t>(nb_out) * B;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int m = m0 + ty * RM + a;
    if (m < M) {
#pragma unroll
      for (int c = 0; c < CN; ++c)
        y[static_cast<size_t>(m) * n_out + static_cast<size_t>(i) * B + tx + 16 * c] =
            repro::from_float<T>(acc[a][c]);
    }
  }
}

constexpr int kSkinnyM = 16;     // rows the skinny (decode) kernels take
constexpr int kSkinnyWarps = 8;
constexpr int kStrip = 32;       // output columns per thread block

template <typename T, int B>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
    bsr_matmul_skinny_kernel(const T* __restrict__ x,
                             const T* __restrict__ blocks,
                             const int* __restrict__ cols, T* __restrict__ y,
                             int M, int n_in, int nb_out, int r) {
  constexpr int kT = kSkinnyWarps * 32;
  __shared__ float xs[kSkinnyM][B];
  __shared__ float red[kSkinnyWarps][kSkinnyM][kStrip];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x;                  // output block
  const int c = blockIdx.y * kStrip + lane;  // this lane's column in block i

  float acc[kSkinnyM];
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m) acc[m] = 0.f;

  for (int t = 0; t < r; ++t) {
    const int c0 = cols[i * r + t] * B;
    __syncthreads();  // the previous slot's readers of xs are done
    for (int e = threadIdx.x; e < kSkinnyM * B; e += kT) {
      const int m = e / B;
      const int k = e % B;
      xs[m][k] = m < M ? repro::to_float(x[static_cast<size_t>(m) * n_in + c0 + k])
                       : 0.f;
    }
    __syncthreads();
    const T* w = blocks + (static_cast<size_t>(i) * r + t) * B * B + c;
#pragma unroll
    for (int k = warp; k < B; k += kSkinnyWarps) {
      const float wv = repro::to_float(w[static_cast<size_t>(k) * B]);
#pragma unroll
      for (int m = 0; m < kSkinnyM; ++m) acc[m] = fmaf(xs[m][k], wv, acc[m]);
    }
  }

#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  const size_t n_out = static_cast<size_t>(nb_out) * B;
  for (int e = threadIdx.x; e < kSkinnyM * kStrip; e += kT) {
    const int m = e / kStrip;
    const int l = e % kStrip;
    if (m < M) {
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kSkinnyWarps; ++u) sum += red[u][m][l];
      y[static_cast<size_t>(m) * n_out + static_cast<size_t>(i) * B +
        blockIdx.y * kStrip + l] = repro::from_float<T>(sum);
    }
  }
}

template <int B>
void launch_f32(const float* x, const float* blocks, const int* cols, float* y,
                int M, int n_in, int nb_out, int r, cudaStream_t stream) {
  if (M <= kSkinnyM) {
    dim3 grid(nb_out, B / kStrip);
    bsr_matmul_skinny_kernel<float, B><<<grid, kSkinnyWarps * 32, 0, stream>>>(
        x, blocks, cols, y, M, n_in, nb_out, r);
  } else {
    dim3 grid((M + 63) / 64, nb_out);
    bsr_matmul_kernel<float, 64, B>
        <<<grid, kThreads, 0, stream>>>(x, blocks, cols, y, M, n_in, nb_out, r);
  }
}

// ---- bf16, M > 16: tensor cores over a cp.async ring --------------------

constexpr int kTcBM = 128;     // output rows per thread block
constexpr int kTcBK = 64;      // depth of one k-slice
constexpr int kTcStages = 3;   // slices in the shared-memory ring
constexpr int kTcThreads = 128;  // 2 x 2 warps of 64 x b/2 each
constexpr int kPad = 8;        // bf16 of padding at the end of a shared row

template <int B>
struct TcTile {
  static constexpr int kXRow = kTcBK + kPad;   // shared row of the x slice
  static constexpr int kWRow = B + kPad;       // shared row of the weight slice
  static constexpr int kXStage = kTcBM * kXRow;
  static constexpr int kWStage = kTcBK * kWRow;
  static constexpr int kSmemBytes =
      kTcStages * (kXStage + kWStage) * static_cast<int>(sizeof(bf16));
};

template <int B>
__global__ void __launch_bounds__(kTcThreads, 2)
    bsr_matmul_tc_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ blocks,
                         const int* __restrict__ cols, bf16* __restrict__ y,
                         int M, int n_in, int nb_out, int r) {
  using S = TcTile<B>;
  constexpr int kWM = kTcBM / 2;          // warp tile rows (2 x 2 warps)
  constexpr int kWN = B / 2;              // warp tile columns
  constexpr int kMT = kWM / 16;           // m16 tiles of a warp
  constexpr int kNT = kWN / 8;            // n8 tiles of a warp
  constexpr int kPerSlot = B / kTcBK;     // k-slices per slot
  constexpr int kXChunks = kTcBM * kTcBK / 8;  // 16-byte chunks per slice
  constexpr int kWChunks = kTcBK * B / 8;
  static_assert(kXChunks % kTcThreads == 0 && kWChunks % kTcThreads == 0,
                "every thread copies the same number of chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = xs + kTcStages * S::kXStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int i = blockIdx.x;  // output block
  const int m0 = blockIdx.y * kTcBM;
  const int n_slices = r * kPerSlot;

  auto load = [&](int s) {
    const int t = s / kPerSlot;
    const int k0 = (s % kPerSlot) * kTcBK;
    const int c0 = __ldg(cols + i * r + t) * B + k0;
    bf16* xd = xs + (s % kTcStages) * S::kXStage;
    bf16* wd = ws + (s % kTcStages) * S::kWStage;
#pragma unroll
    for (int u = 0; u < kXChunks / kTcThreads; ++u) {
      const int e = tid + u * kTcThreads;
      const int row = e / (kTcBK / 8);
      const int ch = e % (kTcBK / 8);
      const int m = m0 + row;
      const bf16* src =
          x + static_cast<size_t>(m < M ? m : 0) * n_in + c0 + ch * 8;
      repro::cp_async16(xd + row * S::kXRow + ch * 8, src, m < M);
    }
    const bf16* w = blocks + ((static_cast<size_t>(i) * r + t) * B + k0) * B;
#pragma unroll
    for (int u = 0; u < kWChunks / kTcThreads; ++u) {
      const int e = tid + u * kTcThreads;
      const int row = e / (B / 8);
      const int ch = e % (B / 8);
      repro::cp_async16(wd + row * S::kWRow + ch * 8, w + row * B + ch * 8);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  // prologue: slices 0 .. kTcStages-2 in flight (one group each, empty
  // groups past the end keep the count uniform)
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_slices) load(s);
    repro::cp_async_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    repro::cp_async_wait<kTcStages - 2>();  // slice s has landed
    // every thread's copies of slice s are visible, and every thread is
    // done with slice s - 1, whose stage the next load reuses
    __syncthreads();
    if (s + kTcStages - 1 < n_slices) load(s + kTcStages - 1);
    repro::cp_async_commit();

    const bf16* xt = xs + (s % kTcStages) * S::kXStage;
    const bf16* wt = ws + (s % kTcStages) * S::kWStage;
#pragma unroll
    for (int k16 = 0; k16 < kTcBK; k16 += 16) {
      unsigned a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        repro::ldmatrix_x4(
            a[mt], xt + (wm * kWM + mt * 16 + (lane & 15)) * S::kXRow + k16 +
                       (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned b[4];
        repro::ldmatrix_x4_trans(
            b, wt + (k16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::kWRow +
                   wn * kWN + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          repro::mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          repro::mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  repro::cp_async_wait<0>();

  const size_t n_out = static_cast<size_t>(nb_out) * B;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * kWM + mt * 16 + g + half * 8;
      if (m >= M) continue;
      bf16* yrow = y + static_cast<size_t>(m) * n_out +
                   static_cast<size_t>(i) * B + wn * kWN + c2;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<unsigned*>(yrow + nt * 8) = repro::pack_bf16(
            acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
  }
}

// ---- bf16, M <= 16: 16-byte weight streams, cluster reduction -----------

constexpr int kSplit = 8;        // thread blocks (one cluster) per output block
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecUnroll = 8;    // 16-byte weight loads in flight per thread

template <int MT>
struct DecXs {  // fp32 per staged x row: MT values, padded, 16-byte aligned
  static constexpr int kRow = MT + 4;
};

template <int B, int MT>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kDecThreads)
    bsr_matmul_decode_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ blocks,
                             const int* __restrict__ cols,
                             bf16* __restrict__ y, int M, int n_in, int nb_out,
                             int r) {
  constexpr int kLanesPerRow = B / 8;            // 16 bytes a lane
  constexpr int kGroups = kDecThreads / kLanesPerRow;  // rows read at once
  constexpr int kXS = DecXs<MT>::kRow;
  constexpr int kCols = B / kSplit;              // columns each block sums
  extern __shared__ __align__(16) float xs[];    // [R][kXS]
  __shared__ __align__(16) float red[kDecWarps][MT][B];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.y;  // output block
  const int tid = threadIdx.x;
  const int R = r * (B / kSplit);  // weight rows of this block
  const int j0 = c * R;            // its first row of the (r*b, b) matrix

  const int lc = tid % kLanesPerRow;  // columns lc*8 .. lc*8+7
  const int grp = tid / kLanesPerRow;
  const uint4* w = reinterpret_cast<const uint4*>(
      blocks + (static_cast<size_t>(i) * r * B + j0) * B + lc * 8);
  uint4 wv[kDecUnroll];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int jj = base + u * kGroups;
      wv[u] = jj < R ? __ldg(w + static_cast<size_t>(jj) * (B / 8))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  fetch(grp);  // the first weight rows are in flight while x is staged

  // x[m, cols[i, t]*b + k] for the block's rows j = t*b + k, as fp32
  for (int e = tid; e < MT * R; e += kDecThreads) {
    const int m = e / R;
    const int jj = e % R;
    const int gk = j0 + jj;
    float v = 0.f;
    if (m < M)
      v = __bfloat162float(x[static_cast<size_t>(m) * n_in +
                             __ldg(cols + i * r + gk / B) * B + gk % B]);
    xs[jj * kXS + m] = v;
  }
  __syncthreads();

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.f;

  for (int base = grp; base < R; base += kGroups * kDecUnroll) {
    if (base != grp) fetch(base);
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int jj = base + u * kGroups;
      if (jj >= R) break;
      const float wf[8] = {repro::bf16_lo(wv[u].x), repro::bf16_hi(wv[u].x),
                           repro::bf16_lo(wv[u].y), repro::bf16_hi(wv[u].y),
                           repro::bf16_lo(wv[u].z), repro::bf16_hi(wv[u].z),
                           repro::bf16_lo(wv[u].w), repro::bf16_hi(wv[u].w)};
      const float4* xr = reinterpret_cast<const float4*>(xs + jj * kXS);
#pragma unroll
      for (int q = 0; q < MT / 4; ++q) {
        const float4 xv = xr[q];
        const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[4 * q + a][e] = fmaf(xm[a], wf[e], acc[4 * q + a][e]);
      }
    }
  }

  // lanes of one warp that share columns, then the warps, then the blocks
#pragma unroll
  for (int o = kLanesPerRow; o < 32; o <<= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], o);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane < kLanesPerRow) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float4* dst = reinterpret_cast<float4*>(&red[warp][m][lc * 8]);
      dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
  cluster.sync();  // every block's red is written and visible to the cluster

  const size_t n_out = static_cast<size_t>(nb_out) * B;
  for (int e = tid; e < MT * kCols; e += kDecThreads) {
    const int m = e / kCols;
    const int col = c * kCols + e % kCols;
    if (m >= M) continue;
    float sum = 0.f;
#pragma unroll
    for (int rank = 0; rank < kSplit; ++rank) {
      const float* rr = cluster.map_shared_rank(&red[0][0][0], rank);
#pragma unroll
      for (int wp = 0; wp < kDecWarps; ++wp) sum += rr[(wp * MT + m) * B + col];
    }
    y[static_cast<size_t>(m) * n_out + static_cast<size_t>(i) * B + col] =
        __float2bfloat16_rn(sum);
  }
  cluster.sync();  // no block leaves while another still reads its red
}

template <int B, int MT>
int launch_decode(const bf16* x, const bf16* blocks, const int* cols, bf16* y,
                  int M, int n_in, int nb_out, int r, cudaStream_t stream) {
  const int smem = r * (B / kSplit) * DecXs<MT>::kRow * 4;
  auto kernel = bsr_matmul_decode_kernel<B, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(kSplit, nb_out), kDecThreads, smem, stream>>>(
      x, blocks, cols, y, M, n_in, nb_out, r);
  return 0;
}

template <int B>
int launch_bf16(const bf16* x, const bf16* blocks, const int* cols, bf16* y,
                int M, int n_in, int nb_out, int r, cudaStream_t stream) {
  if (M <= 8)
    return launch_decode<B, 8>(x, blocks, cols, y, M, n_in, nb_out, r, stream);
  if (M <= kSkinnyM)
    return launch_decode<B, 16>(x, blocks, cols, y, M, n_in, nb_out, r, stream);
  constexpr int smem = TcTile<B>::kSmemBytes;
  auto kernel = bsr_matmul_tc_kernel<B>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(nb_out, (M + kTcBM - 1) / kTcBM), kTcThreads, smem, stream>>>(
      x, blocks, cols, y, M, n_in, nb_out, r);
  return 0;
}

}  // namespace

// x (M, n_in), blocks (nb_out, r, b, b), cols (nb_out, r) int32,
// y (M, nb_out * b); all contiguous, x/blocks/y of one dtype, b in
// {64, 128}. bf16 pointers must be 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bsr_matmul_launch(const void* x, const void* blocks,
                                 const void* cols, void* y, int M, int n_in,
                                 int nb_out, int r, int b, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ct = static_cast<const int*>(cols);
  if (b != 64 && b != 128) return static_cast<int>(cudaErrorInvalidValue);
  int rc = 0;
  if (dtype == REPRO_F32) {
    const float* xt = static_cast<const float*>(x);
    const float* bt = static_cast<const float*>(blocks);
    float* yt = static_cast<float*>(y);
    if (b == 64)
      launch_f32<64>(xt, bt, ct, yt, M, n_in, nb_out, r, s);
    else
      launch_f32<128>(xt, bt, ct, yt, M, n_in, nb_out, r, s);
  } else if (dtype == REPRO_BF16) {
    const bf16* xt = static_cast<const bf16*>(x);
    const bf16* bt = static_cast<const bf16*>(blocks);
    bf16* yt = static_cast<bf16*>(y);
    rc = b == 64 ? launch_bf16<64>(xt, bt, ct, yt, M, n_in, nb_out, r, s)
                 : launch_bf16<128>(xt, bt, ct, yt, M, n_in, nb_out, r, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
