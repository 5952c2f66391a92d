// Flat-block-butterfly (BSR) sparse matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel bsr_matmul_pallas (src/repro/kernels/bsr_matmul.py,
// body _kernel): y[:, i*b:(i+1)*b] = sum_t x[:, cols[i,t]*b : +b] @ blocks[i,t]
// with fp32 accumulation; duplicate cols entries of a stretched pattern sum.
//
// What bounds it on this card: at decode (M = 8 rows) every weight block is
// read once and used for 8 rows, about 2 FLOPs per byte, far below the ~295
// FLOPs/byte where the H100 stops being memory bound, so the bound is the
// weight bytes. At prefill (M in the thousands) the FLOPs dominate.
//
// Design: the TPU version carried an fp32 accumulator across a sequential
// grid axis over the r slots. Blocks run in parallel in no order here, so
// one thread block owns an output tile (BM rows x one output block of b
// columns) and loops over the r slots itself, staging a BK-deep slice of the
// gathered x tile and of the weight block in shared memory. The gather of x
// at column block cols[i,t] is the sparsity: no other input column is read.
// Products are plain fp32 FMAs (no TF32), so fp32 inputs keep fp32 accuracy.
// The ragged edge of M is masked, not padded; BM = 64.
//
// At decode (M <= 16) that tiling gives only nb_out thread blocks (16 for
// q), each walking r * b / 32 staged slices one after the other, so the
// card idles on load latency. The skinny kernel below splits each output
// block into 32-column strips (4x the blocks), stages the gathered x slice
// of one slot at a time, and lets each of 8 warps stream every 8th weight
// row of the strip straight from memory (lane = column, 16 independent
// loads in flight per thread and slot), summing the warps' partial sums in
// shared memory at the end. This is the simple version: mma.sync / wgmma
// and TMA pipelining are later work.
#include "common.cuh"

namespace {

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

constexpr int kSkinnyM = 16;     // rows the skinny (decode) kernel takes
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

template <typename T, int B>
void launch_b(const T* x, const T* blocks, const int* cols, T* y, int M,
              int n_in, int nb_out, int r, cudaStream_t stream) {
  if (M <= kSkinnyM) {
    dim3 grid(nb_out, B / kStrip);
    bsr_matmul_skinny_kernel<T, B><<<grid, kSkinnyWarps * 32, 0, stream>>>(
        x, blocks, cols, y, M, n_in, nb_out, r);
  } else {
    dim3 grid((M + 63) / 64, nb_out);
    bsr_matmul_kernel<T, 64, B>
        <<<grid, kThreads, 0, stream>>>(x, blocks, cols, y, M, n_in, nb_out, r);
  }
}

template <typename T>
int launch_typed(const void* x, const void* blocks, const void* cols, void* y,
                 int M, int n_in, int nb_out, int r, int b,
                 cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(blocks);
  const int* ct = static_cast<const int*>(cols);
  T* yt = static_cast<T*>(y);
  if (b == 64) {
    launch_b<T, 64>(xt, bt, ct, yt, M, n_in, nb_out, r, stream);
  } else if (b == 128) {
    launch_b<T, 128>(xt, bt, ct, yt, M, n_in, nb_out, r, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, n_in), blocks (nb_out, r, b, b), cols (nb_out, r) int32,
// y (M, nb_out * b); all contiguous, x/blocks/y of one dtype.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bsr_matmul_launch(const void* x, const void* blocks,
                                 const void* cols, void* y, int M, int n_in,
                                 int nb_out, int r, int b, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_typed<float>(x, blocks, cols, y, M, n_in, nb_out, r, b, s);
  if (dtype == REPRO_BF16)
    return launch_typed<__nv_bfloat16>(x, blocks, cols, y, M, n_in, nb_out, r,
                                       b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
