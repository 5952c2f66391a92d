// Causal block-sparse flash attention over a static schedule, for Hopper
// (sm_90a): the prefill attention of the pixelfly pattern.
//
// Replaces the TPU kernel block_sparse_attention_pallas
// (src/repro/kernels/bsr_attention.py, body _kernel): each block_q-row query
// block visits only the key blocks kv_index[qb, t] with valid[qb, t] == 1
// (local window + butterfly XOR strides + global cross), with the element
// causal mask inside boundary blocks and an online softmax in fp32.
//
// What bounds it on this card: with ~6 scheduled key blocks of 128 per
// query block, the scores and P @ V are ~1.5k FLOPs per query row per head
// dimension, well above the bytes of q, k, v and out; it is bound by
// operations (at the tensor-core rate for bf16).
//
// Design: the TPU kernel took q, k, v as (batch * heads, S, D) with K/V
// repeated up to every query head. Here q is (B, S, H, D) and k, v are
// (B, S, Hk, D), the layout the projections produce, and query head h reads
// kv head h / (H / Hk) directly: grouped-query attention without
// materialising the repeat. A 128-row query block's scores do not fit one
// thread block's registers in fp32, so a thread block takes 16 query rows
// of one (batch, head) and walks the schedule of its query block, staging
// 32 keys of K and V at a time in shared memory. Each query row is owned by
// 8 neighbouring lanes: each scores 4 keys, the 8 lanes reduce the row's max
// and sum with shuffles, and each accumulates D / 8 output dimensions.
// Sub-tiles that lie wholly above the causal diagonal are skipped. Plain fp32
// FMAs; mma.sync / wgmma and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kRows = 16;     // query rows per thread block
constexpr int kKeys = 32;     // keys per staged sub-tile
constexpr int kLanes = 8;     // lanes per query row
constexpr int kThreads = kRows * kLanes;
constexpr int kKeysPerLane = kKeys / kLanes;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) block_sparse_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_index, const int* __restrict__ valid,
    T* __restrict__ out, int S, int H, int Hk, int nkv, int block, int causal,
    float sm_scale) {
  constexpr int DPT = D / kLanes;  // output dims per thread
  __shared__ float qs[kRows][D + 1];
  __shared__ float ks[kKeys][D + 1];
  __shared__ float vs[kKeys][D];
  __shared__ float ps[kRows][kKeys];

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int sub = tid % kLanes;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * kRows;  // first query row of this thread block
  const int qb = q0 / block;          // its query block in the schedule
  const int qpos = q0 + row;

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    qs[r][d] = repro::to_float(
                   q[((static_cast<size_t>(b) * S + q0 + r) * H + h) * D + d]) *
               sm_scale;
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.f;

  for (int t = 0; t < nkv; ++t) {
    if (valid[qb * nkv + t] == 0) continue;  // block-uniform
    const int kb0 = kv_index[qb * nkv + t] * block;
    for (int s0 = 0; s0 < block; s0 += kKeys) {
      const int k0 = kb0 + s0;
      // block-uniform: this and every later sub-tile of the key block lie
      // above the diagonal for all 16 rows
      if (causal && k0 > q0 + kRows - 1) break;
      __syncthreads();  // the previous sub-tile's readers are done
      for (int e = tid; e < kKeys * D; e += kThreads) {
        const int kk = e / D;
        const int d = e % D;
        const size_t off =
            ((static_cast<size_t>(b) * S + k0 + kk) * Hk + hk) * D + d;
        ks[kk][d] = repro::to_float(k[off]);
        vs[kk][d] = repro::to_float(v[off]);
      }
      __syncthreads();

      float s[kKeysPerLane];
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const int kk = sub + kLanes * u;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qs[row][d], ks[kk][d], dot);
        const bool visible = !causal || (k0 + kk <= qpos);
        s[u] = visible ? dot : -INFINITY;
        tmax = fmaxf(tmax, s[u]);
      }
      // the row's 8 lanes are neighbours in one warp
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m, tmax);
      float alpha = 1.f;
      float rsum = 0.f;
      if (m_new == -INFINITY) {  // nothing visible yet in this row
#pragma unroll
        for (int u = 0; u < kKeysPerLane; ++u) s[u] = 0.f;
      } else {
        alpha = expf(m - m_new);
#pragma unroll
        for (int u = 0; u < kKeysPerLane; ++u) {
          s[u] = expf(s[u] - m_new);
          rsum += s[u];
        }
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l = l * alpha + rsum;
      m = m_new;
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) ps[row][sub + kLanes * u] = s[u];
      __syncwarp();
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = sub + kLanes * e;
        float a = acc[e] * alpha;
#pragma unroll 8
        for (int kk = 0; kk < kKeys; ++kk) a = fmaf(ps[row][kk], vs[kk][d], a);
        acc[e] = a;
      }
    }
  }

  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* orow = out + ((static_cast<size_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    const int d = sub + kLanes * e;
    orow[d] = repro::from_float<T>(acc[e] * inv);
  }
}

template <typename T, int D>
void launch_d(const T* q, const T* k, const T* v, const int* kv_index,
              const int* valid, T* out, int B, int S, int H, int Hk, int nkv,
              int block, int causal, float sm_scale, cudaStream_t stream) {
  dim3 grid(S / kRows, B * H);
  block_sparse_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      q, k, v, kv_index, valid, out, S, H, Hk, nkv, block, causal, sm_scale);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* kv_index, const void* valid, void* out, int B,
                 int S, int H, int Hk, int D, int nkv, int block, int causal,
                 float sm_scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* it = static_cast<const int*>(kv_index);
  const int* vv = static_cast<const int*>(valid);
  T* ot = static_cast<T*>(out);
  if (D == 64) {
    launch_d<T, 64>(qt, kt, vt, it, vv, ot, B, S, H, Hk, nkv, block, causal,
                    sm_scale, stream);
  } else if (D == 128) {
    launch_d<T, 128>(qt, kt, vt, it, vv, ot, B, S, H, Hk, nkv, block, causal,
                     sm_scale, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out (B, S, H, D); k, v (B, S, Hk, D); all contiguous, one dtype.
// kv_index, valid (S / block, nkv) int32. D in {64, 128}; block a multiple
// of 32; S a multiple of block; H a multiple of Hk. Returns
// cudaGetLastError() after the launch.
extern "C" int block_sparse_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_index,
    const void* valid, void* out, int B, int S, int H, int Hk, int D, int nkv,
    int block, int causal, float sm_scale, int dtype, void* stream) {
  if (block % kKeys != 0 || S % block != 0 || H % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_typed<float>(q, k, v, kv_index, valid, out, B, S, H, Hk, D,
                               nkv, block, causal, sm_scale, s);
  if (dtype == REPRO_BF16)
    return launch_typed<__nv_bfloat16>(q, k, v, kv_index, valid, out, B, S, H,
                                       Hk, D, nkv, block, causal, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
