// The decode read on page pools cut along head_dim, for Hopper (sm_90a):
// tensor-parallel serving where tp does not divide the kv heads.
//
// Replaces, on such a mesh, the TPU kernel paged_decode_attention_pallas
// (src/repro/kernels/paged_attention.py, body _kernel). There the JAX rules
// put each shard's pools on a slice of head_dim (sharding._paged_pool_spec,
// layers.paged_pool_entry), and GSPMD splits the kernel's work over it. The
// kernel's softmax needs whole dot products, which no shard holds, so the
// read is cut in two around the all-reduce of the scores:
//
// (a) paged_decode_scores_launch: one shard's partial scores. For slot b,
//     kv head hk and schedule slot t (grid (w, Hk, B), one block each), the
//     G query rows' slices q[b, hk, g, :Dc] dot every visible key row of the
//     scheduled page phys[b, t] (its slice of the head dim), in fp32. A key
//     logical[b, t] * page + j is visible iff it is <= pos[b] and keep[b, t]
//     is set (as the whole kernel's rule); a key that is not scores 0, and
//     a page with no visible key reads nothing. The scores go to an fp32
//     (B, Hk, G, w * page) tensor, key t * page + j at column t * page + j.
// Between (a) and (b) the caller sums the shards' scores in rank order
// (distributed.collectives.all_reduce): the unscaled dot products over the
// whole head dim.
// (b) paged_decode_apply_launch: for query row g of slot b and kv head hk
//     (grid (G, Hk, B), one block each), the masked softmax of sm_scale
//     times the summed scores, in fp32, then P @ V over the shard's slice
//     of the value rows. The block takes the row's max and sum over all
//     w * page scores (a strided pass and a block reduction each), then
//     walks the keys in tiles of 64: P of the tile (normalised, rounded to
//     the pool dtype, as the plain version's p.to(v.dtype)) and the tile's
//     visible V rows are staged in shared memory; its threads form 128 / D
//     groups of D lanes, each group summing every (128 / D)-th key of the
//     tile in fp32, and the groups' sums are added at the end. A row with
//     no visible key gives 0. The G rows of a (slot, kv head) read the same
//     V rows, the second time from L2.
//
// What bounds them on this card: both are ~1 FLOP a byte, bound by the
// bytes of the visible keys' K or V slices and of the fp32 scores (written
// by (a), read by (b)); at the main shape (8 slots, a few pages each) a
// call is a few microseconds of traffic and the time is the launch and the
// dependent reads. A simple kernel that is right: plain fp32 FMAs (no
// tensor cores, no TF32), scalar loads, no split of a slot's walk.
#include "common.cuh"

namespace {

constexpr int kMaxG = 8;       // query rows per kv head
constexpr int kMaxD = 128;     // head-dim slice
constexpr int kThreads = 128;  // threads of a block, both kernels
constexpr int kTile = 64;      // keys of one staged tile in (b)

struct Sched {
  const int* phys;
  const int* logical;
  const int* keep;
  const int* pos;
};

// keys 0 .. n-1 of schedule slot t of slot b are visible (n = 0: none)
__device__ __forceinline__ int visible_keys(const Sched& sc, int b, int t,
                                            int w, int page) {
  const int slot = b * w + t;
  const int base = sc.logical[slot] * page;
  const int p_b = sc.pos[b];
  if (sc.keep[slot] == 0 || base > p_b) return 0;
  return min(page, p_b - base + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ k, Sched sc,
    float* __restrict__ scores, int G, int D, int page, long long s_page,
    long long s_row, long long s_head) {
  __shared__ float qs[kMaxG][kMaxD];
  const int t = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int w = gridDim.x;
  const int Hk = gridDim.y;
  const int W = w * page;
  const int n_vis = visible_keys(sc, b, t, w, page);
  float* out = scores + (static_cast<size_t>(b) * Hk + hk) * G * W + t * page;
  if (n_vis == 0) {  // block-uniform
    for (int e = threadIdx.x; e < G * page; e += kThreads)
      out[static_cast<size_t>(e / page) * W + e % page] = 0.f;
    return;
  }
  for (int e = threadIdx.x; e < G * D; e += kThreads)
    qs[e / D][e % D] = repro::to_float(
        q[((static_cast<size_t>(b) * Hk + hk) * G + e / D) * D + e % D]);
  __syncthreads();
  const T* kp = k + static_cast<size_t>(sc.phys[b * w + t]) * s_page +
                static_cast<size_t>(hk) * s_head;
  for (int j = threadIdx.x; j < page; j += kThreads) {
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    if (j < n_vis) {
      const T* row = kp + static_cast<size_t>(j) * s_row;
      for (int d = 0; d < D; ++d) {
        const float kv = repro::to_float(row[d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(qs[g][d], kv, acc[g]);
      }
    }
    for (int g = 0; g < G; ++g) out[static_cast<size_t>(g) * W + j] = acc[g];
  }
}

// the block's max (op 0) or sum (op 1) of one value a thread
template <int OP>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  v = OP == 0 ? repro::warp_max(v) : repro::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float x = red[0];
  for (int u = 1; u < kThreads / 32; ++u) x = OP == 0 ? fmaxf(x, red[u]) : x + red[u];
  __syncthreads();  // red is reused by the next reduction
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_apply_kernel(
    const float* __restrict__ scores, const T* __restrict__ v, Sched sc,
    T* __restrict__ out, int D, int page, int w, long long s_page,
    long long s_row, long long s_head, float sm_scale) {
  __shared__ float red[kThreads / 32];
  __shared__ float ps[kTile];
  __shared__ float vs[kTile][kMaxD];
  __shared__ float part[kThreads];
  const int g = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = gridDim.x;
  const int Hk = gridDim.y;
  const int W = w * page;
  const float* s = scores + ((static_cast<size_t>(b) * Hk + hk) * G + g) * W;
  auto visible = [&](int c) {
    return c % page < visible_keys(sc, b, c / page, w, page);
  };

  // the row's max and sum over its visible keys
  float m = -INFINITY;
  for (int c = threadIdx.x; c < W; c += kThreads)
    if (visible(c)) m = fmaxf(m, s[c] * sm_scale);
  m = block_reduce<0>(m, red);
  float l = 0.f;
  if (m != -INFINITY)
    for (int c = threadIdx.x; c < W; c += kThreads)
      if (visible(c)) l += expf(s[c] * sm_scale - m);
  l = block_reduce<1>(l, red);

  // P @ V a tile of keys at a time: the threads form 128 / D groups of D
  // lanes, lane d of group u accumulating output d over keys u, u + groups,
  // ... of the tile; the groups' sums are added in group order at the end
  const int groups = kThreads / D;
  const int grp = threadIdx.x / D;
  const int d = threadIdx.x % D;
  float acc = 0.f;
  for (int c0 = 0; c0 < W; c0 += kTile) {
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const int c = c0 + e;
      float p = 0.f;
      if (c < W && m != -INFINITY && visible(c))
        p = repro::to_float(repro::from_float<T>(expf(s[c] * sm_scale - m) / l));
      ps[e] = p;
    }
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int c = c0 + e / D;
      float x = 0.f;
      if (c < W && visible(c))
        x = repro::to_float(
            v[static_cast<size_t>(sc.phys[b * w + c / page]) * s_page +
              static_cast<size_t>(c % page) * s_row +
              static_cast<size_t>(hk) * s_head + e % D]);
      vs[e / D][e % D] = x;
    }
    __syncthreads();
    if (grp < groups)
      for (int kk = grp; kk < kTile; kk += groups) acc = fmaf(ps[kk], vs[kk][d], acc);
    __syncthreads();  // the next tile overwrites ps and vs
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < D) {
    float o = 0.f;
    for (int u = 0; u < groups; ++u) o += part[u * D + threadIdx.x];
    out[((static_cast<size_t>(b) * Hk + hk) * G + g) * D + threadIdx.x] =
        repro::from_float<T>(o);
  }
}

bool bad_shape(int B, int Hk, int G, int D, int page, int w, int dtype) {
  return B < 1 || Hk < 1 || G < 1 || G > kMaxG || D < 1 || D > kMaxD ||
         page < 1 || w < 1 || (dtype != REPRO_F32 && dtype != REPRO_BF16);
}

}  // namespace

// q (B, Hk, G, D) contiguous, D the shard's slice of the head dim; the
// key pool k (n_pages, page, Hk, D) through its element strides (last axis
// contiguous); phys, logical, keep (B, w) and pos (B,) int32; scores (B,
// Hk, G, w * page) fp32. G <= 8, D <= 128. Returns cudaGetLastError().
extern "C" int paged_decode_scores_launch(
    const void* q, const void* k, const void* phys, const void* logical,
    const void* keep, const void* pos, void* scores, int B, int Hk, int G,
    int D, int page, int w, long long s_page, long long s_row,
    long long s_head, int dtype, void* stream) {
  if (bad_shape(B, Hk, G, D, page, w, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sched sc{static_cast<const int*>(phys), static_cast<const int*>(logical),
                 static_cast<const int*>(keep), static_cast<const int*>(pos)};
  const dim3 grid(w, Hk, B);
  float* out = static_cast<float*>(scores);
  if (dtype == REPRO_BF16)
    paged_scores_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), sc, out, G, D, page, s_page,
        s_row, s_head);
  else
    paged_scores_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), sc, out, G,
        D, page, s_page, s_row, s_head);
  return static_cast<int>(cudaGetLastError());
}

// scores (B, Hk, G, w * page) fp32, the shards' sum; the value pool v
// (n_pages, page, Hk, D) through its element strides; the schedule as
// above; out (B, Hk, G, D) contiguous, in the pool's dtype. Returns
// cudaGetLastError().
extern "C" int paged_decode_apply_launch(
    const void* scores, const void* v, const void* phys, const void* logical,
    const void* keep, const void* pos, void* out, int B, int Hk, int G, int D,
    int page, int w, long long s_page, long long s_row, long long s_head,
    float sm_scale, int dtype, void* stream) {
  if (bad_shape(B, Hk, G, D, page, w, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sched sc{static_cast<const int*>(phys), static_cast<const int*>(logical),
                 static_cast<const int*>(keep), static_cast<const int*>(pos)};
  const dim3 grid(G, Hk, B);
  const float* s = static_cast<const float*>(scores);
  if (dtype == REPRO_BF16)
    paged_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        s, static_cast<const __nv_bfloat16*>(v), sc,
        static_cast<__nv_bfloat16*>(out), D, page, w, s_page, s_row, s_head,
        sm_scale);
  else
    paged_apply_kernel<float><<<grid, kThreads, 0, st>>>(
        s, static_cast<const float*>(v), sc, static_cast<float*>(out), D, page,
        w, s_page, s_row, s_head, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
