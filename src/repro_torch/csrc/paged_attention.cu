// Paged decode attention for Hopper (sm_90a): one query token per serving
// slot against the block-paged K/V pools, read in place.
//
// Replaces the TPU kernel paged_decode_attention_pallas
// (src/repro/kernels/paged_attention.py, body _kernel). For slot b and kv
// head hk, the G grouped query rows attend the keys of the w scheduled pages
// phys[b, t]; key position logical[b, t] * page + j is visible iff it is
// <= pos[b], which also neutralises the shared trash page 0 that idle slots
// and unallocated table entries alias; keep[b, t] == 0 drops a duplicate
// schedule slot (a butterfly XOR collision) so no key counts twice. Online
// softmax in fp32; the output is acc / l with l == 0 -> 1.
//
// What bounds it on this card: every scheduled K and V page row is used by
// only G query rows (G = 2 on the main path), so the work is ~1 FLOP per
// byte read: the bound is the bytes of the pages the schedule visits.
//
// Design: one thread block per (kv head, slot). There is no scalar
// prefetch, so the block reads its own row of phys/logical/keep. A slot
// with keep == 0, or whose first key lies beyond pos, adds nothing to the
// softmax, so it is skipped without reading its page (this is exact: the
// TPU kernel's update is the identity for an all-masked page); so is a
// chunk of a page whose first key lies beyond pos. A kept page is walked
// in chunks of 32 keys: the block stages the chunk's K and V rows of its
// head in shared memory (all threads, independent loads, so many are in
// flight), one warp per query row scores the 32 keys (lane = key) and
// updates that row's running max and sum, and every thread accumulates
// P @ V for its output dimensions from shared memory. The pools are read
// through their strides (page, row, head).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // keys staged at a time: one per lane
constexpr int kMaxG = 8;    // query rows per kv head
constexpr int kDPT = 2;     // output dims per thread: D <= 256

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ phys,
    const int* __restrict__ logical, const int* __restrict__ keep,
    const int* __restrict__ pos, T* __restrict__ out, int G, int D, int page,
    int w, long long stride_page, long long stride_row, long long stride_head,
    float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [G][D] query rows, sm_scale folded in
  float* ks = qs + G * D;              // [kChunk][D + 1] staged keys
  float* vs = ks + kChunk * (D + 1);   // [kChunk][D] staged values
  float* ps = vs + kChunk * D;         // [G][kChunk] probabilities
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float alpha_s[kMaxG];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int Hk = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + (static_cast<size_t>(b) * Hk + hk) * G * D;
  for (int e = tid; e < G * D; e += kThreads)
    qs[e] = repro::to_float(qb[e]) * sm_scale;
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kDPT][kMaxG];
#pragma unroll
  for (int u = 0; u < kDPT; ++u)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[u][g] = 0.f;
  const int p_b = pos[b];
  __syncthreads();

  for (int t = 0; t < w; ++t) {
    // block-uniform skips: a duplicate slot, or a page with no visible key
    if (keep[b * w + t] == 0) continue;
    const int base = logical[b * w + t] * page;
    if (base > p_b) continue;
    const size_t off = static_cast<size_t>(phys[b * w + t]) * stride_page +
                       static_cast<size_t>(hk) * stride_head;
    const T* kp = k_pages + off;
    const T* vp = v_pages + off;

    for (int c0 = 0; c0 < page; c0 += kChunk) {
      const int first = base + c0;
      if (first > p_b) break;  // block-uniform: the rest of the page is masked
      const int n = min(kChunk, page - c0);
      for (int e = tid; e < n * D; e += kThreads) {
        const int j = e / D;
        const int d = e % D;
        const size_t at = static_cast<size_t>(c0 + j) * stride_row + d;
        ks[j * (D + 1) + d] = repro::to_float(kp[at]);
        vs[j * D + d] = repro::to_float(vp[at]);
      }
      __syncthreads();

      // scores and the online-softmax update, one warp per query row,
      // lane j scoring key first + j; key `first` is visible, so the new
      // max is finite
      for (int g = warp; g < G; g += kWarps) {
        float s = -INFINITY;
        if (lane < n && first + lane <= p_b) {
          const float* kr = ks + lane * (D + 1);
          const float* qr = qs + g * D;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot;
        }
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, repro::warp_max(s));
        const float p = expf(s - m_new);  // exp(-inf) = 0 for masked keys
        ps[g * kChunk + lane] = p;
        const float sum = repro::warp_sum(p);
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          alpha_s[g] = a;
          l_s[g] = l_s[g] * a + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P @ V
#pragma unroll
      for (int u = 0; u < kDPT; ++u) {
        const int d = tid + u * kThreads;
        if (d < D) {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[u][g] *= alpha_s[g];
          for (int j = 0; j < n; ++j) {
            const float v = vs[j * D + d];
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) acc[u][g] = fmaf(ps[g * kChunk + j], v, acc[u][g]);
          }
        }
      }
      __syncthreads();  // ks, vs, ps and alpha_s are rewritten next chunk
    }
  }

  T* ob = out + (static_cast<size_t>(b) * Hk + hk) * G * D;
#pragma unroll
  for (int u = 0; u < kDPT; ++u) {
    const int d = tid + u * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float l = l_s[g];
          ob[g * D + d] = repro::from_float<T>(acc[u][g] / (l == 0.f ? 1.f : l));
        }
      }
    }
  }
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * (static_cast<size_t>(G) * D + kChunk * (D + 1) +
                          kChunk * D + G * kChunk);
}

template <typename T>
int launch_typed(const void* q, const void* k_pages, const void* v_pages,
                 const void* phys, const void* logical, const void* keep,
                 const void* pos, void* out, int B, int Hk, int G, int D,
                 int page, int w, long long stride_page, long long stride_row,
                 long long stride_head, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, D);
  dim3 grid(Hk, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(phys),
      static_cast<const int*>(logical), static_cast<const int*>(keep),
      static_cast<const int*>(pos), static_cast<T*>(out), G, D, page, w,
      stride_page, stride_row, stride_head, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out (B, Hk, G, D) contiguous; k_pages, v_pages (n_pages, page, Hk, D)
// with the given element strides (D contiguous); phys, logical, keep (B, w)
// and pos (B,) int32. G <= 8, D <= 256, and the staged chunk must fit the
// 48 KB of static shared memory (D <= 128 at G = 8). Returns
// cudaGetLastError().
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* phys,
    const void* logical, const void* keep, const void* pos, void* out, int B,
    int Hk, int G, int D, int page, int w, long long stride_page,
    long long stride_row, long long stride_head, float sm_scale, int dtype,
    void* stream) {
  if (G < 1 || G > kMaxG || D < 1 || D > kDPT * kThreads ||
      smem_bytes(G, D) + 3 * kMaxG * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_typed<float>(q, k_pages, v_pages, phys, logical, keep, pos,
                               out, B, Hk, G, D, page, w, stride_page,
                               stride_row, stride_head, sm_scale, s);
  if (dtype == REPRO_BF16)
    return launch_typed<__nv_bfloat16>(q, k_pages, v_pages, phys, logical,
                                       keep, pos, out, B, Hk, G, D, page, w,
                                       stride_page, stride_row, stride_head,
                                       sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
