// Paged decode attention for Hopper (sm_90a): one query token per serving
// slot against the block-paged K/V pools, read in place, as split-schedule
// flash-decoding.
//
// Replaces the TPU kernel paged_decode_attention_pallas
// (src/repro/kernels/paged_attention.py, body _kernel). For slot b and kv
// head hk, the G grouped query rows attend the keys of the w scheduled pages
// phys[b, t]; key position logical[b, t] * page + j is visible iff it is
// <= pos[b], which also neutralises the shared trash page 0 that idle slots
// and unallocated table entries alias; keep[b, t] == 0 drops a duplicate
// schedule slot (a butterfly XOR collision) so no key counts twice. Softmax
// statistics in fp32; the output is acc / l with l == 0 -> 1.
//
// What bounds it on this card: every scheduled K and V page row is used by
// only G query rows (G = 2 on the main path), so the work is ~1 FLOP per
// byte read: the bound is the bytes of the visible keys of the scheduled
// pages, a few MB per call, a few microseconds at 3.35 TB/s. At that size
// the time is latency: the chain of dependent reads (schedule, page,
// partials) and the launches.
//
// Design. The TPU kernel walks a slot's w pages one after another (its
// sequential grid axis). One block per (slot, kv head) would give B * Hk
// blocks (64 on the main path) for 132 SMs, each waiting on one page after
// another. Here the walk is split:
//
// 1. Split pass, grid (w, Hk, B): one block per schedule slot. It reads
//    its row of the schedule in one round of independent loads. A block
//    whose slot is not kept, or whose page starts beyond pos, reads
//    nothing more and writes an empty partial (m = -inf, l = 0); this is
//    exact, as the TPU kernel's update is the identity for such a page. A
//    kept block copies the visible rows of its page's K and V (head hk,
//    read through the pool strides) into shared memory with 16-byte
//    cp.async, in stages of 32 keys, several stages in flight (3 in bf16,
//    so 96 of a 128-key page are requested at once and the scores of one
//    stage overlap the copy of the next); rows past the last visible key
//    are zero-filled, not read. Each warp owns 16 (bf16) or 8 (fp32) keys
//    of a stage and keeps its own online softmax; at the end the warps'
//    partials are merged in warp order in shared memory, and the block
//    writes m, l (log2 units) and the unnormalised acc[G][D] to the fp32
//    workspace (B, Hk, w, G, D + 2) that the wrapper allocates.
//    - bf16, on the tensor cores (mma.sync m16n8k16), keys on the M side,
//      2 warps: S^T = K q^T with the K tile through ldmatrix and the G
//      query rows as the B fragment (n = 8, zero rows past G); O^T += V^T
//      P^T with V through ldmatrix.trans and P^T made from the score
//      accumulators by movmatrix (an 8x8 transpose in registers).
//      Unnormalised P is rounded to bf16 before P @ V, where the TPU kernel
//      casts it; the sums l stay fp32. The head dim is padded to 64, 128 or
//      256 in shared memory (zero-filled). At D = 128 a block takes 52 KB of
//      shared memory (4 blocks an SM). On the H100, stages of 32 or 64 keys
//      and 2 to 4 stages in flight measured within 5% of each other at the
//      main shape; what costs is the latency of the dependent reads.
//    - fp32, 4 warps: plain FMAs (no TF32) from float4 reads of shared
//      memory; a warp scores each of its keys with the lanes splitting the
//      head dim and a warp sum, and each lane accumulates 4 (D <= 128) or 8
//      output dims of all G rows.
// 2. Combine pass, grid (Hk, B): one block per (slot, kv head); each
//    thread reads m, l and its acc element of 8 partials in one round of
//    independent loads (all w of the sparse schedule) and folds them in
//    schedule order t = 0 .. w-1 into
//    sum_t acc_t 2^(m_t - M) / sum_t l_t 2^(m_t - M), rescaling by the new
//    max between rounds when w > 8. An empty partial weighs exactly 0 (its
//    acc is never used; 2^(-inf - -inf) is never evaluated), so a slot with
//    no visible key returns 0. The fixed order and the lack of atomics
//    give the same bits on every run.
// Both passes are launched from the one C entry point, on one stream; the
// combine pass is a programmatic dependent launch, so its blocks are
// resident and waiting (griddepcontrol.wait) when the split pass ends,
// instead of paying a launch gap after it.
#include <algorithm>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxG = 8;  // query rows per kv head: the n = 8 of the MMA
constexpr int kKeys = 32; // keys of one stage
constexpr float kLog2e = 1.4426950408889634f;

// Programmatic dependent launch (sm_90): the primary grid lets the next
// grid on the stream start; the dependent grid waits until the primary has
// finished and its writes are visible.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Shared memory the warps' partials take once the walk is done (they
// reuse the staging area): m and l [W][kMaxG], acc [W][G][D].
size_t merge_bytes(int W, int G, int D) {
  return sizeof(float) * (2 * W * kMaxG + static_cast<size_t>(W) * G * D);
}

// What one split block reads: its page and how many of its keys are
// visible.
struct Page {
  size_t off;   // element offset of (phys page, row 0, head hk) in the pools
  int n_vis;    // visible keys: 0 .. n_vis - 1 of the page
  float* part;  // this block's partial in the workspace: [G][D + 2]
};

// Read the block's schedule entry (all loads independent). Returns false,
// after writing an empty partial, when the page has no visible key.
__device__ __forceinline__ bool open_page(
    const int* __restrict__ phys, const int* __restrict__ logical,
    const int* __restrict__ keep, const int* __restrict__ pos, float* ws,
    int G, int D, int page, long long stride_page, long long stride_head,
    Page& pg) {
  const int t = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int w = gridDim.x;
  const int slot = b * w + t;
  const int kept = keep[slot];
  const int base = logical[slot] * page;
  const int ph = phys[slot];
  const int p_b = pos[b];
  pg.part = ws + ((static_cast<size_t>(b) * gridDim.y + hk) * w + t) * G * (D + 2);
  if (kept == 0 || base > p_b) {  // block-uniform
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      pg.part[g * (D + 2) + D] = -INFINITY;
      pg.part[g * (D + 2) + D + 1] = 0.f;
    }
    return false;
  }
  pg.n_vis = min(page, p_b - base + 1);
  pg.off = static_cast<size_t>(ph) * stride_page +
           static_cast<size_t>(hk) * stride_head;
  return true;
}

// Merge the W warps' partials (m, l, acc in shared memory) in warp order
// into the block's partial. A warp that saw no key (m = -inf) weighs 0.
template <int W>
__device__ __forceinline__ void merge_warps(const float* wm, const float* wl,
                                            const float* wacc, float* part,
                                            int G, int D) {
  for (int e = threadIdx.x; e < G * D; e += W * 32) {
    const int g = e / D;
    const int d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, wm[w * kMaxG + g]);
    float acc = 0.f;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float m = wm[w * kMaxG + g];
      if (m == -INFINITY) continue;
      const float a = exp2f(m - mx);
      acc = fmaf(a, wacc[(w * G + g) * D + d], acc);
      l = fmaf(a, wl[w * kMaxG + g], l);
    }
    float* pr = part + g * (D + 2);
    pr[d] = acc;
    if (d == 0) {
      pr[D] = mx;
      pr[D + 1] = l;
    }
  }
}

// ---- split pass, bf16: tensor cores ------------------------------------

constexpr int kBf16Warps = kKeys / 16;  // 16 keys (one m16 tile) a warp
constexpr int kBf16Threads = kBf16Warps * 32;
constexpr int kBf16Stages = 3;

template <int DT>  // head dim as staged: D padded up to 64, 128 or 256
struct Bf16Tile {
  static constexpr int kRow = DT + 8;  // bf16 per shared row (16 B pad)
  static constexpr int kStage = kKeys * kRow;
  static constexpr size_t kBytes = 2 * kBf16Stages * kStage * sizeof(bf16);
};

template <int DT>
__global__ void __launch_bounds__(kBf16Threads) paged_decode_split_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ phys,
    const int* __restrict__ logical, const int* __restrict__ keep,
    const int* __restrict__ pos, float* __restrict__ ws, int G, int D,
    int page, long long stride_page, long long stride_row,
    long long stride_head, float scale_log2) {
  using Tl = Bf16Tile<DT>;
  constexpr int kDT = DT / 16;  // k16 steps (scores), m16 tiles (P @ V)
  constexpr int kCh = DT / 8;   // 16-byte chunks of a staged row
  static_assert(kKeys * kCh % kBf16Threads == 0, "every thread copies as many chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [stage][key][kRow]
  bf16* vs = ks + kBf16Stages * Tl::kStage;

  pdl_launch_dependents();
  Page pg;
  if (!open_page(phys, logical, keep, pos, ws, G, D, page, stride_page,
                 stride_head, pg))
    return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_vis = pg.n_vis;
  const int n_stages = (n_vis + kKeys - 1) / kKeys;
  const bf16* kp = k_pages + pg.off;
  const bf16* vp = v_pages + pg.off;

  auto load = [&](int c) {
    bf16* kd = ks + (c % kBf16Stages) * Tl::kStage;
    bf16* vd = vs + (c % kBf16Stages) * Tl::kStage;
#pragma unroll
    for (int u = 0; u < kKeys * kCh / kBf16Threads; ++u) {
      const int e = tid + u * kBf16Threads;
      const int r = e / kCh;
      const int ch = e % kCh;
      const bool ok = c * kKeys + r < n_vis && ch * 8 < D;
      const size_t at =
          ok ? static_cast<size_t>(c * kKeys + r) * stride_row + ch * 8 : 0;
      repro::cp_async16(kd + r * Tl::kRow + ch * 8, kp + at, ok);
      repro::cp_async16(vd + r * Tl::kRow + ch * 8, vp + at, ok);
    }
  };
  // prologue: stages 0 .. kBf16Stages-2 in flight, one group each
#pragma unroll
  for (int c = 0; c < kBf16Stages - 1; ++c) {
    if (c < n_stages) load(c);
    repro::cp_async_commit();
  }

  // lane roles in the m16n8k16 fragments: gq is the B fragment's n (query
  // row) and the accumulators' row (key, or head dim); c2 the first of the
  // accumulators' two columns (query rows c2, c2 + 1)
  const int gq = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const bf16* qrow =
      q + ((static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * G + gq) * D;
  unsigned qf[kDT][2];  // q^T as B fragments: (d c2.., query gq), (d c2+8..)
#pragma unroll
  for (int kt = 0; kt < kDT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = kt * 16 + c2 + h * 8;
      qf[kt][h] = gq < G && d < D
                      ? *reinterpret_cast<const unsigned*>(qrow + d)
                      : 0u;
    }

  float o[kDT][4];  // O^T: (d, query c2), (d, c2+1), (d+8, c2), (d+8, c2+1)
#pragma unroll
  for (int mt = 0; mt < kDT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows c2, c2+1
  float l0 = 0.f, l1 = 0.f;              // this lane's share of their sums

  for (int c = 0; c < n_stages; ++c) {
    if (c + kBf16Stages - 1 < n_stages) load(c + kBf16Stages - 1);
    repro::cp_async_commit();
    repro::cp_async_wait<kBf16Stages - 1>();  // stage c has landed
    __syncthreads();
    const int key0 = c * kKeys + warp * 16;  // this warp's first key
    if (key0 < n_vis) {                      // warp-uniform
      const int st = (c % kBf16Stages) * Tl::kStage + warp * 16 * Tl::kRow;
      const bf16* kt_s = ks + st;
      const bf16* vt_s = vs + st;
      // S^T (16 keys x 8 query rows) = K q^T
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < kDT; ++kt) {
        unsigned a[4];
        repro::ldmatrix_x4(
            a, kt_s + (lane & 15) * Tl::kRow + kt * 16 + (lane >> 4) * 8);
        repro::mma_bf16_16816(s, a, qf[kt][0], qf[kt][1]);
      }
      // s: (key gq, row c2), (gq, c2+1), (gq+8, c2), (gq+8, c2+1)
      const bool lo = key0 + gq < n_vis;
      const bool hi = key0 + gq + 8 < n_vis;
      const float s0 = lo ? s[0] * scale_log2 : -INFINITY;
      const float s1 = lo ? s[1] * scale_log2 : -INFINITY;
      const float s2 = hi ? s[2] * scale_log2 : -INFINITY;
      const float s3 = hi ? s[3] * scale_log2 : -INFINITY;
      float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {  // the 8 lanes of a query row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with nothing visible yet subtracts 0: its p and alpha are 0
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      const float p0 = exp2f(s0 - mu0), p1 = exp2f(s1 - mu1);
      const float p2 = exp2f(s2 - mu0), p3 = exp2f(s3 - mu1);
      l0 = l0 * al0 + (p0 + p2);
      l1 = l1 * al1 + (p1 + p3);
      // P^T as the B fragment (k = key, n = query row): each 8-key half of
      // the accumulators is an 8x8 (key, row) matrix; transposed, lane l
      // holds keys c2, c2+1 of row gq
      const unsigned b0 = repro::movmatrix_trans(repro::pack_bf16(p0, p1));
      const unsigned b1 = repro::movmatrix_trans(repro::pack_bf16(p2, p3));
#pragma unroll
      for (int mt = 0; mt < kDT; ++mt) {
        o[mt][0] *= al0;
        o[mt][1] *= al1;
        o[mt][2] *= al0;
        o[mt][3] *= al1;
        unsigned a[4];  // V^T (16 dims x 16 keys)
        repro::ldmatrix_x4_trans(
            a, vt_s + ((lane & 7) + ((lane >> 4) & 1) * 8) * Tl::kRow +
                   mt * 16 + ((lane >> 3) & 1) * 8);
        repro::mma_bf16_16816(o[mt], a, b0, b1);
      }
    }
    __syncthreads();  // stage c is free for the copy of stage c + kBf16Stages
  }
  repro::cp_async_wait<0>();
#pragma unroll
  for (int x = 4; x < 32; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  __syncthreads();  // every copy has landed; the staging area is reused

  float* wm = reinterpret_cast<float*>(smem_raw);
  float* wl = wm + kBf16Warps * kMaxG;
  float* wacc = wl + kBf16Warps * kMaxG;  // [warp][G][D]
  if (lane < 4) {
    if (c2 < G) {
      wm[warp * kMaxG + c2] = m0;
      wl[warp * kMaxG + c2] = l0;
    }
    if (c2 + 1 < G) {
      wm[warp * kMaxG + c2 + 1] = m1;
      wl[warp * kMaxG + c2 + 1] = l1;
    }
  }
#pragma unroll
  for (int mt = 0; mt < kDT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = mt * 16 + gq + h * 8;
      if (d >= D) continue;
      if (c2 < G) wacc[(warp * G + c2) * D + d] = o[mt][2 * h];
      if (c2 + 1 < G) wacc[(warp * G + c2 + 1) * D + d] = o[mt][2 * h + 1];
    }
  }
  __syncthreads();
  merge_warps<kBf16Warps>(wm, wl, wacc, pg.part, G, D);
}

// ---- split pass, fp32: SIMT FMAs ----------------------------------------

constexpr int kF32Warps = 4;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32Stages = 2;
constexpr int kF32KeysPerWarp = kKeys / kF32Warps;

size_t f32_walk_bytes(int G, int D) {
  return sizeof(float) *
         (static_cast<size_t>(G) * D + 2 * kF32Stages * kKeys * D);
}

template <int kVec>  // float4 per lane over the head dim: D <= 128 * kVec
__global__ void __launch_bounds__(kF32Threads) paged_decode_split_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ phys,
    const int* __restrict__ logical, const int* __restrict__ keep,
    const int* __restrict__ pos, float* __restrict__ ws, int G, int D,
    int page, long long stride_page, long long stride_row,
    long long stride_head, float scale_log2) {
  constexpr int kKPW = kF32KeysPerWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [G][D]
  float* ks = qs + G * D;                          // [stage][key][D]
  float* vs = ks + kF32Stages * kKeys * D;

  pdl_launch_dependents();
  Page pg;
  if (!open_page(phys, logical, keep, pos, ws, G, D, page, stride_page,
                 stride_head, pg))
    return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_vis = pg.n_vis;
  const int n_stages = (n_vis + kKeys - 1) / kKeys;
  const float* kp = k_pages + pg.off;
  const float* vp = v_pages + pg.off;
  const int dv = D / 4;  // float4 of a row

  auto load = [&](int c) {
    float* kd = ks + (c % kF32Stages) * kKeys * D;
    float* vd = vs + (c % kF32Stages) * kKeys * D;
    for (int e = tid; e < kKeys * dv; e += kF32Threads) {
      const int r = e / dv;
      const int ch = e % dv;
      const bool ok = c * kKeys + r < n_vis;
      const size_t at =
          ok ? static_cast<size_t>(c * kKeys + r) * stride_row + ch * 4 : 0;
      repro::cp_async16(kd + r * D + ch * 4, kp + at, ok);
      repro::cp_async16(vd + r * D + ch * 4, vp + at, ok);
    }
  };
  load(0);
  repro::cp_async_commit();
  const float* qb =
      q + (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * G * D;
  for (int e = tid; e < G * D; e += kF32Threads) qs[e] = qb[e];

  float acc[kMaxG][4 * kVec];  // rows g, dims 4 (lane + 32 i) .. + 3
  float m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kVec; ++e) acc[g][e] = 0.f;
  }

  for (int c = 0; c < n_stages; ++c) {
    if (c + 1 < n_stages) load(c + 1);
    repro::cp_async_commit();
    repro::cp_async_wait<kF32Stages - 1>();
    __syncthreads();
    const int key0 = c * kKeys + warp * kKPW;
    if (key0 < n_vis) {  // warp-uniform
      const int st = (c % kF32Stages) * kKeys * D + warp * kKPW * D;
      const float* kw = ks + st;
      const float* vw = vs + st;
      const int nk = min(kKPW, n_vis - key0);  // visible keys of this warp
      float s[kKPW][kMaxG];
#pragma unroll
      for (int j = 0; j < kKPW; ++j) {
        float dot[kMaxG];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
        if (j < nk) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const int d = 4 * (lane + 32 * i);
            if (d < D) {
              const float4 kv = *reinterpret_cast<const float4*>(kw + j * D + d);
#pragma unroll
              for (int g = 0; g < kMaxG; ++g) {
                if (g < G) {
                  const float4 qv =
                      *reinterpret_cast<const float4*>(qs + g * D + d);
                  dot[g] = fmaf(qv.x, kv.x, dot[g]);
                  dot[g] = fmaf(qv.y, kv.y, dot[g]);
                  dot[g] = fmaf(qv.z, kv.z, dot[g]);
                  dot[g] = fmaf(qv.w, kv.w, dot[g]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          s[j][g] = g < G && j < nk ? repro::warp_sum(dot[g]) * scale_log2
                                    : -INFINITY;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) continue;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKPW; ++j) mx = fmaxf(mx, s[j][g]);
        const float mn = fmaxf(m[g], mx);  // finite: key key0 is visible
        const float al = exp2f(m[g] - mn);
        m[g] = mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKPW; ++j) {
          s[j][g] = exp2f(s[j][g] - mn);
          sum += s[j][g];
        }
        l[g] = l[g] * al + sum;
#pragma unroll
        for (int e = 0; e < 4 * kVec; ++e) acc[g][e] *= al;
      }
#pragma unroll
      for (int j = 0; j < kKPW; ++j) {
        if (j >= nk) break;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int d = 4 * (lane + 32 * i);
          if (d < D) {
            const float4 vv = *reinterpret_cast<const float4*>(vw + j * D + d);
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              if (g < G) {
                const float p = s[j][g];
                acc[g][4 * i + 0] = fmaf(p, vv.x, acc[g][4 * i + 0]);
                acc[g][4 * i + 1] = fmaf(p, vv.y, acc[g][4 * i + 1]);
                acc[g][4 * i + 2] = fmaf(p, vv.z, acc[g][4 * i + 2]);
                acc[g][4 * i + 3] = fmaf(p, vv.w, acc[g][4 * i + 3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // the staging area is reused

  float* wm = reinterpret_cast<float*>(smem_raw);
  float* wl = wm + kF32Warps * kMaxG;
  float* wacc = wl + kF32Warps * kMaxG;  // [warp][G][D]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      wm[warp * kMaxG + g] = m[g];
      wl[warp * kMaxG + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int d = 4 * (lane + 32 * i);
      if (d < D)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wacc[(warp * G + g) * D + d + e] = acc[g][4 * i + e];
    }
  }
  __syncthreads();
  merge_warps<kF32Warps>(wm, wl, wacc, pg.part, G, D);
}

// ---- combine pass ---------------------------------------------------------

constexpr int kCombineThreads = 128;
constexpr int kCombineRound = 8;  // partials read in one round of loads

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) paged_decode_combine_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int G, int D, int w) {
  const size_t bh = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int stride = G * (D + 2);  // floats of one schedule slot's partial
  const float* part = ws + bh * w * stride;
  T* ob = out + bh * G * D;
  pdl_wait();  // the split pass has finished and its partials are visible
  for (int e = threadIdx.x; e < G * D; e += kCombineThreads) {
    const float* pr = part + (e / D) * (D + 2);
    const int d = e % D;
    float mx = -INFINITY;  // max of the partials folded so far
    float l = 0.f;
    float acc = 0.f;
    // schedule order, kCombineRound partials at a time: the same bits every
    // run; at w <= kCombineRound (the sparse schedule) one round of loads
    for (int t0 = 0; t0 < w; t0 += kCombineRound) {
      float m[kCombineRound], lt[kCombineRound], x[kCombineRound];
#pragma unroll
      for (int u = 0; u < kCombineRound; ++u) {  // independent loads
        const bool in = t0 + u < w;
        const float* p = pr + static_cast<size_t>(t0 + u) * stride;
        m[u] = in ? p[D] : -INFINITY;
        lt[u] = in ? p[D + 1] : 0.f;
        x[u] = in ? p[d] : 0.f;
      }
      float mn = mx;
#pragma unroll
      for (int u = 0; u < kCombineRound; ++u) mn = fmaxf(mn, m[u]);
      if (mn == -INFINITY) continue;  // nothing visible yet
      if (mx != -INFINITY && mx != mn) {  // rescale what is folded so far
        const float r = exp2f(mx - mn);
        acc *= r;
        l *= r;
      }
      mx = mn;
#pragma unroll
      for (int u = 0; u < kCombineRound; ++u) {
        if (m[u] == -INFINITY) continue;  // an empty partial weighs exactly 0
        const float a = exp2f(m[u] - mx);
        acc = fmaf(a, x[u], acc);
        l = fmaf(a, lt[u], l);
      }
    }
    ob[e] = repro::from_float<T>(acc / (l == 0.f ? 1.f : l));
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
int smem_attr(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* phys;
  const int* logical;
  const int* keep;
  const int* pos;
  float* ws;
  int G, D, page;
  long long stride_page, stride_row, stride_head;
  float scale_log2;
};

template <int DT>
int split_bf16(const Args& a, dim3 grid, cudaStream_t stream) {
  const size_t smem =
      std::max(Bf16Tile<DT>::kBytes, merge_bytes(kBf16Warps, a.G, a.D));
  auto kernel = paged_decode_split_bf16_kernel<DT>;
  const int rc = smem_attr(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<grid, kBf16Threads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k_pages),
      static_cast<const bf16*>(a.v_pages), a.phys, a.logical, a.keep, a.pos,
      a.ws, a.G, a.D, a.page, a.stride_page, a.stride_row, a.stride_head,
      a.scale_log2);
  return 0;
}

template <int kVec>
int split_f32(const Args& a, dim3 grid, cudaStream_t stream) {
  const size_t smem =
      std::max(f32_walk_bytes(a.G, a.D), merge_bytes(kF32Warps, a.G, a.D));
  auto kernel = paged_decode_split_f32_kernel<kVec>;
  const int rc = smem_attr(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_pages),
      static_cast<const float*>(a.v_pages), a.phys, a.logical, a.keep, a.pos,
      a.ws, a.G, a.D, a.page, a.stride_page, a.stride_row, a.stride_head,
      a.scale_log2);
  return 0;
}

// The combine pass as a programmatic dependent launch of the split pass.
template <typename T>
int combine(const Args& a, void* out, int B, int Hk, int w,
            cudaStream_t stream) {
  auto kernel = paged_decode_combine_kernel<T>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hk, B);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(a.ws), static_cast<T*>(out),
      a.G, a.D, w));
}

}  // namespace

// q, out (B, Hk, G, D) contiguous; k_pages, v_pages (n_pages, page, Hk, D)
// with the given element strides (D contiguous); phys, logical, keep (B, w)
// and pos (B,) int32; ws an fp32 workspace of B * Hk * w * G * (D + 2).
// G <= 8, D <= 256; q and the pools 16-byte aligned, their rows and strides
// whole 16-byte chunks (D a multiple of 8 in bf16, of 4 in fp32). Launches
// the split pass and the combine pass on `stream`; returns the first CUDA
// error (cudaGetLastError() after each launch).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* phys,
    const void* logical, const void* keep, const void* pos, void* out,
    void* ws, int B, int Hk, int G, int D, int page, int w,
    long long stride_page, long long stride_row, long long stride_head,
    float sm_scale, int dtype, void* stream) {
  const int vec = dtype == REPRO_BF16 ? 8 : 4;  // elements of 16 bytes
  if (B < 1 || Hk < 1 || w < 1 || page < 1 || G < 1 || G > kMaxG || D < 1 ||
      D > 256 || D % vec != 0 || stride_row % vec != 0 ||
      stride_page % vec != 0 || stride_head % vec != 0 ||
      (dtype != REPRO_F32 && dtype != REPRO_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(phys), static_cast<const int*>(logical),
               static_cast<const int*>(keep), static_cast<const int*>(pos),
               static_cast<float*>(ws), G, D, page, stride_page, stride_row,
               stride_head, sm_scale * kLog2e};
  const dim3 grid(w, Hk, B);
  int rc;
  if (dtype == REPRO_BF16)
    rc = D <= 64 ? split_bf16<64>(a, grid, s)
                 : D <= 128 ? split_bf16<128>(a, grid, s)
                            : split_bf16<256>(a, grid, s);
  else
    rc = D <= 128 ? split_f32<1>(a, grid, s) : split_f32<2>(a, grid, s);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rc = dtype == REPRO_BF16 ? combine<bf16>(a, out, B, Hk, w, s)
                           : combine<float>(a, out, B, Hk, w, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
