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
// (a) paged_decode_scores_launch: one shard's partial scores, the G query
//     rows' slices q[b, hk, g, :Dc] dotted with every visible key row of the
//     scheduled page phys[b, t] (its slice of the head dim), in fp32. A key
//     logical[b, t] * page + j is visible iff it is <= pos[b] and keep[b, t]
//     is set (the whole kernel's rule); a key that is not scores 0. The
//     scores go to an fp32 (B, Hk, G, w * page) tensor, key t * page + j at
//     column t * page + j, unscaled.
// Between (a) and (b) the caller sums the shards' scores in rank order
// (distributed.collectives.all_reduce): the unscaled dot products over the
// whole head dim.
// (b) paged_decode_apply_launch: for each query row, the masked softmax of
//     sm_scale times the summed scores, in fp32, then P @ V over the shard's
//     slice of the value rows; a row with no visible key gives 0.
//
// What bounds them on this card: both are ~1 FLOP a byte, bound by the
// bytes of the visible keys' K or V slices and of the fp32 scores (written
// by (a), read by (b)). At the main shape (qwen2-1.5b at tp 4: 8 slots, 2
// kv heads, G = 6, slices of 32, w = 7 pages of 128) a call moves < 1 MB,
// under a microsecond at 3.35 TB/s: the time is the launch and the chain of
// dependent reads, so the design keeps that chain short and the card full.
//
// Design. Both kernels take one block of 128 threads per (chunk of a
// scheduled page, kv head, slot): grid (w * nc, Hk, B), a chunk being
// kKeys = 128 keys (nc = ceil(page / 128); at page 128 a block is a
// schedule slot, 112 blocks at the main shape). A block reads its schedule
// entry and pos[b] in one round of independent loads and works out its
// visible count n once; keys n .. of the chunk are never read.
//   Rows are copied into shared memory in 16-byte pieces (cp.async) where
// the slice, the pool strides and the base are whole 16-byte chunks, else
// element by element into the same padded layout (one kernel, a flag).
// Lanes then take 16-byte pieces of a row (E = 8 bf16 or 4 fp32 elements):
// lane l of a warp owns piece l % NCH of its row, NCH the pieces of a row
// rounded up to a power of two, so a warp covers 32 / NCH rows a step.
// Plain fp32 FMAs throughout (no TF32); SIMT and not mma.sync: at Dc = 32
// a chunk's product is 6 x 128 x 32 FMAs, 192 a thread, and on the H100 a
// variant of (a) that skipped the arithmetic was only a little faster: the
// time is the launch and the dependent reads. No wgmma or TMA: a block's
// tile is a few KB.
//   (a) The G query slices are copied with the key rows (one cp.async
//     group, so q costs no round trip of its own; scalar loads of q from
//     every lane measured slower), and each lane keeps its piece
//     of them in registers. A lane dots its piece of a key row with them,
//     the NCH lanes of a row add theirs (shuffles), and the block's (G,
//     chunk) tile of scores, zeros for keys past n, is written with float4
//     stores where the scores' rows are whole 16-byte chunks (page % 4 ==
//     0). Loading the key rows straight to registers, without the shared
//     copy, measured slower.
//   (b) Split pass: the chunk's visible V rows and the G rows' visible
//     scores are copied at once (both in flight together). A warp takes a
//     query row: max, then p = 2^(s * sm_scale * log2 e - m) once a score
//     (rounded to the pool dtype in place, as the plain version's
//     p.to(v.dtype); unnormalised, as paged_attention.cu rounds it) and
//     its sum l in fp32. Every lane then accumulates its piece of all G
//     output rows over its keys, the warp's key lanes are added by
//     shuffles and the warps' sums in warp order; the block writes m, l
//     (log2 units) and acc[G][Dc] to the fp32 workspace (B, Hk, w * nc, G,
//     Dc + 2) that the wrapper allocates. A chunk with no visible key
//     writes an empty partial (m = -inf, l = 0) and reads nothing more.
//     The G rows share one copy of the V rows.
//     Combine pass: the w * nc partials of an output element are cut into
//     P contiguous runs of at most 16 (P a power of two up to 32; 1 on
//     the sparse schedule), each folded in schedule order by a thread of
//     its own in one round of independent loads, as paged_attention.cu's
//     combine folds (an empty partial weighs exactly 0; a row with none
//     visible gives 0); the runs are then merged in order. A block takes
//     128 / P elements, grid (ceil(G * Dc * P / 128), Hk, B): on the dense
//     schedule of 256 pages a slot a single fold of 16 rounds on 16 blocks
//     held the call at over twice the time on the H100. It is a
//     programmatic dependent launch of the split pass, so it pays no
//     launch gap. No atomics anywhere: the same inputs give the same bits
//     on every call.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxG = 8;       // query rows per kv head
constexpr int kMaxD = 128;     // head-dim slice
constexpr int kThreads = 128;  // threads of a block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 128;     // keys of one block: a page, or a chunk of one
constexpr int kCombineRound = 16;  // partials read in one round of loads
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

struct Sched {
  const int* phys;
  const int* logical;
  const int* keep;
  const int* pos;
};

// What both kernels take: D is the shard's slice of the head dim (shared
// rows hold it rounded up to whole 16-byte pieces, DP), nc the chunks of a
// page, and the flags say which rows are read in 16-byte pieces.
struct Shape {
  int G, D, page, w, nc;
  long long s_page, s_row, s_head;  // pool strides, in elements
  bool pool_vec;    // pool rows read in 16-byte pieces
  bool scores_vec;  // score rows in 16-byte pieces (page % 4 == 0, aligned)
  bool q_vec;       // q rows in 16-byte pieces (the scores kernel's)
};

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte piece

template <typename T>
__device__ __forceinline__ int padded(int D) {
  return (D + kVec<T> - 1) / kVec<T> * kVec<T>;
}

// 16-byte pieces of a padded row, rounded up to a power of two (<= 32)
template <typename T>
__device__ __forceinline__ int pieces(int DP) {
  int n = 1;
  while (n * kVec<T> < DP) n <<= 1;
  return n;
}

// The block's chunk: schedule slot t, its keys key0 .. key0 + len - 1 of
// the page, of which 0 .. n - 1 are visible (all loads independent).
struct Chunk {
  int t, key0, len, n;
  size_t off;  // element offset of (phys page, row key0, head hk) in a pool
};

__device__ __forceinline__ Chunk open_chunk(const Sched& sc, const Shape& sh) {
  const int b = blockIdx.z;
  const int slot = b * sh.w + blockIdx.x / sh.nc;
  const int kept = sc.keep[slot];
  const int logical = sc.logical[slot];
  const int ph = sc.phys[slot];
  const int p_b = sc.pos[b];
  Chunk c;
  c.t = blockIdx.x / sh.nc;
  c.key0 = blockIdx.x % sh.nc * kKeys;
  c.len = min(kKeys, sh.page - c.key0);
  const int base = logical * sh.page + c.key0;
  c.n = (kept == 0 || base > p_b) ? 0 : min(c.len, p_b - base + 1);
  c.off = static_cast<size_t>(ph) * sh.s_page + static_cast<size_t>(c.key0) * sh.s_row +
          static_cast<size_t>(blockIdx.y) * sh.s_head;
  return c;
}

// Copy rows 0 .. n-1 of D elements (row r at src + r * s_row) into shared
// rows of DP elements: 16-byte cp.async where vec (then DP == D; the caller
// commits and waits), else element by element with the padding 0.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int n, int D, int DP, long long s_row,
                                           bool vec) {
  if (vec) {
    const int nch = DP / kVec<T>;
    for (int e = threadIdx.x; e < n * nch; e += kThreads) {
      const int r = e / nch;
      const int ch = e % nch;
      repro::cp_async16(dst + r * DP + ch * kVec<T>,
                        src + r * s_row + ch * kVec<T>);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < n * DP; e += kThreads) {
      const int r = e / DP;
      const int d = e % DP;
      dst[e] = d < D ? src[r * s_row + d] : repro::from_float<T>(0.f);
    }
  }
}

// The 16-byte piece at p (shared memory) as floats.
__device__ __forceinline__ void load_piece(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_piece(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = repro::bf16_lo(u[i]);
    x[2 * i + 1] = repro::bf16_hi(u[i]);
  }
}

// ---- (a) partial scores ---------------------------------------------------

// shared memory of the scores kernel: the scores [kMaxG][kKeys] (fp32),
// the key rows [kKeys][DP] and the query slices [kMaxG][DP]
size_t scores_smem(int DP, int es) {
  return sizeof(float) * kMaxG * kKeys + static_cast<size_t>(kKeys + kMaxG) * DP * es;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ k, Sched sc,
    float* __restrict__ scores, Shape sh) {
  constexpr int E = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = sh.G;
  const int DP = padded<T>(sh.D);
  float* st = reinterpret_cast<float*>(smem_raw);  // [kMaxG][kKeys] scores
  T* ks = reinterpret_cast<T*>(st + kMaxG * kKeys);  // [kKeys][DP] key rows
  T* qs = ks + kKeys * DP;                           // [kMaxG][DP] q slices
  const int W = sh.w * sh.page;
  const size_t bh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const Chunk c = open_chunk(sc, sh);
  if (c.n > 0) {  // block-uniform
    stage_rows(ks, k + c.off, c.n, sh.D, DP, sh.s_row, sh.pool_vec);
    stage_rows(qs, q + bh * G * sh.D, G, sh.D, DP, sh.D, sh.q_vec);
    repro::cp_async_commit();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nch = pieces<T>(DP);
    const int ch = lane & (nch - 1);
    const int d0 = ch * E;
    repro::cp_async_wait<0>();
    __syncthreads();
    float qv[kMaxG][E];  // this lane's piece of the G query slices
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G && d0 < DP) {
        load_piece(qs + g * DP + d0, qv[g]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qv[g][e] = 0.f;
      }
    }
    const int rows = 32 / nch;  // rows a warp takes a step
    for (int r0 = warp * rows; r0 < c.n; r0 += kWarps * rows) {  // warp-uniform
      const int r = r0 + lane / nch;
      float dot[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
      if (r < c.n && d0 < DP) {
        float x[E];
        load_piece(ks + r * DP + d0, x);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) dot[g] = fmaf(qv[g][e], x[e], dot[g]);
      }
      for (int o = 1; o < nch; o <<= 1)  // the row's pieces (same sum in every lane)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      if (r < c.n)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G && (g & (nch - 1)) == ch) st[g * kKeys + r] = dot[g];
    }
  }
  __syncthreads();
  // the (G, len) tile, keys n .. len - 1 scoring 0
  float* out = scores + bh * G * W + c.t * sh.page + c.key0;
  if (sh.scores_vec) {
    const int l4 = c.len / 4;
    for (int e = threadIdx.x; e < G * l4; e += kThreads) {
      const int g = e / l4;
      const int j = e % l4 * 4;
      float4 v;
      v.x = j < c.n ? st[g * kKeys + j] : 0.f;
      v.y = j + 1 < c.n ? st[g * kKeys + j + 1] : 0.f;
      v.z = j + 2 < c.n ? st[g * kKeys + j + 2] : 0.f;
      v.w = j + 3 < c.n ? st[g * kKeys + j + 3] : 0.f;
      *reinterpret_cast<float4*>(out + static_cast<size_t>(g) * W + j) = v;
    }
  } else {
    for (int e = threadIdx.x; e < G * c.len; e += kThreads) {
      const int g = e / c.len;
      const int j = e % c.len;
      out[static_cast<size_t>(g) * W + j] = j < c.n ? st[g * kKeys + j] : 0.f;
    }
  }
}

// ---- (b) softmax and P @ V: split pass --------------------------------------

// shared memory of the split pass: p [kMaxG][kKeys], m and l [kMaxG], the
// warps' sums [kWarps][G][DP] (fp32), then the V rows [kKeys][DP]
size_t apply_smem(int G, int DP, int es) {
  return sizeof(float) * (kMaxG * kKeys + 2 * kMaxG + static_cast<size_t>(kWarps) * G * DP) +
         static_cast<size_t>(kKeys) * DP * es;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_apply_split_kernel(
    const float* __restrict__ scores, const T* __restrict__ v, Sched sc,
    float* __restrict__ ws, Shape sh, float scale_log2) {
  constexpr int E = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = sh.G;
  const int D = sh.D;
  const int DP = padded<T>(D);
  float* ps = reinterpret_cast<float*>(smem_raw);  // [kMaxG][kKeys]
  float* ms = ps + kMaxG * kKeys;
  float* ls = ms + kMaxG;
  float* red = ls + kMaxG;  // [kWarps][G][DP]
  T* vs = reinterpret_cast<T*>(red + kWarps * G * DP);  // [kKeys][DP]

  pdl_launch_dependents();
  const size_t bh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const Chunk c = open_chunk(sc, sh);
  float* part = ws + (bh * gridDim.x + blockIdx.x) * G * (D + 2);
  if (c.n == 0) {  // block-uniform
    for (int g = threadIdx.x; g < G; g += kThreads) {
      part[g * (D + 2) + D] = -INFINITY;
      part[g * (D + 2) + D + 1] = 0.f;
    }
    return;
  }
  // the visible V rows and the G rows' visible scores, in flight together
  stage_rows(vs, v + c.off, c.n, D, DP, sh.s_row, sh.pool_vec);
  const float* s = scores + bh * G * sh.w * sh.page + c.t * sh.page + c.key0;
  const size_t W = static_cast<size_t>(sh.w) * sh.page;
  if (sh.scores_vec) {
    const int n4 = (c.n + 3) / 4;  // <= len / 4: inside the chunk
    for (int e = threadIdx.x; e < G * n4; e += kThreads)
      repro::cp_async16(ps + e / n4 * kKeys + e % n4 * 4, s + e / n4 * W + e % n4 * 4);
  } else {
    for (int e = threadIdx.x; e < G * c.n; e += kThreads)
      ps[e / c.n * kKeys + e % c.n] = s[e / c.n * W + e % c.n];
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < G; g += kWarps) {  // a warp a query row
    float* pr = ps + g * kKeys;
    float mx = -INFINITY;
    for (int j = lane; j < c.n; j += 32) mx = fmaxf(mx, pr[j] * scale_log2);
    mx = repro::warp_max(mx);  // finite: key 0 is visible
    float l = 0.f;
    for (int j = lane; j < c.n; j += 32) {
      const float p = exp2f(pr[j] * scale_log2 - mx);
      l += p;
      pr[j] = repro::to_float(repro::from_float<T>(p));
    }
    l = repro::warp_sum(l);
    if (lane == 0) {
      ms[g] = mx;
      ls[g] = l;
    }
  }
  __syncthreads();

  // P @ V: lane piece ch of all G rows over keys lane / nch, + 32 / nch, ...
  const int nch = pieces<T>(DP);
  const int ch = lane & (nch - 1);
  const int d0 = ch * E;
  const int keys = 32 / nch;  // keys a warp takes a step
  float acc[kMaxG][E];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  if (d0 < DP)
    for (int j = warp * keys + lane / nch; j < c.n; j += kWarps * keys) {
      float x[E];
      load_piece(vs + j * DP + d0, x);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float p = ps[g * kKeys + j];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
      }
    }
  for (int o = nch; o < 32; o <<= 1)  // the warp's key lanes
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  if (lane < nch && d0 < DP)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < E; ++e) red[(warp * G + g) * DP + d0 + e] = acc[g][e];
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += kThreads) {  // the warps in order
    const int g = e / D;
    const int d = e % D;
    float a = red[g * DP + d];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) a += red[(u * G + g) * DP + d];
    part[g * (D + 2) + d] = a;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    part[g * (D + 2) + D] = ms[g];
    part[g * (D + 2) + D + 1] = ls[g];
  }
}

// ---- (b) combine pass -----------------------------------------------------

// Thread groups of a combine block: the fewest (a power of two, <= 32)
// that leave each one round of kCombineRound partials.
__host__ __device__ __forceinline__ int combine_groups(int n_split) {
  int p = 1;
  while (p < 32 && p * kCombineRound < n_split) p <<= 1;
  return p;
}

// Fold partials t0 .. t1 - 1 of one output element in order into (mx, l,
// acc), kCombineRound a round of independent loads; pr is the element's
// row of partial 0 (m at pr[D], l at pr[D + 1]), stride floats a partial.
__device__ __forceinline__ void fold(const float* pr, int d, int D, int stride,
                                     int t0, int t1, float& mx, float& l,
                                     float& acc) {
  for (; t0 < t1; t0 += kCombineRound) {
    float m[kCombineRound], lt[kCombineRound], x[kCombineRound];
#pragma unroll
    for (int u = 0; u < kCombineRound; ++u) {
      const bool in = t0 + u < t1;
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
}

// Grid (ceil(G * D / EB), Hk, B): a block takes EB = kThreads / P output
// elements, and its P thread groups each fold a contiguous run of the
// partials; the groups' results are then merged in group order.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_apply_combine_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int G, int D, int n_split) {
  __shared__ float gm[kThreads], gl[kThreads], gacc[kThreads];
  const int groups = combine_groups(n_split);
  const int eb = kThreads / groups;
  const int el = threadIdx.x % eb;
  const int grp = threadIdx.x / eb;
  const int e = blockIdx.x * eb + el;
  const int run = (n_split + groups - 1) / groups;
  const size_t bh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int stride = G * (D + 2);  // floats of one split's partial
  pdl_wait();  // the split pass has finished and its partials are visible
  float mx = -INFINITY;
  float l = 0.f;
  float acc = 0.f;
  if (e < G * D)
    fold(ws + bh * n_split * stride + (e / D) * (D + 2), e % D, D, stride,
         min(n_split, grp * run), min(n_split, (grp + 1) * run), mx, l, acc);
  gm[threadIdx.x] = mx;
  gl[threadIdx.x] = l;
  gacc[threadIdx.x] = acc;
  __syncthreads();
  if (grp != 0 || e >= G * D) return;
  for (int u = 1; u < groups; ++u) mx = fmaxf(mx, gm[u * eb + el]);
  if (mx != -INFINITY) {
    l = 0.f;
    acc = 0.f;
    for (int u = 0; u < groups; ++u) {
      const float m = gm[u * eb + el];
      if (m == -INFINITY) continue;  // a group that saw nothing weighs 0
      const float a = exp2f(m - mx);
      acc = fmaf(a, gacc[u * eb + el], acc);
      l = fmaf(a, gl[u * eb + el], l);
    }
  }
  out[bh * G * D + e] = repro::from_float<T>(acc / (l == 0.f ? 1.f : l));
}

// ---- host side ------------------------------------------------------------

bool bad_shape(int B, int Hk, int G, int D, int page, int w, int dtype) {
  return B < 1 || Hk < 1 || G < 1 || G > kMaxG || D < 1 || D > kMaxD ||
         page < 1 || w < 1 || (dtype != REPRO_F32 && dtype != REPRO_BF16);
}

// q is null for the apply kernel, which reads none
Shape make_shape(const void* q, const void* pool, const void* scores, int G,
                 int D, int page, int w, long long s_page, long long s_row,
                 long long s_head, int dtype) {
  const long long es = dtype == REPRO_BF16 ? 2 : 4;
  const bool rows = (D * es) % 16 == 0;  // a row is whole 16-byte pieces
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return Shape{G, D, page, w, (page + kKeys - 1) / kKeys, s_page, s_row, s_head,
               rows && (s_page * es) % 16 == 0 && (s_row * es) % 16 == 0 &&
                   (s_head * es) % 16 == 0 && aligned(pool),
               page % 4 == 0 && aligned(scores), rows && aligned(q)};
}

// D rounded up to whole 16-byte pieces of es-byte elements
int padded_host(int D, int es) { return (D * es + 15) / 16 * 16 / es; }

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
int smem_attr(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T>
int launch_scores(const void* q, const void* k, const Sched& sc, float* out,
                  const Shape& sh, int B, int Hk, cudaStream_t st) {
  const size_t smem = scores_smem(padded_host(sh.D, sizeof(T)), sizeof(T));
  auto kernel = paged_scores_kernel<T>;
  const int rc = smem_attr(kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid(sh.w * sh.nc, Hk, B);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(q),
                                       static_cast<const T*>(k), sc, out, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const float* scores, const void* v, const Sched& sc, void* out,
                 float* ws, const Shape& sh, int B, int Hk, float scale_log2,
                 cudaStream_t st) {
  const int DP = padded_host(sh.D, sizeof(T));
  const size_t smem = apply_smem(sh.G, DP, sizeof(T));
  auto split = paged_apply_split_kernel<T>;
  int rc = smem_attr(split, smem);
  if (rc != 0) return rc;
  const dim3 grid(sh.w * sh.nc, Hk, B);
  split<<<grid, kThreads, smem, st>>>(scores, static_cast<const T*>(v), sc, ws,
                                      sh, scale_log2);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // the combine pass as a programmatic dependent launch of the split pass
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  const int eb = kThreads / combine_groups(sh.w * sh.nc);
  cfg.gridDim = dim3((sh.G * sh.D + eb - 1) / eb, Hk, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, paged_apply_combine_kernel<T>,
                                           static_cast<const float*>(ws),
                                           static_cast<T*>(out), sh.G, sh.D,
                                           sh.w * sh.nc));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hk, G, D) contiguous, D the shard's slice of the head dim; the
// key pool k (n_pages, page, Hk, D) through its element strides (last axis
// contiguous); phys, logical, keep (B, w) and pos (B,) int32; scores (B,
// Hk, G, w * page) fp32. G <= 8, D <= 128, any page and w; any alignment
// (16-byte pieces where the pool allows). Returns the first CUDA error.
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
  const Shape sh = make_shape(q, k, scores, G, D, page, w, s_page, s_row, s_head, dtype);
  float* out = static_cast<float*>(scores);
  return dtype == REPRO_BF16
             ? launch_scores<__nv_bfloat16>(q, k, sc, out, sh, B, Hk, st)
             : launch_scores<float>(q, k, sc, out, sh, B, Hk, st);
}

// scores (B, Hk, G, w * page) fp32, the shards' sum; the value pool v
// (n_pages, page, Hk, D) through its element strides; the schedule as
// above; out (B, Hk, G, D) contiguous, in the pool's dtype; ws an fp32
// workspace of B * Hk * w * ceil(page / 128) * G * (D + 2). Launches the
// split pass and the combine pass on `stream`; returns the first CUDA
// error.
extern "C" int paged_decode_apply_launch(
    const void* scores, const void* v, const void* phys, const void* logical,
    const void* keep, const void* pos, void* out, void* ws, int B, int Hk,
    int G, int D, int page, int w, long long s_page, long long s_row,
    long long s_head, float sm_scale, int dtype, void* stream) {
  if (bad_shape(B, Hk, G, D, page, w, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sched sc{static_cast<const int*>(phys), static_cast<const int*>(logical),
                 static_cast<const int*>(keep), static_cast<const int*>(pos)};
  const Shape sh = make_shape(nullptr, v, scores, G, D, page, w, s_page, s_row, s_head, dtype);
  const float* s = static_cast<const float*>(scores);
  float* wsf = static_cast<float*>(ws);
  const float scale_log2 = sm_scale * kLog2e;
  return dtype == REPRO_BF16
             ? launch_apply<__nv_bfloat16>(s, v, sc, out, wsf, sh, B, Hk, scale_log2, st)
             : launch_apply<float>(s, v, sc, out, wsf, sh, B, Hk, scale_log2, st);
}
