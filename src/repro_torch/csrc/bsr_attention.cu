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
// Layout: the TPU kernel took q, k, v as (batch * heads, S, D) with K/V
// repeated up to every query head. Here q is (B, S, H, D) and k, v are
// (B, S, Hk, D), the layout the projections produce, and query head h reads
// kv head h / G (G = H / Hk) directly: grouped-query attention without
// materialising the repeat.
//
// bf16: block_sparse_attention_tc_kernel, flash-attention-2 shaped, on
// mma.sync m16n8k16 (bf16 -> fp32). A thread block of 4 warps owns 64
// query rows of one (batch, kv head): 64 / G positions of all G query heads
// of that kv head (32 positions at G = 2), so each K/V tile is read once
// per group, not once per query head; a warp owns 16 rows of one head
// (G in {1, 2, 4}, so 64 / G positions fill whole warps).
// The block first lists its 64-key tiles: the scheduled blocks with
// valid == 1, cut at 64 keys, minus those wholly above the causal diagonal
// for all its rows; nothing else is read. The last query tiles, which see
// the most keys, are launched first. K and V tiles (16 KB each at
// D = 128) go through a two-stage cp.async ring in dynamic shared memory,
// rows padded by 16 bytes so ldmatrix is free of bank conflicts; the next
// tile's copy runs while the tensor cores work on this one. Q fragments
// stay in registers for the whole walk; K comes through ldmatrix, V through
// ldmatrix.trans. Row max and sum are fp32 registers, the max reduced over
// the 4 lanes that share an accumulator row. Unnormalised P is rounded to
// bf16 A-fragments in registers, the point where the TPU kernel casts
// p.astype(v.dtype), and the output is divided by l once at the end
// (l == 0 -> 1). The element mask is applied only on tiles that cross a
// warp's diagonal; a warp skips the products of a tile wholly above its 16
// rows. At D = 128: 221 registers and 87,040 bytes of shared memory, two
// blocks an SM (512 blocks at B = 1, S = 2048, Hk = 8). Blocks of 8 warps
// (128 rows, one an SM) were slower on the H100 at that shape, with two
// stages or three; so were 32 rows a warp (two m16 tiles sharing each K/V
// fragment), which need more than 255 registers and spill.
// mma.sync and not wgmma: a 16-row warp tile keeps the online softmax in
// the registers that hold the scores, and the gathered 64-key tiles are
// short; wgmma + TMA with warp specialisation is later work.
//
// fp32: block_sparse_attention_kernel, plain fp32 FMAs (no TF32):
// a thread block takes 16 query rows of one (batch, head) and walks the
// schedule of its query block, staging 32 keys of K and V at a time in
// shared memory. Each query row is owned by 8 neighbouring lanes: each
// scores 4 keys, the 8 lanes reduce the row's max and sum with shuffles,
// and each accumulates D / 8 output dimensions. Sub-tiles that lie wholly
// above the causal diagonal are skipped.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- fp32: SIMT kernel --------------------------------------------------

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
void launch_simt(const T* q, const T* k, const T* v, const int* kv_index,
                 const int* valid, T* out, int B, int S, int H, int Hk,
                 int nkv, int block, int causal, float sm_scale,
                 cudaStream_t stream) {
  dim3 grid(S / kRows, B * H);
  block_sparse_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      q, k, v, kv_index, valid, out, S, H, Hk, nkv, block, causal, sm_scale);
}

// ---- bf16: tensor cores -------------------------------------------------

constexpr int kTcKeys = 64;    // keys of one K/V tile
constexpr int kTcStages = 2;   // K/V tiles in the shared-memory ring
constexpr int kPad = 8;        // bf16 of padding at the end of a shared row

constexpr int kTcWarps = 4;

template <int D>
struct AttnTile {
  static constexpr int kRows = kTcWarps * 16;  // query rows (positions x heads)
  static constexpr int kRow = D + kPad;   // bf16 per shared row
  static constexpr int kQ = kRows * kRow;
  static constexpr int kKV = kTcKeys * kRow;
  static constexpr int kBytes =
      (kQ + 2 * kTcStages * kKV) * static_cast<int>(sizeof(bf16));
};

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32, 2)
    block_sparse_attention_tc_kernel(const bf16* __restrict__ q,
                                     const bf16* __restrict__ k,
                                     const bf16* __restrict__ v,
                                     const int* __restrict__ kv_index,
                                     const int* __restrict__ valid,
                                     bf16* __restrict__ out, int S, int H,
                                     int Hk, int nkv, int block, int causal,
                                     float scale_log2) {
  using Tl = AttnTile<D>;
  constexpr int kThr = kTcWarps * 32;
  constexpr int kDT = D / 8;          // n8 tiles over the head dim
  constexpr int kKT = D / 16;         // k16 steps over the head dim
  constexpr int kNT = kTcKeys / 8;    // n8 tiles over a key tile
  constexpr int kChunks = kTcKeys * D / 8;  // 16-byte chunks of a K tile
  static_assert(kChunks % kThr == 0, "every thread copies as many chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Tl::kQ;                 // [stage][key][kRow]
  bf16* vs = ks + kTcStages * Tl::kKV;
  int* sched = reinterpret_cast<int*>(vs + kTcStages * Tl::kKV);  // [nkv]
  int* tiles = sched + nkv;  // [nkv * block / 64]
  __shared__ int n_tiles;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = H / Hk;
  const int Pq = Tl::kRows / G;  // positions of this block
  const int b = blockIdx.y / Hk;
  const int hk = blockIdx.y % Hk;
  // the last query tiles see the most keys: they are launched first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * Pq;
  const int qb = q0 / block;

  // the block's key tiles, in schedule order: the schedule row is read in
  // parallel (first key of a slot, or -1), then listed by one thread
  for (int t = tid; t < nkv; t += kThr)
    sched[t] = valid[qb * nkv + t] ? kv_index[qb * nkv + t] * block : -1;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < nkv; ++t) {
      const int kb0 = sched[t];
      if (kb0 < 0) continue;
      for (int s0 = 0; s0 < block; s0 += kTcKeys)
        if (!causal || kb0 + s0 <= q0 + Pq - 1) tiles[n++] = kb0 + s0;
    }
    n_tiles = n;
  }
  // Q: row r is head r / Pq of the group at position q0 + r % Pq
  for (int e = tid; e < Tl::kRows * (D / 8); e += kThr) {
    const int row = e / (D / 8);
    const int ch = e % (D / 8);
    const int pos = q0 + row % Pq;
    repro::cp_async16(
        qs + row * Tl::kRow + ch * 8,
        q + (static_cast<size_t>(b * S + pos) * H + hk * G + row / Pq) * D +
            ch * 8);
  }
  repro::cp_async_commit();
  __syncthreads();  // the tile list is visible
  const int n_total = n_tiles;

  auto load_kv = [&](int j) {
    const int k0 = tiles[j];
    bf16* kd = ks + (j % kTcStages) * Tl::kKV;
    bf16* vd = vs + (j % kTcStages) * Tl::kKV;
#pragma unroll
    for (int u = 0; u < kChunks / kThr; ++u) {
      const int e = tid + u * kThr;
      const int key = e / (D / 8);
      const int ch = e % (D / 8);
      const size_t off =
          (static_cast<size_t>(b * S + k0 + key) * Hk + hk) * D + ch * 8;
      repro::cp_async16(kd + key * Tl::kRow + ch * 8, k + off);
      repro::cp_async16(vd + key * Tl::kRow + ch * 8, v + off);
    }
  };
  // prologue: tiles 0 .. kTcStages-2 in flight, one group each
#pragma unroll
  for (int j = 0; j < kTcStages - 1; ++j) {
    if (j < n_total) load_kv(j);
    repro::cp_async_commit();
  }

  // this warp's 16 rows: one head, positions p0 .. p0+15
  const int r0 = warp * 16;
  const int gh = r0 / Pq;
  const int p0 = q0 + r0 % Pq;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int pos_lo = p0 + g;  // rows of accumulator elements 0,1 and 2,3
  const int pos_hi = p0 + g + 8;

  repro::cp_async_wait<kTcStages - 1>();  // Q has landed (tiles may not)
  __syncthreads();
  unsigned qf[kKT][4];
#pragma unroll
  for (int kt = 0; kt < kKT; ++kt)
    repro::ldmatrix_x4(
        qf[kt], qs + (r0 + (lane & 15)) * Tl::kRow + kt * 16 + (lane >> 4) * 8);

  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 units
  float l_lo = 0.f, l_hi = 0.f;  // this lane's share of the running sum

  for (int j = 0; j < n_total; ++j) {
    repro::cp_async_wait<kTcStages - 2>();  // tile j has landed
    // every thread's copies of tile j are visible, and every warp is done
    // with tile j - 1, whose stage the next load reuses
    __syncthreads();
    if (j + kTcStages - 1 < n_total) load_kv(j + kTcStages - 1);
    repro::cp_async_commit();
    const int k0 = tiles[j];
    // warp-uniform: some key of the tile is visible to some row of the warp
    if (!causal || k0 <= p0 + 15) {
      const bf16* kt_s = ks + (j % kTcStages) * Tl::kKV;
      const bf16* vt_s = vs + (j % kTcStages) * Tl::kKV;
      float s[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          unsigned bb[4];
          repro::ldmatrix_x4(
              bb, kt_s + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * Tl::kRow +
                      kt * 16 + ((lane >> 3) & 1) * 8);
          repro::mma_bf16_16816(s[2 * np], qf[kt], bb[0], bb[1]);
          repro::mma_bf16_16816(s[2 * np + 1], qf[kt], bb[2], bb[3]);
        }
      }
      // scale to log2 units, mask, and the rows' new max
      const bool masked = causal && k0 + kTcKeys - 1 > p0;
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nt * 8 + c2 + e;
          float lo = s[nt][e] * scale_log2;
          float hi = s[nt][2 + e] * scale_log2;
          if (masked && key > pos_lo) lo = -INFINITY;
          if (masked && key > pos_hi) hi = -INFINITY;
          s[nt][e] = lo;
          s[nt][2 + e] = hi;
          mx_lo = fmaxf(mx_lo, lo);
          mx_hi = fmaxf(mx_hi, hi);
        }
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o_));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o_));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo);
      const float mn_hi = fmaxf(m_hi, mx_hi);
      // a row with nothing visible yet subtracts 0: its p and alpha are 0
      const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float al_lo = exp2f(m_lo - mu_lo);
      const float al_hi = exp2f(m_hi - mu_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      // unnormalised p: summed in fp32, rounded to bf16 for P @ V
      unsigned pf[kNT / 2][4];
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float p0_ = exp2f(s[nt][0] - mu_lo);
        const float p1_ = exp2f(s[nt][1] - mu_lo);
        const float p2_ = exp2f(s[nt][2] - mu_hi);
        const float p3_ = exp2f(s[nt][3] - mu_hi);
        rs_lo += p0_ + p1_;
        rs_hi += p2_ + p3_;
        pf[nt / 2][(nt % 2) * 2] = repro::pack_bf16(p0_, p1_);
        pf[nt / 2][(nt % 2) * 2 + 1] = repro::pack_bf16(p2_, p3_);
      }
      l_lo = l_lo * al_lo + rs_lo;
      l_hi = l_hi * al_hi + rs_hi;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][0] *= al_lo;
        o[dt][1] *= al_lo;
        o[dt][2] *= al_hi;
        o[dt][3] *= al_hi;
      }
#pragma unroll
      for (int kc = 0; kc < kNT / 2; ++kc) {
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          unsigned bb[4];
          repro::ldmatrix_x4_trans(
              bb, vt_s + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                             Tl::kRow +
                      dp * 16 + (lane >> 4) * 8);
          repro::mma_bf16_16816(o[2 * dp], pf[kc], bb[0], bb[1]);
          repro::mma_bf16_16816(o[2 * dp + 1], pf[kc], bb[2], bb[3]);
        }
      }
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o_);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o_);
  }
  const float inv_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo);
  const float inv_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
  const int h = hk * G + gh;
  bf16* o_lo = out + (static_cast<size_t>(b * S + pos_lo) * H + h) * D + c2;
  bf16* o_hi = out + (static_cast<size_t>(b * S + pos_hi) * H + h) * D + c2;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    *reinterpret_cast<unsigned*>(o_lo + dt * 8) =
        repro::pack_bf16(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    *reinterpret_cast<unsigned*>(o_hi + dt * 8) =
        repro::pack_bf16(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const int* kv_index, const int* valid, bf16* out, int B, int S,
                int H, int Hk, int nkv, int block, int causal, float sm_scale,
                cudaStream_t stream) {
  const int smem =
      AttnTile<D>::kBytes +
      nkv * (1 + block / kTcKeys) * static_cast<int>(sizeof(int));
  auto kernel = block_sparse_attention_tc_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pq = AttnTile<D>::kRows / (H / Hk);
  const float log2e = 1.4426950408889634f;
  kernel<<<dim3(S / pq, B * Hk), kTcWarps * 32, smem, stream>>>(
      q, k, v, kv_index, valid, out, S, H, Hk, nkv, block, causal,
      sm_scale * log2e);
  return 0;
}

}  // namespace

// q, out (B, S, H, D); k, v (B, S, Hk, D); all contiguous, one dtype.
// kv_index, valid (S / block, nkv) int32. D in {64, 128}; S a multiple of
// block; H a multiple of Hk. fp32: block a multiple of 32. bf16: block a
// multiple of 64, G = H / Hk in {1, 2, 4}, pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int block_sparse_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_index,
    const void* valid, void* out, int B, int S, int H, int Hk, int D, int nkv,
    int block, int causal, float sm_scale, int dtype, void* stream) {
  if (block % kKeys != 0 || S % block != 0 || H % Hk != 0 ||
      (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* it = static_cast<const int*>(kv_index);
  const int* vv = static_cast<const int*>(valid);
  int rc = 0;
  if (dtype == REPRO_F32) {
    const float* qt = static_cast<const float*>(q);
    const float* kt = static_cast<const float*>(k);
    const float* vt = static_cast<const float*>(v);
    float* ot = static_cast<float*>(out);
    if (D == 64)
      launch_simt<float, 64>(qt, kt, vt, it, vv, ot, B, S, H, Hk, nkv, block,
                             causal, sm_scale, s);
    else
      launch_simt<float, 128>(qt, kt, vt, it, vv, ot, B, S, H, Hk, nkv, block,
                              causal, sm_scale, s);
  } else if (dtype == REPRO_BF16) {
    const int G = H / Hk;
    if (block % kTcKeys != 0 || (G != 1 && G != 2 && G != 4))
      return static_cast<int>(cudaErrorInvalidValue);
    const bf16* qt = static_cast<const bf16*>(q);
    const bf16* kt = static_cast<const bf16*>(k);
    const bf16* vt = static_cast<const bf16*>(v);
    bf16* ot = static_cast<bf16*>(out);
    rc = D == 64 ? launch_bf16<64>(qt, kt, vt, it, vv, ot, B, S, H, Hk, nkv,
                                   block, causal, sm_scale, s)
                 : launch_bf16<128>(qt, kt, vt, it, vv, ot, B, S, H, Hk, nkv,
                                    block, causal, sm_scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
