// Chunked gated-linear-attention scan for Hopper (sm_90a). It replaces the
// TPU kernel _ssd_kernel of repro/kernels/ssd_scan.py:44 (the chunk program
// of repro/models/ssm.py chunked_gla) and computes, for q, k [B, S, H, dk],
// v [B, S, H, dv] and the log decays g [B, S, H] (g <= 0),
//
//   h_t = exp(g_t) h_{t-1} + k_t (x) v_t,   y_t = q_t . h_t,
//
// from h_0 = h0 [B, H, dk, dv] (f32; a null pointer means zeros), returning
// y [B, S, H, dv] in v's type and h_final [B, H, dk, dv] in f32. Within a
// chunk c of C steps, with b_t the inclusive cumsum of g from the chunk start:
//
//   P_c[t, s] = (q_t . k_s) exp(b_t - b_s) for s <= t, else 0,
//   dS_c = sum_s exp(b_C - b_s) k_s (x) v_s,
//   h_c = exp(b_C) h_{c-1} + dS_c                       (h_in of chunk c + 1),
//   y_t = sum_s P_c[t, s] v_s + (q_t exp(b_t)) . h_{c-1}.
//
// Every operand is read as f32 (q, k, v each bf16 or f32, g f32) and every
// product and sum is f32, in one fixed order (no atomics), so runs repeat
// bit for bit. Any S: the last chunk's missing steps read g = 0 and
// q = k = v = 0, which leaves both y and the state unchanged, and their
// rows of y are not stored. q, k, v are read through their [B, S, H, d]
// strides (the last stride 1); g through its three strides.
//
// Bound: at the xLSTM serve prefill shape (B 1, S 1024, H 4, dk 512,
// chunk 128) the dv = 512 call needs 4.8 GFLOP of f32 products counting the
// causal half of each chunk's C x C scores: 72 us at the H100's 67 TFLOP/s
// f32 peak, against 25-29 MB of operands (7.5-8.8 us at 3.35 TB/s), so the
// work is bound by operations. The dv = 1 call (the mLSTM normaliser)
// needs 0.28 GFLOP (4.2 us) against 12.6 MB (3.8 us).
//
// Design: three launches, each product computed once, every independent
// (chunk, head, batch) in parallel; only the state pass walks the chunks in
// order.
//   1. ssd_scan_chunk_kernel, grid (tiles, chunks, B H): each block takes
//      the chunk's cumsum b (warp 0, a shuffle scan; block 0 stores it) and
//      then either one dk slice of 128 of a 64 x 64 tile of the lower
//      triangle of the scores P_c (its partial sum, decayed and masked), or
//      one 64 x BN tile of dS_c (depth C). The score tiles are a chunk's
//      only C x C x dk work: split over 3 tiles x 4 slices, they spread the
//      dv = 1 call over 384 blocks at the serve shape instead of the 4
//      heads.
//   2. ssd_scan_state_kernel, grid (dk dv / 1024, B H): a thread per 4
//      state elements walks the chunks (8 chunks' loads in flight),
//      overwrites dS_c with h_{c-1} (the state entering chunk c) and writes
//      h_final. It streams the 32 MB of states at the dv = 512 serve shape
//      through device memory twice and is bound by those bytes.
//   3. ssd_scan_out_kernel, grid (C / 64 x dv / BN, chunks, B H): each block
//      computes a 64 x BN tile of y as one product over the concatenated
//      depth [P_c | q exp(b)] . [v ; h_{c-1}], reading only P's causal
//      columns and summing its dk slices as it stages them. For dv <= 4
//      (the normaliser) ssd_scan_out_narrow_kernel takes a warp per step
//      instead, grid (C / 8, chunks, B H).
// Each tile product is an f32 register-tiled GEMM on the CUDA cores: 256
// threads, a 4 x BN/16 tile each, depth slices of 16 staged in shared
// memory (double-buffered, and loaded into registers two slices ahead of
// the one being multiplied), operands read 4 elements at a time (one 16- or
// 8-byte load where aligned), converted to f32 and masked as they are
// staged. BN is 128 when dv > 64, else 64. Scratch (allocated by the
// wrapper): P [B H, n, dk / 128, C, C], the states [B H, n, dk, dv] and b
// [B H, n, C], all f32; 8 MB, 32 MB and 16 KB at the dv = 512 serve shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;  // the cumsum's 4 steps a lane
constexpr int kBM = 64;         // rows of every tile
constexpr int kBK = 16;         // depth of one staged slice
constexpr int kPad = 4;         // keeps staged rows 16-byte aligned, spreads banks
constexpr int kScoreDepth = 128;  // dk per score block: the scores are split in depth
constexpr int kNarrow = 4;      // dv up to this takes the warp-per-step output pass

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* h0;  // null: zeros
  void* y;
  float* hT;
  float* scores;  // [B H, n, parts, C, C]: partial sums over dk slices
  float* states;  // [B H, n, dk, dv]
  float* bcum;    // [B H, n, C]
  int s, h, dk, dv, chunk, n_chunks, parts;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t g_sb, g_ss, g_sh;
  int q_bf16, k_bf16, v_bf16;  // y takes v's type
};

__device__ __forceinline__ float load(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Elements i .. i + 3 of p as f32, of which the first n exist (zeros for
// the rest): one 16-byte (f32) or 8-byte (bf16) load when all four exist
// and are aligned, else one load each.
__device__ __forceinline__ float4 load4(const void* p, int64_t i, int bf16, int n) {
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  if (bf16) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p) + i;
    if (n >= 4 && (reinterpret_cast<uintptr_t>(x) & 7) == 0) {
      const uint2 u = *reinterpret_cast<const uint2*>(x);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) r[e] = __bfloat162float(x[e]);
  } else {
    const float* x = static_cast<const float*>(p) + i;
    if (n >= 4 && (reinterpret_cast<uintptr_t>(x) & 15) == 0)
      return *reinterpret_cast<const float4*>(x);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) r[e] = x[e];
  }
  return make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ float4 scale4(float4 v, float w) {
  return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
}

__device__ __forceinline__ void store(void* p, int64_t i, float x, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// Elements i .. i + 3 of p, of which the first n exist, from v: one 16-byte
// (f32) or 8-byte (bf16) store when all four exist and are aligned.
__device__ __forceinline__ void store4(void* p, int64_t i, float4 v, int bf16, int n) {
  const float r[4] = {v.x, v.y, v.z, v.w};
  if (bf16) {
    __nv_bfloat16* x = static_cast<__nv_bfloat16*>(p) + i;
    if (n >= 4 && (reinterpret_cast<uintptr_t>(x) & 7) == 0) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(x) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                *reinterpret_cast<const uint32_t*>(&hi));
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) x[e] = __float2bfloat16(r[e]);
  } else {
    float* x = static_cast<float*>(p) + i;
    if (n >= 4 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
      *reinterpret_cast<float4*>(x) = v;
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) x[e] = r[e];
  }
}

int tile_n(int dv) { return dv > 64 ? 128 : 64; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The operand slices of a tile product, staged as f32 [kBK][rows + kPad],
// are read in groups of 4 elements along the operand's contiguous
// dimension. A K-contiguous operand (element (row, k) next to (row, k + 1))
// is read 4 threads to a row and stored transposed; a row-contiguous one
// is read along its rows, 4 rows a thread.
template <int ROWS, bool KCONTIG>
struct Slice {
  static constexpr int kPer = ROWS * kBK / 4 / kThreads;  // groups per thread
  __device__ static void at(int tid, int i, int& row, int& kk) {
    const int g = tid + kThreads * i;
    if (KCONTIG) {
      row = g / (kBK / 4);
      kk = (g % (kBK / 4)) * 4;
    } else {
      kk = g / (ROWS / 4);
      row = (g % (ROWS / 4)) * 4;
    }
  }
  template <int W>
  __device__ static void put(float (*sm)[W], int row, int kk, float4 v) {
    if (KCONTIG) {
      sm[kk][row] = v.x;
      sm[kk + 1][row] = v.y;
      sm[kk + 2][row] = v.z;
      sm[kk + 3][row] = v.w;
    } else {
      *reinterpret_cast<float4*>(&sm[kk][row]) = v;
    }
  }
};

struct Smem {
  float a[2][kBK][kBM + kPad];
  float b[2][kBK][128 + kPad];
};

// acc[i][j] += sum_{k < depth} A(ty 4 + i, k) B(k, col j), for this thread's
// rows ty 4 + i and columns 64 jh + tx 4 + jj (j = 4 jh + jj) of a 64 x BN
// tile. fa(row, k) and fb(k, col) return a group of 4 operand elements as
// f32 (zero outside the operand): along k from (row, k) when the operand
// is K-contiguous, else along its rows from (row, k) or columns from (k,
// col). Slices are loaded into registers two ahead of the one being
// multiplied, so each load has two slices' products to land. Ends with a
// __syncthreads.
template <int BN, bool A_KCONTIG, bool B_KCONTIG, class FA, class FB>
__device__ __forceinline__ void tile_product(float (&acc)[4][BN / 16], int depth, const FA& fa,
                                             const FB& fb, Smem& sm) {
  using SA = Slice<kBM, A_KCONTIG>;
  using SB = Slice<BN, B_KCONTIG>;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float4 ra0[SA::kPer], rb0[SB::kPer], ra1[SA::kPer], rb1[SB::kPer];
  auto fetch = [&](float4 (&ra)[SA::kPer], float4 (&rb)[SB::kPer], int k0) {
#pragma unroll
    for (int i = 0; i < SA::kPer; ++i) {
      int row, kk;
      SA::at(tid, i, row, kk);
      ra[i] = fa(row, k0 + kk);
    }
#pragma unroll
    for (int i = 0; i < SB::kPer; ++i) {
      int col, kk;
      SB::at(tid, i, col, kk);
      rb[i] = fb(k0 + kk, col);
    }
  };
  auto put = [&](const float4 (&ra)[SA::kPer], const float4 (&rb)[SB::kPer], int buf) {
#pragma unroll
    for (int i = 0; i < SA::kPer; ++i) {
      int row, kk;
      SA::at(tid, i, row, kk);
      SA::put(sm.a[buf], row, kk, ra[i]);
    }
#pragma unroll
    for (int i = 0; i < SB::kPer; ++i) {
      int col, kk;
      SB::at(tid, i, col, kk);
      SB::put(sm.b[buf], col, kk, rb[i]);
    }
  };
  auto multiply = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[buf][kk][ty * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      float br[BN / 16];
#pragma unroll
      for (int jh = 0; jh < BN / 64; ++jh) {
        const float4 bv = *reinterpret_cast<const float4*>(&sm.b[buf][kk][jh * 64 + tx * 4]);
        br[4 * jh] = bv.x;
        br[4 * jh + 1] = bv.y;
        br[4 * jh + 2] = bv.z;
        br[4 * jh + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  };
  const int n = (depth + kBK - 1) / kBK;
  fetch(ra0, rb0, 0);
  if (n > 1) fetch(ra1, rb1, kBK);
  put(ra0, rb0, 0);
  __syncthreads();
  // slice t is in shared buffer t % 2, slice t + 1 in registers (t + 1) % 2
  for (int t = 0; t < n; t += 2) {
    if (t + 2 < n) fetch(ra0, rb0, (t + 2) * kBK);
    multiply(0);
    if (t + 1 < n) put(ra1, rb1, 1);
    __syncthreads();
    if (t + 1 >= n) break;
    if (t + 3 < n) fetch(ra1, rb1, (t + 3) * kBK);
    multiply(1);
    if (t + 2 < n) put(ra0, rb0, 0);
    __syncthreads();
  }
}

// Column of the tile that acc[.][j] belongs to.
__device__ __forceinline__ int tile_col(int j) {
  return (j / 4) * 64 + (threadIdx.x % 16) * 4 + j % 4;
}

// b_t, the inclusive cumsum of g over the chunk's steps t < len (g = 0
// past them), into bc[0, C): warp 0, 4 steps a lane, then a scan of the
// lanes' sums. Ends with a __syncthreads.
__device__ __forceinline__ void chunk_cumsum(const Args& a, int64_t g_base, int t0, int len,
                                             float* bc) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float part[4];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * lane + i;
      run += t < len ? a.g[g_base + static_cast<int64_t>(t0 + t) * a.g_ss] : 0.f;
      part[i] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * lane + i < a.chunk) bc[4 * lane + i] = excl + part[i];
  }
  __syncthreads();
}

// Pass 1: one dk slice of a lower-triangle 64 x 64 tile of the chunk's
// scores, or a tile of its state contribution dS_c.
template <int BN>
__global__ void __launch_bounds__(kThreads) ssd_scan_chunk_kernel(Args a) {
  __shared__ __align__(16) Smem sm;
  __shared__ float bc_s[kMaxChunk];
  __shared__ float w_s[kMaxChunk];
  const int c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.h, head = bh % a.h;
  const int C = a.chunk, t0 = c * C, len = min(C, a.s - t0);
  const int64_t row_base = static_cast<int64_t>(bh) * a.n_chunks + c;  // (bh, c)
  chunk_cumsum(a, b * a.g_sb + head * a.g_sh, t0, len, bc_s);
  if (blockIdx.x == 0)
    for (int t = threadIdx.x; t < C; t += kThreads) a.bcum[row_base * C + t] = bc_s[t];

  const int64_t q_base = b * a.q_sb + head * a.q_sh + static_cast<int64_t>(t0) * a.q_ss;
  const int64_t k_base = b * a.k_sb + head * a.k_sh + static_cast<int64_t>(t0) * a.k_ss;
  const int64_t v_base = b * a.v_sb + head * a.v_sh + static_cast<int64_t>(t0) * a.v_ss;
  const int nt = cdiv(C, kBM);
  const int n_tri = nt * (nt + 1) / 2;
  const int n_score = n_tri * a.parts;
  const int ty = threadIdx.x / 16;

  if (static_cast<int>(blockIdx.x) < n_score) {  // scores: tile (ti, tj), tj <= ti
    const int part = blockIdx.x / n_tri;
    int ti = 0, u = blockIdx.x % n_tri;
    while (u > ti) u -= ++ti;
    const int m0 = ti * kBM, n0 = u * kBM;
    const int d0 = part * kScoreDepth, depth = min(a.dk - d0, kScoreDepth);
    auto fa = [&](int r, int kk) {  // q[t, d0 + kk ..], t = m0 + r
      const int t = m0 + r;
      return t < len ? load4(a.q, q_base + t * a.q_ss + d0 + kk, a.q_bf16, depth - kk)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto fb = [&](int kk, int col) {  // k[s, d0 + kk ..], s = n0 + col
      const int s = n0 + col;
      return s < len ? load4(a.k, k_base + s * a.k_ss + d0 + kk, a.k_bf16, depth - kk)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    float acc[4][4] = {};
    tile_product<64, true, true>(acc, depth, fa, fb, sm);
    float* out = a.scores + (row_base * a.parts + part) * C * C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = n0 + tile_col(j);
        if (t < C && s < C)
          out[t * C + s] = s <= t ? acc[i][j] * expf(bc_s[t] - bc_s[s]) : 0.f;
      }
    }
    return;
  }

  // state contribution: rows i0.. of dk, columns j0.. of dv, depth the C steps
  const int u = blockIdx.x - n_score;
  const int n_jt = cdiv(a.dv, BN);
  const int i0 = (u / n_jt) * kBM, j0 = (u % n_jt) * BN;
  const float b_end = bc_s[C - 1];  // the missing steps' g = 0 keep it the last step's
  for (int s = threadIdx.x; s < C; s += kThreads) w_s[s] = expf(b_end - bc_s[s]);
  __syncthreads();
  const int dk = a.dk, dv = a.dv;
  auto fa = [&](int r, int s) {  // k[s, i ..] exp(b_C - b_s), i = i0 + r
    const int i = i0 + r;
    return s < len ? scale4(load4(a.k, k_base + s * a.k_ss + i, a.k_bf16, dk - i), w_s[s])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto fb = [&](int s, int col) {  // v[s, j ..], j = j0 + col
    const int j = j0 + col;
    return s < len ? load4(a.v, v_base + s * a.v_ss + j, a.v_bf16, dv - j) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float acc[4][BN / 16] = {};
  tile_product<BN, false, false>(acc, C, fa, fb, sm);
  float* out = a.states + row_base * dk * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= dk) continue;
#pragma unroll
    for (int jh = 0; jh < BN / 64; ++jh) {
      const int col = j0 + tile_col(4 * jh);
      store4(out, static_cast<int64_t>(row) * dv + col,
             make_float4(acc[i][4 * jh], acc[i][4 * jh + 1], acc[i][4 * jh + 2],
                         acc[i][4 * jh + 3]),
             0, dv - col);
    }
  }
}

// Pass 2: h_c = exp(b_C) h_{c-1} + dS_c along the chunks, a thread per 4
// consecutive state elements; dS_c's slot takes h_{c-1}, the state entering
// chunk c. The slots are read kBatch chunks ahead of the stores, so each
// thread keeps that many loads in flight.
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kThreads) ssd_scan_state_kernel(Args a) {
  const int64_t per = static_cast<int64_t>(a.dk) * a.dv;
  const int64_t e = 4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  const int bh = blockIdx.y;
  if (e >= per) return;
  const int n = a.n_chunks, C = a.chunk;
  const int m = per - e < 4 ? static_cast<int>(per - e) : 4;  // elements of this thread
  const int64_t at = bh * per + e;
  float* slots = a.states + static_cast<int64_t>(bh) * n * per + e;
  const float* b_end = a.bcum + static_cast<int64_t>(bh) * n * C + C - 1;
  float4 hst = a.h0 != nullptr ? load4(a.h0, at, 0, m) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n; c0 += kBatch) {
    float4 ds[kBatch];
    float decay[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c0 + i;
      ds[i] = c < n ? load4(slots, c * per, 0, m) : make_float4(0.f, 0.f, 0.f, 0.f);
      decay[i] = c < n ? expf(b_end[static_cast<int64_t>(c) * C]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < n) {
        store4(slots, (c0 + i) * per, hst, 0, m);
        const float d = decay[i];
        hst = make_float4(d * hst.x + ds[i].x, d * hst.y + ds[i].y, d * hst.z + ds[i].z,
                          d * hst.w + ds[i].w);
      }
    }
  }
  store4(a.hT, at, hst, 0, m);
}

// P_c[t, s]: the sum of its dk slices' partial scores, in order.
__device__ __forceinline__ float score(const float* p, int parts, int stride, int at) {
  float sum = p[at];
  for (int i = 1; i < parts; ++i) sum += p[i * stride + at];
  return sum;
}

// Pass 3: a 64 x BN tile of y = [P_c | q exp(b)] . [v ; h_{c-1}].
template <int BN>
__global__ void __launch_bounds__(kThreads) ssd_scan_out_kernel(Args a) {
  __shared__ __align__(16) Smem sm;
  __shared__ float eb_s[kMaxChunk];
  const int c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.h, head = bh % a.h;
  const int C = a.chunk, t0 = c * C, len = min(C, a.s - t0);
  const int dk = a.dk, dv = a.dv;
  const int n_jt = cdiv(dv, BN);
  const int m0 = (blockIdx.x / n_jt) * kBM, j0 = (blockIdx.x % n_jt) * BN;
  const int64_t row_base = static_cast<int64_t>(bh) * a.n_chunks + c;
  for (int t = threadIdx.x; t < C; t += kThreads) eb_s[t] = expf(a.bcum[row_base * C + t]);
  __syncthreads();

  const int64_t q_base = b * a.q_sb + head * a.q_sh + static_cast<int64_t>(t0) * a.q_ss;
  const int64_t v_base = b * a.v_sb + head * a.v_sh + static_cast<int64_t>(t0) * a.v_ss;
  const float* p = a.scores + row_base * a.parts * C * C;
  const int parts = a.parts;
  const float* h_in = a.states + row_base * dk * dv;
  // the score columns these rows reach (s <= t < m0 + 64), in whole slices
  const int kp = (min(C, m0 + kBM) + kBK - 1) / kBK * kBK;
  auto fa = [&](int r, int kk) {  // P_c[t, kk ..] or q[t, i ..] exp(b_t)
    const int t = m0 + r;
    if (t >= len) return make_float4(0.f, 0.f, 0.f, 0.f);
    if (kk < kp) {  // the scores' causal columns s <= t
      float4 v = load4(p, t * C + kk, 0, t + 1 - kk);
      for (int i = 1; i < parts; ++i) {
        const float4 w = load4(p + static_cast<int64_t>(i) * C * C, t * C + kk, 0, t + 1 - kk);
        v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
      }
      return v;
    }
    const int i = kk - kp;
    return scale4(load4(a.q, q_base + t * a.q_ss + i, a.q_bf16, dk - i), eb_s[t]);
  };
  auto fb = [&](int kk, int col) {  // v[s, j ..] or h_in[i, j ..]
    const int j = j0 + col;
    if (kk < kp) return kk < len ? load4(a.v, v_base + kk * a.v_ss + j, a.v_bf16, dv - j) : make_float4(0.f, 0.f, 0.f, 0.f);
    const int i = kk - kp;
    return i < dk ? load4(h_in, static_cast<int64_t>(i) * dv + j, 0, dv - j) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float acc[4][BN / 16] = {};
  tile_product<BN, true, false>(acc, kp + dk, fa, fb, sm);
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + ty * 4 + i;
    if (t >= len) continue;
    const int64_t row = ((static_cast<int64_t>(b) * a.s + t0 + t) * a.h + head) * dv;
#pragma unroll
    for (int jh = 0; jh < BN / 64; ++jh) {
      const int col = j0 + tile_col(4 * jh);
      store4(a.y, row + col,
             make_float4(acc[i][4 * jh], acc[i][4 * jh + 1], acc[i][4 * jh + 2],
                         acc[i][4 * jh + 3]),
             a.v_bf16, dv - col);
    }
  }
}

// Pass 3 for dv <= kNarrow (the mLSTM normaliser's dv = 1): a warp per
// step t of a chunk computes y[t, :] = sum_{s <= t} P_c[t, s] v_s + (q_t
// exp(b_t)) . h_{c-1}, its lanes striding over s and over dk, then a
// butterfly sum over the warp (a fixed order).
__global__ void __launch_bounds__(kThreads) ssd_scan_out_narrow_kernel(Args a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.h, head = bh % a.h;
  const int C = a.chunk, t0 = c * C, len = min(C, a.s - t0);
  const int t = blockIdx.x * (kThreads / 32) + warp;
  if (t >= len) return;
  const int dk = a.dk, dv = a.dv;
  const int64_t row_base = static_cast<int64_t>(bh) * a.n_chunks + c;
  const float* p = a.scores + row_base * a.parts * C * C;
  const float* h_in = a.states + row_base * dk * dv;
  const int64_t q_row = b * a.q_sb + head * a.q_sh + static_cast<int64_t>(t0 + t) * a.q_ss;
  const int64_t v_base = b * a.v_sb + head * a.v_sh + static_cast<int64_t>(t0) * a.v_ss;
  const float eb = expf(a.bcum[row_base * C + t]);
  float acc[kNarrow];
#pragma unroll
  for (int j = 0; j < kNarrow; ++j) acc[j] = 0.f;
  for (int s = lane; s <= t; s += 32) {
    const float ps = score(p, a.parts, C * C, t * C + s);
#pragma unroll
    for (int j = 0; j < kNarrow; ++j)
      if (j < dv) acc[j] = fmaf(ps, load(a.v, v_base + s * a.v_ss + j, a.v_bf16), acc[j]);
  }
  for (int i = lane; i < dk; i += 32) {
    const float qi = load(a.q, q_row + i, a.q_bf16) * eb;
#pragma unroll
    for (int j = 0; j < kNarrow; ++j)
      if (j < dv) acc[j] = fmaf(qi, h_in[static_cast<int64_t>(i) * dv + j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kNarrow; ++j)
    for (int off = 16; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  if (lane < dv) {
    float out = acc[0];
#pragma unroll
    for (int j = 1; j < kNarrow; ++j)
      if (lane == j) out = acc[j];
    store(a.y, ((static_cast<int64_t>(b) * a.s + t0 + t) * a.h + head) * dv + lane, out,
          a.v_bf16);
  }
}

// The three grids ({x, y, z} each), the state tiles' width BN and the
// score depth slices, into out[0..10].
void plan(int b, int s, int h, int dk, int dv, int chunk, int* out) {
  const int n = cdiv(s, chunk), nt = cdiv(chunk, kBM), bn = tile_n(dv);
  const int parts = cdiv(dk, kScoreDepth);
  const int state_blocks =
      static_cast<int>((static_cast<int64_t>(dk) * dv + 4 * kThreads - 1) / (4 * kThreads));
  const int out_x = dv <= kNarrow ? cdiv(chunk, kThreads / 32) : nt * cdiv(dv, bn);
  const int grids[11] = {nt * (nt + 1) / 2 * parts + cdiv(dk, kBM) * cdiv(dv, bn), n, b * h,
                         state_blocks, b * h, 1,
                         out_x, n, b * h,
                         bn, parts};
  for (int i = 0; i < 11; ++i) out[i] = grids[i];
}

template <int BN>
cudaError_t launch(const Args& a, const int* g, cudaStream_t stream) {
  ssd_scan_chunk_kernel<BN><<<dim3(g[0], g[1], g[2]), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_state_kernel<<<dim3(g[3], g[4], g[5]), kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.dv <= kNarrow)
    ssd_scan_out_narrow_kernel<<<dim3(g[6], g[7], g[8]), kThreads, 0, stream>>>(a);
  else
    ssd_scan_out_kernel<BN><<<dim3(g[6], g[7], g[8]), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The launch plan at these sizes: out[0..8] the grids of the chunk, state and
// output passes ({x, y, z} each), out[9] the state tiles' width BN, out[10]
// the score depth slices. Returns 0, or cudaErrorInvalidValue for sizes the
// kernels do not take.
extern "C" int ssd_scan_plan(int b, int s, int h, int dk, int dv, int chunk, int* out) {
  if (b <= 0 || s <= 0 || h <= 0 || dk <= 0 || dv <= 0 || chunk < 8 || chunk > kMaxChunk ||
      chunk % 8 != 0 || static_cast<int64_t>(b) * h > 65535 || cdiv(s, chunk) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  plan(b, s, h, dk, dv, chunk, out);
  return 0;
}

// q, k, v, g on the current device, read through the given strides (in
// elements; the last dimension of q, k, v contiguous); h0 (or null), y, hT
// and the f32 scratch (scores [B H, n, parts, C, C], states [B H, n, dk,
// dv], bcum [B H, n, C]) contiguous. dtype codes: 0 = f32, 1 = bf16; y has v's.
// Launches the three passes in order on `stream`. Returns the first
// cudaError; shapes the kernels do not take are refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int ssd_scan_launch(const void* q, const void* k, const void* v, const float* g,
                               const float* h0, void* y, float* hT, float* scores,
                               float* states, float* bcum, int b, int s, int h, int dk, int dv,
                               int chunk, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                               int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                               int64_t v_ss, int64_t v_sh, int64_t g_sb, int64_t g_ss,
                               int64_t g_sh, int q_dtype, int k_dtype, int v_dtype,
                               void* stream) {
  int grids[11];
  if (ssd_scan_plan(b, s, h, dk, dv, chunk, grids) != 0 || q_dtype < 0 || q_dtype > 1 ||
      k_dtype < 0 || k_dtype > 1 || v_dtype < 0 || v_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,     k,      v,    g,    h0,   y,    hT,   scores, states, bcum,
         s,     h,      dk,   dv,   chunk, cdiv(s, chunk), grids[10],
         q_sb,  q_ss,   q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh,
         q_dtype, k_dtype, v_dtype};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(grids[9] == 128 ? launch<128>(a, grids, st)
                                           : launch<64>(a, grids, st));
}
