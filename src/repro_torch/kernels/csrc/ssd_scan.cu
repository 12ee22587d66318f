// Chunked gated-linear-attention scan for Hopper (sm_90a). It replaces the
// TPU kernel _ssd_kernel of repro/kernels/ssd_scan.py (the chunk program of
// repro/models/ssm.py chunked_gla) and computes, for q, k [B, S, H, dk],
// v [B, S, H, dv] and the log decays g [B, S, H] (g <= 0),
//
//   h_t = exp(g_t) h_{t-1} + k_t (x) v_t,   y_t = q_t . h_t,
//
// from h_0 = h0 [B, H, dk, dv] (f32; a null pointer means zeros), returning
// y [B, S, H, dv] in v's type and h_final [B, H, dk, dv] in f32. Within a
// chunk of C steps, with b_t the inclusive cumsum of g from the chunk start:
//
//   y_t = sum_{s<=t} exp(b_t - b_s) (q_t . k_s) v_s + exp(b_t) q_t . h_in,
//   h_out = exp(b_C) h_in + sum_s exp(b_C - b_s) k_s (x) v_s.
//
// Every operand is read as f32 (q, k, v each bf16 or f32, g f32) and every
// product and sum is f32, in one fixed order (no atomics), so runs repeat
// bit for bit. Any S: the last chunk's missing steps read g = 0 and
// q = k = v = 0, which leaves both y and the state unchanged, and their
// rows of y are not stored. q, k, v are read through their [B, S, H, d]
// strides (the last stride 1); g through its three strides.
//
// Bound: at the xLSTM serve prefill shape (B 1, S 1024, H 4, dk 512,
// chunk 128) the dv = 512 launch needs 4.8 GFLOP of f32 products counting
// the causal half of each chunk's C x C scores (5.37 GFLOP with the full
// square, which this kernel computes): 72-80 us at the H100's 67 TFLOP/s
// f32 peak, against 25-29 MB of operands (7.5-8.8 us at 3.35 TB/s), so the
// work is bound by operations. The dv = 1 launch (the mLSTM normaliser)
// needs 0.28 GFLOP (4.2 us) against 12.6 MB (3.8 us). This first kernel
// does its products as f32 FMAs on the CUDA cores out of shared memory;
// tensor cores (wgmma, TMA) are later work.
//
// Shared memory: at dk = dv = 512 the state is 1 MiB per (b, h) and a
// chunk's q or k tile 256 KiB in f32, both above a block's 227 KB. So the
// state's dv columns are split across blocks: column j of h evolves only
// with column j of v, so one block per (32 state columns, head, batch)
// carries its dk x 32 slice of h (64 KB at dk 512) in shared memory and
// walks the chunks in order. dk is streamed in sub-tiles of 32 rows, q and k
// staged transposed as f32 ([d][t], rows padded to C + 4 floats so each
// thread reads its rows as float4s); each thread loads its share of the next
// sub-tile into registers while the current one is computed. Per sub-tile a
// thread adds to its 8 x 8 tile of the C x C scores; each warp owns 4 state
// columns and adds to its lanes' 4 x 4 tiles of q . h_in (the state rows of
// the sub-tile), then, once every thread has read them, updates those state
// rows with the sub-tile's k and the chunk's v (a warp whose columns lie
// past dv skips both). After the last sub-tile the decayed, causally masked
// scores go to shared memory (transposed) for the intra-chunk product with
// v. Each block recomputes the chunk's scores for its own columns: redundant
// work (16 times at dv 512) that keeps the kernel one pass; the grid is
// ceil(dv / 32) x H x B blocks of 256 threads, so the dv = 1 launch runs on
// B x H SMs and is bound by one block's instruction rate on the scores.
// Shared memory: 4 * (32 dk + C (C + 4) + 64 (C + 4) + 35 C) bytes, 184.8 KB
// at dk 512 and C 128, above the 48 KB default, so each launch opts in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;  // the scores' 16 x 16 grid of 8 x 8 thread tiles
constexpr int kMaxDk = 512;     // the state slice dk x 32 fits shared memory
constexpr int kKT = 32;         // dk rows per sub-tile, one per lane when staging
constexpr int kDVT = 32;        // state columns per block
constexpr size_t kMaxSmem = 232448;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kMaxChunk / kWarps;  // chunk steps each warp stages

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* h0;  // null: zeros
  void* y;
  float* hT;
  int s, h, dk, dv, chunk;
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

__device__ __forceinline__ void store(void* p, int64_t i, float x, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// One sub-tile's q and k values for this thread (steps warp, warp + 8, ...;
// dimension k0 + lane), zeros past the chunk's steps or dk. Loaded into
// registers one sub-tile ahead, so their latency overlaps the products.
__device__ __forceinline__ void fetch(const Args& a, int64_t q_base, int64_t k_base, int t0,
                                      int len, int k0, int warp, int lane,
                                      float (&qn)[kRowsPerWarp], float (&kn)[kRowsPerWarp]) {
  const int d = k0 + lane;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    qn[i] = 0.f;
    kn[i] = 0.f;
    if (r < len && d < a.dk) {
      qn[i] = load(a.q, q_base + static_cast<int64_t>(t0 + r) * a.q_ss + d, a.q_bf16);
      kn[i] = load(a.k, k_base + static_cast<int64_t>(t0 + r) * a.k_ss + d, a.k_bf16);
    }
  }
}

size_t smem_floats(int dk, int chunk) {
  const size_t cp = chunk + 4;
  return static_cast<size_t>(dk) * kDVT + chunk * cp + 2 * kKT * cp +
         static_cast<size_t>(chunk) * kDVT + 3 * static_cast<size_t>(chunk);
}

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int C = a.chunk, cp = C + 4, dk = a.dk, dv = a.dv;
  float* h_s = smem;               // [dk][kDVT]  the state slice
  float* p_s = h_s + dk * kDVT;    // [C][cp]     decayed scores, [s][t]
  float* qt_s = p_s + C * cp;      // [kKT][cp]   q sub-tile, [d][t]
  float* kt_s = qt_s + kKT * cp;   // [kKT][cp]   k sub-tile, [d][t]
  float* v_s = kt_s + kKT * cp;    // [C][kDVT]   the chunk's v columns
  float* bc_s = v_s + C * kDVT;    // [C]         b_t
  float* w_s = bc_s + C;           // [C]         exp(b_C - b_t)
  float* eb_s = w_s + C;           // [C]         exp(b_t)

  const int j0 = blockIdx.x * kDVT;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int64_t q_base = b * a.q_sb + head * a.q_sh;
  const int64_t k_base = b * a.k_sb + head * a.k_sh;
  const int64_t v_base = b * a.v_sb + head * a.v_sh;
  const int64_t g_base = b * a.g_sb + head * a.g_sh;
  const int64_t st_base = (static_cast<int64_t>(b) * a.h + head) * dk * dv;

  for (int r = warp; r < dk; r += kWarps) {
    const int j = j0 + lane;
    h_s[r * kDVT + lane] =
        (a.h0 != nullptr && j < dv) ? a.h0[st_base + static_cast<int64_t>(r) * dv + j] : 0.f;
  }

  // scores: rows 8 ty.., columns 8 tx..; a warp per 4 state columns yc..:
  // outputs at rows yr.., the state update at row hr of the sub-tile
  const int ty = tid >> 4, tx = tid & 15;
  const bool p_on = 8 * ty < C && 8 * tx < C;
  const int yc = 4 * warp, yr = 4 * lane, hr = lane;
  const bool col_on = j0 + yc < dv;  // warp-uniform: columns past dv skip

  const int n_chunks = (a.s + C - 1) / C;
  float qn[kRowsPerWarp], kn[kRowsPerWarp];
  fetch(a, q_base, k_base, 0, min(C, a.s), 0, warp, lane, qn, kn);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * C;
    const int len = min(C, a.s - t0);
    __syncthreads();  // the previous chunk's readers of p_s, v_s, bc_s are done

    if (warp == 0) {  // b_t: 4 steps a lane, then a scan of the lanes' sums
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
        if (4 * lane + i < C) bc_s[4 * lane + i] = excl + part[i];
    }
    {
      float vn[kRowsPerWarp];
      const int j = j0 + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + i * kWarps;
        vn[i] = (r < len && j < dv)
                    ? load(a.v, v_base + static_cast<int64_t>(t0 + r) * a.v_ss + j, a.v_bf16)
                    : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        if (warp + i * kWarps < C) v_s[(warp + i * kWarps) * kDVT + lane] = vn[i];
    }
    __syncthreads();
    const float b_end = bc_s[C - 1];  // the missing steps' g = 0 keep it the last step's
    const float d_end = expf(b_end);
    for (int t = tid; t < C; t += kThreads) {
      w_s[t] = expf(b_end - bc_s[t]);
      eb_s[t] = expf(bc_s[t]);
    }

    float acc[8][8];
    float yin[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yin[i][j] = 0.f;

    for (int k0 = 0; k0 < dk; k0 += kKT) {
      const int rows = min(kKT, dk - k0);
      __syncthreads();  // qt_s, kt_s are free; at k0 == 0, w_s and eb_s are written
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {  // steps per warp, a d per lane
        const int r = warp + i * kWarps;
        if (r < C) {
          qt_s[lane * cp + r] = qn[i];
          kt_s[lane * cp + r] = kn[i];
        }
      }
      if (k0 + kKT < dk)
        fetch(a, q_base, k_base, t0, len, k0 + kKT, warp, lane, qn, kn);
      else if (ci + 1 < n_chunks)
        fetch(a, q_base, k_base, t0 + C, min(C, a.s - t0 - C), 0, warp, lane, qn, kn);
      __syncthreads();

      if (p_on) {  // scores += q_sub . k_sub^T
#pragma unroll 4
        for (int d = 0; d < kKT; ++d) {
          const float4 qa = *reinterpret_cast<const float4*>(qt_s + d * cp + 8 * ty);
          const float4 qb = *reinterpret_cast<const float4*>(qt_s + d * cp + 8 * ty + 4);
          const float4 ka = *reinterpret_cast<const float4*>(kt_s + d * cp + 8 * tx);
          const float4 kb = *reinterpret_cast<const float4*>(kt_s + d * cp + 8 * tx + 4);
          const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
          const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
        }
      }
      if (col_on && yr < C) {  // q . h_in over the sub-tile's state rows
#pragma unroll 4
        for (int d = 0; d < rows; ++d) {
          const float4 qv = *reinterpret_cast<const float4*>(qt_s + d * cp + yr);
          const float4 hv = *reinterpret_cast<const float4*>(h_s + (k0 + d) * kDVT + yc);
          const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
          const float ha[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) yin[i][j] = fmaf(qa[i], ha[j], yin[i][j]);
        }
      }
      __syncthreads();  // every read of the sub-tile's old state rows is done
      if (col_on && hr < rows) {  // h = exp(b_C) h + sum_s exp(b_C - b_s) k_s v_s
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int s = 0; s < len; ++s) {
          const float kw = kt_s[hr * cp + s] * w_s[s];
          const float4 vv = *reinterpret_cast<const float4*>(v_s + s * kDVT + yc);
          sum.x = fmaf(kw, vv.x, sum.x);
          sum.y = fmaf(kw, vv.y, sum.y);
          sum.z = fmaf(kw, vv.z, sum.z);
          sum.w = fmaf(kw, vv.w, sum.w);
        }
        float4* hp = reinterpret_cast<float4*>(h_s + (k0 + hr) * kDVT + yc);
        const float4 ho = *hp;
        *hp = make_float4(fmaf(d_end, ho.x, sum.x), fmaf(d_end, ho.y, sum.y),
                          fmaf(d_end, ho.z, sum.z), fmaf(d_end, ho.w, sum.w));
      }
    }

    if (p_on) {  // decayed, causally masked scores, transposed
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * ty + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = 8 * tx + j;
          p_s[s * cp + t] = s <= t ? acc[i][j] * expf(bc_s[t] - bc_s[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    if (col_on && yr < C) {  // y = scores . v + exp(b_t) q . h_in
      float out[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
      const int s_end = min(yr + 4, len);
      for (int s = 0; s < s_end; ++s) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + s * cp + yr);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + s * kDVT + yc);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) out[i][j] = fmaf(pa[i], va[j], out[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = yr + i;
        if (t >= len) continue;
        const float et = eb_s[t];
        const int64_t row =
            ((static_cast<int64_t>(b) * a.s + t0 + t) * a.h + head) * dv;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + yc + j;
          if (col < dv) store(a.y, row + col, fmaf(et, yin[i][j], out[i][j]), a.v_bf16);
        }
      }
    }
  }

  __syncthreads();  // the last sub-tiles' state rows are written
  for (int r = warp; r < dk; r += kWarps) {
    const int j = j0 + lane;
    if (j < dv) a.hT[st_base + static_cast<int64_t>(r) * dv + j] = h_s[r * kDVT + lane];
  }
}

}  // namespace

// The dynamic shared memory one block takes at `dk` and `chunk`.
extern "C" int ssd_scan_smem_bytes(int dk, int chunk) {
  return static_cast<int>(sizeof(float) * smem_floats(dk, chunk));
}

// q, k, v, g on the current device, read through the given strides (in
// elements; the last dimension of q, k, v contiguous); h0 (or null), y and
// hT contiguous. dtype codes: 0 = f32, 1 = bf16; y has v's. Returns the
// cudaError of the launch; shapes the kernel does not take are refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int ssd_scan_launch(const void* q, const void* k, const void* v, const float* g,
                               const float* h0, void* y, float* hT, int b, int s, int h,
                               int dk, int dv, int chunk, int64_t q_sb, int64_t q_ss,
                               int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                               int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t g_sb,
                               int64_t g_ss, int64_t g_sh, int q_dtype, int k_dtype,
                               int v_dtype, void* stream) {
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || h > 65535 || dk <= 0 || dk > kMaxDk ||
      dv <= 0 || chunk < 8 || chunk > kMaxChunk || chunk % 8 != 0 || q_dtype < 0 ||
      q_dtype > 1 || k_dtype < 0 || k_dtype > 1 || v_dtype < 0 || v_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(dk, chunk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{q,    k,    v,    g,    h0,   y,    hT,   s,    h,    dk,    dv,      chunk,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh,
         q_dtype, k_dtype, v_dtype};
  const dim3 grid((dv + kDVT - 1) / kDVT, h, b);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
