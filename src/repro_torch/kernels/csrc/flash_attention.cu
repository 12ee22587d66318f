// Flash attention forward for Hopper (sm_90a): causal GQA attention with an
// online softmax. It replaces the TPU kernel _flash_kernel of
// repro/kernels/flash_attention.py:45 and computes, for q [B, Sq, H, hd] and
// k, v [B, Sk, KH, hd] (query head h reads KV head h / (H / KH)),
//
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / KH)],
//   s_ij = scale * q[b, i, h] . k[b, j, h / (H / KH)],
//
// with s_ij = -1e30 where j >= Sk or, when causal, j > i (the top-left mask:
// both positions counted from 0, for any Sq and Sk). The running max m, sum
// l and the accumulator live in f32; the output is acc / max(l, 1e-30) cast
// to the input type. Two kernels compute it; the wrapper's static table
// (kernels/flash_attention.py, VARIANTS) picks one by (dtype, hd):
//
// flash_attention_wgmma_kernel: bf16 at hd 64 and 128 (the serve path's
// prefill is bf16, hd 128). Bound: at that prefill (B 1, Sq = Sk = 1024,
// H 16, KH 8, hd 128) the causal products are 4.3 GFLOP against 12.6 MB of
// q + k + v + o, so the H100's bf16 tensor-core peak bounds the work (4.35
// us), and the card reaches that peak only through wgmma. Design: one
// warpgroup (128 threads) per (64 query rows, head, batch); the grid puts
// heads first and the longest causal q tiles first, 256 blocks at the serve
// shape, two resident per SM. The Q tile is loaded once and K/V tiles of 64
// keys stream through a 2-stage ring, all by cp.async (16 bytes a thread,
// issued by the warpgroup itself, zero-filled past Sq or Sk) into the
// 128-byte-swizzled layout wgmma reads: each tile is hd / 64 slabs of
// [64 rows][64 columns], a row 128 bytes, its 16-byte chunks XORed with the
// row's index mod 8. S = Q K^T is 4 or 8 wgmma m64n64k16 (both operands
// K-major in shared memory); the softmax runs on the f32 accumulator
// fragment (a thread holds two rows, whose max and sum are shuffles within
// its quad), masking only diagonal and tail tiles; tiles wholly above the
// diagonal are never loaded. P is cast to bf16 in registers, where the
// accumulator's layout is wgmma's A-operand layout, and O += P V is 4
// wgmma m64n{hd}k16 with V read transposed (MN-major) from the same ring.
// The f32 O accumulator stays in registers; the epilogue divides by l and
// stores bf16 rows below Sq. Shared memory: 5 tiles of 64 x hd bf16 plus
// 1 KB of alignment (81 KB at hd 128), opted into at launch.
//
// flash_attention_kernel (SIMT): f32 at every head dim, and bf16 at head
// dims the wgmma kernel does not take (16..256 in multiples of 16). f32 stays
// here because TF32 tensor cores would not hold f32's 2e-5. It does its
// products in f32 FMAs on the CUDA cores, out of shared memory, so it is
// bound by shared-memory loads and FMA issue (f32 bound at the prefill shape:
// 7.5 us of bytes). One block of 4 warps per (32-row q tile, head, batch).
// The q tile is staged once in shared memory as f32, transposed to [d][row]
// (row padded to 36 floats) so that a warp reads its 8 rows' values of one d
// as two broadcast float4 loads. KV tiles of 32 keys are staged as f32, K
// transposed to [d][key] (row padded to 33 floats: conflict-free on the
// transposing store and on the read) and V as [key][d]. Lane j scores key j
// of the tile against the warp's 8 rows; each row's max and sum are warp
// shuffles; the probabilities go through shared memory so that the P.V
// products read them as broadcast float4s while lane j accumulates d = j,
// j + 32, ... KV tiles wholly above the diagonal are never loaded, and the q
// tiles are scheduled longest first. Shared memory: 4 * hd * 101 + 4096
// bytes (54.5 KB at hd 128, 105 KB at hd 256), opted into at launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // query rows per block
constexpr int kBlockK = 32;              // keys per tile, one per lane
constexpr int kQStride = kBlockQ + 4;    // padded row of the transposed q tile
constexpr int kKStride = kBlockK + 1;    // padded row of the transposed K tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(hd) * (kQStride + kKStride + kBlockK) +
                          static_cast<size_t>(kWarps) * kBlockK * kRows);
}

// NPL = ceil(hd / 32): the output columns each lane accumulates.
template <typename T, int NPL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                       int h, int kh, int hd, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                    // [hd][kQStride]
  float* k_t = q_t + hd * kQStride;     // [hd][kKStride]
  float* v_s = k_t + hd * kKStride;     // [kBlockK][hd]
  float* p_s = v_s + kBlockK * hd;      // [kWarps][kBlockK][kRows]

  const int tile_q = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kh);
  const int q0 = tile_q * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = q0 + warp * kRows;
  float* p_w = p_s + warp * kBlockK * kRows;

  // the q tile, transposed, f32, a row per warp and a column per lane; rows
  // past Sq are zeros (computed, never stored)
  for (int r = warp; r < kBlockQ; r += kWarps) {
    const int qpos = q0 + r;
    const int64_t row = ((static_cast<int64_t>(b) * sq + qpos) * h + head) * hd;
    for (int d = lane; d < hd; d += 32) q_t[d * kQStride + r] = qpos < sq ? to_f32(q[row + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NPL; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = (sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int q_last = min(q0 + kBlockQ, sq) - 1;
    n_tiles = min(n_tiles, q_last / kBlockK + 1);  // skip tiles above the diagonal
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (at t == 0: q_t is staged)
    for (int j = warp; j < kBlockK; j += kWarps) {  // a key per warp, a column per lane
      const int kpos = k0 + j;
      const int64_t row = ((static_cast<int64_t>(b) * sk + kpos) * kh + kv_head) * hd;
      for (int d = lane; d < hd; d += 32) {
        float kx = 0.f, vx = 0.f;
        if (kpos < sk) {
          kx = to_f32(k[row + d]);
          vx = to_f32(v[row + d]);
        }
        k_t[d * kKStride + j] = kx;
        v_s[j * hd + d] = vx;
      }
    }
    __syncthreads();

    // scores of the warp's rows against key k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float kd = k_t[d * kKStride + lane];
      const float4 qa = *reinterpret_cast<const float4*>(q_t + d * kQStride + warp * kRows);
      const float4 qb = *reinterpret_cast<const float4*>(q_t + d * kQStride + warp * kRows + 4);
      s[0] = fmaf(qa.x, kd, s[0]);
      s[1] = fmaf(qa.y, kd, s[1]);
      s[2] = fmaf(qa.z, kd, s[2]);
      s[3] = fmaf(qa.w, kd, s[3]);
      s[4] = fmaf(qb.x, kd, s[4]);
      s[5] = fmaf(qb.y, kd, s[5]);
      s[6] = fmaf(qb.z, kd, s[6]);
      s[7] = fmaf(qb.w, kd, s[7]);
    }

    // online softmax, one row at a time across the warp
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool keep = kpos < sk && (!causal || row0 + r >= kpos);
      const float x = keep ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(x - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NPL; ++c) acc[r][c] *= alpha;
      p_w[lane * kRows + r] = p;
    }
    __syncwarp();

    // acc += P . V for the lane's columns
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(p_w + j * kRows);
      const float4 pb = *reinterpret_cast<const float4*>(p_w + j * kRows + 4);
#pragma unroll
      for (int c = 0; c < NPL; ++c) {
        const int d = lane + 32 * c;
        const float vd = d < hd ? v_s[j * hd + d] : 0.f;
        acc[0][c] = fmaf(pa.x, vd, acc[0][c]);
        acc[1][c] = fmaf(pa.y, vd, acc[1][c]);
        acc[2][c] = fmaf(pa.z, vd, acc[2][c]);
        acc[3][c] = fmaf(pa.w, vd, acc[3][c]);
        acc[4][c] = fmaf(pb.x, vd, acc[4][c]);
        acc[5][c] = fmaf(pb.y, vd, acc[5][c]);
        acc[6][c] = fmaf(pb.z, vd, acc[6][c]);
        acc[7][c] = fmaf(pb.w, vd, acc[7][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = row0 + r;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* out = o + ((static_cast<int64_t>(b) * sq + qpos) * h + head) * hd;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) out[d] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int NPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int sq,
                   int sk, int h, int kh, int hd, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_attention_kernel<T, NPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, h, kh, hd, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq,
                     int sk, int h, int kh, int hd, float scale, int causal,
                     cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, stream);
    case 2: return launch<T, 2>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, stream);
    case 3: return launch<T, 3>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, stream);
    case 4: return launch<T, 4>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, stream);
    case 5: return launch<T, 5>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, stream);
    case 6: return launch<T, 6>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, stream);
    case 7: return launch<T, 7>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, stream);
    case 8: return launch<T, 8>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on wgmma tensor cores
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTile = 64;      // query rows per block and keys per KV tile
constexpr int kStages = 2;     // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

// Shared-memory offsets (bytes from a 1024-aligned base) of the Q tile and
// the K and V rings; each tile is 64 rows x HD bf16.
template <int HD>
struct Smem {
  static constexpr int kTileBytes = kTile * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBytes = kV + kStages * kTileBytes + 1024;  // + alignment slack
};

// Byte offset of the 16-byte chunk holding (row r, columns c..c+7) of a
// 64-row tile: slabs of 64 columns, 128-byte rows, chunk index XOR (r mod 8)
// (the SWIZZLE_128B layout).
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 6) * (kTile * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// cp.async writes are generic-proxy writes; wgmma reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, 64) of a [rows, row_stride] bf16 matrix starting at `src` into
// the swizzled tile at `dst`; rows at or past `n_valid` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int n_valid, int tid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + swizzled(r, c), src + (ok ? r * row_stride + c : 0), ok);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers, B MN-major (read transposed)
// in shared memory.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers, B MN-major (read transposed)
// in shared memory.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


template <int HD>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  mma_rs_n64(o, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  mma_rs_n128(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Accumulator fragment of a 64 x N wgmma tile: thread (warp w, lane l) holds
// rows r = 16 w + l / 4 and r + 8; element 4 j + e is row r + 8 (e / 2),
// column 8 j + 2 (l % 4) + e % 2.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                             int sq, int sk, int h, int kh, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t s_q = base + Smem<HD>::kQ;
  const uint32_t s_k = base + Smem<HD>::kK;
  const uint32_t s_v = base + Smem<HD>::kV;
  constexpr uint32_t kTileBytes = Smem<HD>::kTileBytes;

  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // the longest causal rows first
  const int b = blockIdx.z;
  const int kv_head = head / (h / kh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane & 3);           // and columns c0, c0 + 1 of each 8

  const int64_t q_stride = static_cast<int64_t>(h) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kh) * HD;
  const __nv_bfloat16* q_b = q + (static_cast<int64_t>(b) * sq + q0) * q_stride + head * HD;
  const __nv_bfloat16* k_b = k + static_cast<int64_t>(b) * sk * kv_stride + kv_head * HD;
  const __nv_bfloat16* v_b = v + static_cast<int64_t>(b) * sk * kv_stride + kv_head * HD;

  int n_tiles = (sk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTile, sq) - 1) / kTile + 1);

  load_tile<HD>(s_q, q_b, q_stride, sq - q0, tid);
  cp_async_commit();
  load_tile<HD>(s_k, k_b, kv_stride, sk, tid);
  load_tile<HD>(s_v, v_b, kv_stride, sk, tid);
  cp_async_commit();

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t stage = (t & 1) * kTileBytes;
    if (t + 1 < n_tiles) {  // the next tile into the other stage, freed at the end of t - 1
      const int k1 = (t + 1) * kTile;
      const uint32_t next = ((t + 1) & 1) * kTileBytes;
      load_tile<HD>(s_k + next, k_b + k1 * kv_stride, kv_stride, sk - k1, tid);
      load_tile<HD>(s_v + next, v_b + k1 * kv_stride, kv_stride, sk - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T: hd / 16 steps of k16; a step advances 32 bytes inside a
    // 128-byte row, and a slab (64 rows x 128 bytes) every 4 steps
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (kTile * 128) + (kk & 3) * 32;
      mma_ss_n64(s, desc(s_q + off, 16, 1024), desc(s_k + stage + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(s);

    // online softmax in the log2 domain, masking diagonal and tail tiles only
    const int k0 = t * kTile;
    const bool edge = k0 + kTile > sk || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + c0 + (i & 1);
        const int row = q0 + r0 + 8 * ((i >> 1) & 1);
        if (key >= sk || (causal && key > row)) x = kMasked;
      }
      s[i] = x;
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m[hr];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[hr] = exp2f(m[hr] - mx);
      m[hr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(s[4 * j + 2 * hr] - mx);
        const float p1 = exp2f(s[4 * j + 2 * hr + 1] - mx);
        s[4 * j + 2 * hr] = p0;
        s[4 * j + 2 * hr + 1] = p1;
        sum += p0 + p1;
      }
      l[hr] = l[hr] * alpha[hr] + sum;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V: P's accumulator fragment is wgmma's A fragment for k16 step
    // kk (keys 16 kk ..); V's 16 keys of a step are 2048 bytes on, its
    // 64-column slabs 64 x 128 bytes apart (the leading byte offset)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_pv<HD>(acc, pa[kk], desc(s_v + stage + kk * 16 * 128, kTile * 128, 1024));
    wgmma_commit();
    wgmma_wait();
    pin(acc);
    __syncthreads();  // this stage is free for the load of tile t + 2
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int row = q0 + r0 + 8 * hr;
    if (row >= sq) continue;
    const float denom = fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* out = o + (static_cast<int64_t>(b) * sq + row) * q_stride + head * HD + c0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hr] / denom, acc[4 * j + 2 * hr + 1] / denom);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
                   int h, int kh, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<HD>::kBytes;
  auto kernel = flash_attention_wgmma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(h, (sq + kTile - 1) / kTile, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, h, kh,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace wg

// The dynamic shared memory one block takes at head dim `hd`.
extern "C" int flash_attention_smem_bytes(int hd) { return static_cast<int>(smem_bytes(hd)); }

// q, k, v, o contiguous on the current device; dtype 0 = f32, 1 = bf16.
// Returns the cudaError of the launch; shapes the kernel does not take are
// refused with cudaErrorInvalidValue before anything is launched.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int sq, int sk, int h, int kh, int hd,
                                      float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 || kh <= 0 ||
      h % kh != 0 || hd < 16 || hd > 256 || hd % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, st));
  if (dtype == 1)
    return static_cast<int>(
        dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kh, hd, scale, causal, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 q, k, v, o contiguous and 16-byte aligned on the current device, hd 64
// or 128. Returns the cudaError of the launch; shapes the kernel does not
// take are refused with cudaErrorInvalidValue before anything is launched.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* o, int b, int sq, int sk, int h, int kh,
                                            int hd, float scale, int causal, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || sq > 65535 * wg::kTile || sk <= 0 || h <= 0 ||
      kh <= 0 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return static_cast<int>(wg::launch<64>(q, k, v, o, b, sq, sk, h, kh, scale, causal, st));
  if (hd == 128)
    return static_cast<int>(wg::launch<128>(q, k, v, o, b, sq, sk, h, kh, scale, causal, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
