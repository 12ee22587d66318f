// Flash attention forward for Hopper (sm_90a): causal GQA attention with an
// online softmax. It replaces the TPU kernel _flash_kernel of
// repro/kernels/flash_attention.py and computes, for q [B, Sq, H, hd] and
// k, v [B, Sk, KH, hd] (query head h reads KV head h / (H / KH)),
//
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / KH)],
//   s_ij = scale * q[b, i, h] . k[b, j, h / (H / KH)],
//
// with s_ij = -1e30 where j >= Sk or, when causal, j > i (the top-left mask:
// both positions counted from 0, for any Sq and Sk). The running max m, sum
// l and the accumulator live in f32; the output is acc / max(l, 1e-30) cast
// to the input type (bf16 or f32). Head dims 16..256 in multiples of 16.
//
// Bound: at the serve path's prefill shape (B 1, Sq = Sk = 1024, H 16, KH 8,
// hd 128, bf16) the causal products are 4.3 GFLOP against 12.6 MB of
// q + k + v + o, so the H100's bf16 tensor-core peak, not its memory, bounds
// the work (about 4.4 us). This first kernel does its products in f32 FMAs
// on the CUDA cores, out of shared memory, so it is bound by shared-memory
// loads and FMA issue well above that bound; wgmma and TMA are later work.
//
// Design: one block of 4 warps per (32-row q tile, head, batch). The q tile
// is staged once in shared memory as f32, transposed to [d][row] (row padded
// to 36 floats) so that a warp reads its 8 rows' values of one d as two
// broadcast float4 loads. KV
// tiles of 32 keys are staged as f32, K transposed to [d][key] (row padded
// to 33 floats: conflict-free on the transposing store and on the read) and
// V as [key][d]. Lane j scores key j of the tile against the warp's 8 rows;
// each row's max and sum are warp shuffles; the probabilities go through
// shared memory so that the P.V products read them as broadcast float4s
// while lane j accumulates d = j, j + 32, ... KV tiles wholly above the
// diagonal are never loaded, and the q tiles are scheduled longest first.
// Staging loops give each warp whole rows and each lane columns, so global
// loads are coalesced and no index is divided. Shared memory: 4 * hd * 101 +
// 4096 bytes (54.5 KB at hd 128, 105 KB at hd 256), above the 48 KB default,
// so each launch opts in first.

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
