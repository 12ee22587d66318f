// event_fuse_ledger for Hopper (sm_90a): the fused event-pass reduction of
// the SPARS engine, one read of the node arrays per batch.
//
// Replaces the TPU kernel repro/kernels/event_fuse.py::event_fuse_ledger
// (_event_ledger_kernel). For each env row e it computes
//
//   sums[e, s] = count(state == s) * power[s]   for s < 5; columns 5..7 are 0
//   next[e]    = min(until) over SWITCHING_ON/SWITCHING_OFF nodes with
//                until > t[e]; INF_TIME when there is none
//
// States >= 5 (padding) count nowhere.
//
// Bound: the kernel reads 8 bytes per node (state and until, int32) and
// writes 36 bytes per row: 8*E*N bytes, 89.6 KB for the engine's E = 1,
// N = 11 200, about 0.03 us at the H100's 3.35 TB/s. At E = 1 the launch
// (a few microseconds) dominates, so the design keeps one launch per batch
// and no second pass: one thread block per env row walks N with coalesced
// int32 loads, keeps five integer state counts and an integer running min in
// registers, and reduces them with warp shuffles, then across warps through
// shared memory. Counting in integers and multiplying once per state gives
// the same f32 value as the plain PyTorch version (one rounding of an exact
// count times the watts), so the two are bit-exact. A multi-block or
// persistent design for large E, and capturing the batch loop in a CUDA
// graph, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStates = 5;
constexpr int kCols = 8;
constexpr int kSwitchingOn = 1;
constexpr int kSwitchingOff = 4;
constexpr int kInfTime = 1 << 30;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
event_fuse_ledger_kernel(const int* __restrict__ node_state,
                         const int* __restrict__ node_until,
                         const int* __restrict__ t,
                         const float* __restrict__ power,
                         float* __restrict__ sums,
                         int* __restrict__ next,
                         int n) {
  const int e = blockIdx.x;
  const int* state = node_state + static_cast<size_t>(e) * n;
  const int* until = node_until + static_cast<size_t>(e) * n;
  const int te = t[e];

  int cnt[kStates] = {0, 0, 0, 0, 0};
  int mn = kInfTime;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int s = state[i];
    const int u = until[i];
#pragma unroll
    for (int k = 0; k < kStates; ++k) cnt[k] += (s == k);
    if ((s == kSwitchingOn || s == kSwitchingOff) && u > te) mn = min(mn, u);
  }

#pragma unroll
  for (int k = 0; k < kStates; ++k) cnt[k] = warp_sum(cnt[k]);
  mn = warp_min(mn);

  __shared__ int sh_cnt[kStates][kWarps];
  __shared__ int sh_min[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStates; ++k) sh_cnt[k][warp] = cnt[k];
    sh_min[warp] = mn;
  }
  __syncthreads();

  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kStates; ++k) cnt[k] = lane < kWarps ? sh_cnt[k][lane] : 0;
    mn = lane < kWarps ? sh_min[lane] : kInfTime;
#pragma unroll
    for (int k = 0; k < kStates; ++k) cnt[k] = warp_sum(cnt[k]);
    mn = warp_min(mn);
    if (lane == 0) {
      float* row = sums + static_cast<size_t>(e) * kCols;
#pragma unroll
      for (int k = 0; k < kStates; ++k)
        row[k] = __fmul_rn(static_cast<float>(cnt[k]), power[k]);
#pragma unroll
      for (int k = kStates; k < kCols; ++k) row[k] = 0.0f;
      next[e] = mn;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers of
// contiguous tensors: node_state/node_until int32 [e, n], t int32 [e],
// power float32 [5], sums float32 [e, 8], next int32 [e]. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int event_fuse_ledger_launch(const void* node_state,
                                        const void* node_until,
                                        const void* t,
                                        const void* power,
                                        void* sums,
                                        void* next,
                                        int e,
                                        int n,
                                        void* stream) {
  event_fuse_ledger_kernel<<<e, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_state), static_cast<const int*>(node_until),
      static_cast<const int*>(t), static_cast<const float*>(power),
      static_cast<float*>(sums), static_cast<int*>(next), n);
  return static_cast<int>(cudaGetLastError());
}
