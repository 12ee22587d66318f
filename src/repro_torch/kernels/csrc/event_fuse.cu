// The SPARS engine's fused event-pass reductions for Hopper (sm_90a): one
// read of the node arrays per batch yields a state histogram and the next
// transition time. Three kernels, one per TPU kernel they replace in
// repro/kernels/event_fuse.py:
//
//   event_fuse_ledger  (_event_ledger_kernel)  the dense path, one group:
//       sums[e, s] = count(state == s) * power[s] for s < 5; columns 5..7 0
//   event_fuse_occ     (_event_occ_kernel)     the grouped-tables path:
//       occ[e, g, s] = count(gid == g and state == s) as f32 for s < 5;
//       columns 5..7 of each group row 0
//   event_fuse         (_event_kernel)         the scalar draw:
//       draw[e] = sum over s < 5 of count(state == s) * power[s]
//
// and each also writes
//
//   next[e] = min(until) over SWITCHING_ON/SWITCHING_OFF nodes with
//             until > t[e]; INF_TIME when there is none.
//
// States outside 0..4, and group ids outside 0..G-1, count nowhere.
//
// Bound: each kernel reads 4 bytes per node and array (state and until; the
// occupancy kernel also the group id) and writes a few bytes per row. At the
// engine's E = 1, N = 11 200 that is 89.6 KB (134.4 KB with the group ids),
// 0.03-0.04 us at the H100's 3.35 TB/s; the launch and the latency of one
// block's loads dominate. So the design is one launch per batch and no second
// pass: one thread block per env row walks N with coalesced int32 loads,
// keeps integer counts and an integer running min, and reduces them with warp
// shuffles, then across warps through shared memory. The TPU kernels' lane
// padding (PAD_STATE columns) is not carried over: the loop masks the ragged
// edge itself.
//
// Exactness: counts are integers, so any summation order gives the same
// count. The ledger multiplies each count once by its watts; the scalar draw
// adds the five products in the fixed order s = 0..4 with round-to-nearest
// intrinsics (no contraction into FMAs); the occupancy counts are exact in
// f32 below 2**24. So each kernel agrees with its plain PyTorch version bit
// for bit.
//
// The occupancy histogram has G*8 cells, G known only at run time, so it
// lives in dynamic shared memory and is filled with shared-memory integer
// atomics. Nodes of one group sit next to each other and most share a state,
// so the lanes of a warp mostly carry the same cell: __match_any_sync groups
// equal cells and one lane adds the group's size, one atomic per distinct
// cell per warp instead of one per node.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStates = 5;
constexpr int kCols = 8;
constexpr int kSwitchingOn = 1;
constexpr int kSwitchingOff = 4;
constexpr int kInfTime = 1 << 30;
// the dynamic shared memory a block may take without an opt-in
constexpr int kMaxHistBytes = 48 * 1024;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int masked_until(int s, int u, int te) {
  return ((s == kSwitchingOn || s == kSwitchingOff) && u > te) ? u : kInfTime;
}

// Block-wide min of `mn` (every thread passes its own); thread 0 gets it.
__device__ __forceinline__ int block_min(int mn) {
  __shared__ int sh_min[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  mn = warp_min(mn);
  if (lane == 0) sh_min[warp] = mn;
  __syncthreads();
  mn = lane < kWarps ? sh_min[lane] : kInfTime;
  return warp_min(mn);  // meaningful in warp 0
}

// Per-row state counts (cnt[0..4]) and masked min, reduced across the block;
// valid in thread 0 on return.
__device__ __forceinline__ void count_states(const int* __restrict__ state,
                                             const int* __restrict__ until,
                                             int te, int n, int cnt[kStates],
                                             int* mn_out) {
  int mn = kInfTime;
#pragma unroll
  for (int k = 0; k < kStates; ++k) cnt[k] = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int s = state[i];
    const int u = until[i];
#pragma unroll
    for (int k = 0; k < kStates; ++k) cnt[k] += (s == k);
    mn = min(mn, masked_until(s, u, te));
  }

#pragma unroll
  for (int k = 0; k < kStates; ++k) cnt[k] = warp_sum(cnt[k]);
  __shared__ int sh_cnt[kStates][kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStates; ++k) sh_cnt[k][warp] = cnt[k];
  }
  mn = block_min(mn);  // its __syncthreads also publishes sh_cnt
#pragma unroll
  for (int k = 0; k < kStates; ++k) cnt[k] = lane < kWarps ? sh_cnt[k][lane] : 0;
#pragma unroll
  for (int k = 0; k < kStates; ++k) cnt[k] = warp_sum(cnt[k]);
  *mn_out = mn;
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
  int cnt[kStates];
  int mn;
  count_states(node_state + static_cast<size_t>(e) * n,
               node_until + static_cast<size_t>(e) * n, t[e], n, cnt, &mn);
  if (threadIdx.x == 0) {
    float* row = sums + static_cast<size_t>(e) * kCols;
#pragma unroll
    for (int k = 0; k < kStates; ++k)
      row[k] = __fmul_rn(static_cast<float>(cnt[k]), power[k]);
#pragma unroll
    for (int k = kStates; k < kCols; ++k) row[k] = 0.0f;
    next[e] = mn;
  }
}

__global__ void __launch_bounds__(kThreads)
event_fuse_kernel(const int* __restrict__ node_state,
                  const int* __restrict__ node_until,
                  const int* __restrict__ t,
                  const float* __restrict__ power,
                  float* __restrict__ draw,
                  int* __restrict__ next,
                  int n) {
  const int e = blockIdx.x;
  int cnt[kStates];
  int mn;
  count_states(node_state + static_cast<size_t>(e) * n,
               node_until + static_cast<size_t>(e) * n, t[e], n, cnt, &mn);
  if (threadIdx.x == 0) {
    // the five products added in the fixed order s = 0..4
    float acc = __fmul_rn(static_cast<float>(cnt[0]), power[0]);
#pragma unroll
    for (int k = 1; k < kStates; ++k)
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(cnt[k]), power[k]));
    draw[e] = acc;
    next[e] = mn;
  }
}

__global__ void __launch_bounds__(kThreads)
event_fuse_occ_kernel(const int* __restrict__ node_state,
                      const int* __restrict__ node_until,
                      const int* __restrict__ t,
                      const int* __restrict__ group_id,
                      float* __restrict__ occ,
                      int* __restrict__ next,
                      int n,
                      int n_groups) {
  extern __shared__ int hist[];  // [n_groups * 8] cells gid * 8 + state
  const int e = blockIdx.x;
  const int* state = node_state + static_cast<size_t>(e) * n;
  const int* until = node_until + static_cast<size_t>(e) * n;
  const int te = t[e];
  const int cells = n_groups * kCols;
  for (int c = threadIdx.x; c < cells; c += kThreads) hist[c] = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int mn = kInfTime;
  // warp-uniform trip count, so every lane of a warp reaches the match
  for (int base = warp * 32; base < n; base += kThreads) {
    const int i = base + lane;
    int cell = -1;
    if (i < n) {
      const int s = state[i];
      const int g = group_id[i];
      mn = min(mn, masked_until(s, until[i], te));
      if (s >= 0 && s < kStates && g >= 0 && g < n_groups) cell = g * kCols + s;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    if (cell >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[cell], __popc(peers));
  }
  mn = block_min(mn);  // its __syncthreads also completes the histogram

  float* row = occ + static_cast<size_t>(e) * cells;
  for (int c = threadIdx.x; c < cells; c += kThreads)
    row[c] = (c % kCols) < kStates ? static_cast<float>(hist[c]) : 0.0f;
  if (threadIdx.x == 0) next[e] = mn;
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers of
// contiguous tensors: node_state/node_until int32 [e, n], t int32 [e],
// power float32 [5], group_id int32 [n]; outputs sums float32 [e, 8],
// draw float32 [e], occ float32 [e, n_groups, 8], next int32 [e]. Each
// launches on `stream` and returns cudaGetLastError() (0 = launched).

extern "C" int event_fuse_ledger_launch(const void* node_state, const void* node_until,
                                        const void* t, const void* power, void* sums,
                                        void* next, int e, int n, void* stream) {
  event_fuse_ledger_kernel<<<e, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_state), static_cast<const int*>(node_until),
      static_cast<const int*>(t), static_cast<const float*>(power),
      static_cast<float*>(sums), static_cast<int*>(next), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int event_fuse_launch(const void* node_state, const void* node_until,
                                 const void* t, const void* power, void* draw,
                                 void* next, int e, int n, void* stream) {
  event_fuse_kernel<<<e, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_state), static_cast<const int*>(node_until),
      static_cast<const int*>(t), static_cast<const float*>(power),
      static_cast<float*>(draw), static_cast<int*>(next), n);
  return static_cast<int>(cudaGetLastError());
}

// The histogram's G * 8 int32 cells must fit the dynamic shared memory a
// block takes without an opt-in (48 KB: G <= 1536); a larger G is refused
// with cudaErrorInvalidValue before anything is launched.
extern "C" int event_fuse_occ_launch(const void* node_state, const void* node_until,
                                     const void* t, const void* group_id, void* occ,
                                     void* next, int e, int n, int n_groups,
                                     void* stream) {
  const size_t hist_bytes = static_cast<size_t>(n_groups) * kCols * sizeof(int);
  if (n_groups <= 0 || hist_bytes > static_cast<size_t>(kMaxHistBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  event_fuse_occ_kernel<<<e, kThreads, hist_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(node_state), static_cast<const int*>(node_until),
      static_cast<const int*>(t), static_cast<const int*>(group_id),
      static_cast<float*>(occ), static_cast<int*>(next), n, n_groups);
  return static_cast<int>(cudaGetLastError());
}
