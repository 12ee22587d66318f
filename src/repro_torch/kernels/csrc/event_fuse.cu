// The SPARS engine's fused event-pass reductions for Hopper (sm_90a): one
// read of the node arrays per batch yields a state histogram and the next
// transition time. Three kernels, one per TPU kernel they replace in
// repro/kernels/event_fuse.py:
//
//   event_fuse_ledger  (_event_ledger_kernel)  the dense path, one group:
//       sums[e, s] = count(state == s) * power[e][s] for s < 5; columns 5..7 0
//   event_fuse_occ     (_event_occ_kernel)     the grouped-tables path:
//       occ[e, g, s] = count(gid[e] == g and state == s) as f32 for s < 5;
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
// The watts (ledger) and the group ids (occupancy) are one table shared by
// every row, or one table a row (a sweep whose scenarios differ in their
// platform): the row's table starts `stride` elements after the previous
// row's, and a stride of 0 is the shared form. Nothing else depends on it.
//
// Bound: each kernel reads 4 bytes per node and array (state and until; the
// occupancy kernel also the group id) and writes a few bytes per row. At the
// engine's E = 1, N = 11 200 that is 89.6 KB (134.4 KB with the group ids),
// 0.03-0.04 us at the H100's 3.35 TB/s. So what bounds a call is latency:
// the launch, and how many dependent trips to device memory a row takes.
//
// The ledger and occupancy kernels split each env row over a thread-block
// cluster of C CTAs (cudaLaunchKernelEx with a cluster dimension). The
// wrapper picks C from E and N so that the grid fills the card while each
// CTA keeps enough of its row: 16 for the occupancy kernel and 4 for the
// ledger (whose CTAs do less work a node; faster than 8 or 16 there) at
// the engine's E = 1 and N = 11 200, 1 for a row under 1024 nodes. Each CTA
// takes a contiguous run of 4-node quads, counted from the 16-byte boundary
// at or before the row's start, and each thread issues all the loads of its
// quads (16-byte vector loads where the array is 16-byte aligned on that
// boundary, scalar loads on the ragged head and tail and for a misaligned
// array) before it uses any of them: a thread holds one to three quads, so
// one memory latency covers the row. Counts and the masked min stay in
// registers; the occupancy histogram is built per CTA in shared memory with
// warp-aggregated atomics (__match_any_sync groups lanes that carry the same
// cell, and one lane adds the group's size). Then the cluster reduces
// through distributed shared memory (cluster.map_shared_rank(..., 0)):
//
//   ledger: each CTA stores its five counts and its min into its own slot of
//       the leader's shared memory, and the leader adds the slots in rank
//       order: no zeroing and no atomics (faster than the atomic form
//       below in every configuration timed).
//   occupancy: the histogram has G * 8 cells, too many for a slot per CTA at
//       large G, so each CTA adds its non-zero cells into the leader's
//       accumulator with integer atomicAdd, and its min with atomicMin.
//
// Two cluster barriers in each. The first is split into an arrive at the
// start (after the leader zeroes its accumulator; relaxed, publishing no
// memory, in every other CTA) and a wait just before the first remote
// access: it makes sure every CTA of the cluster has started before any
// touches another's shared memory, and it overlaps the loads and the local
// reduction. The second ends the remote writes before
// the leader reads them; non-leaders exit only after it, and the leader
// writes the row. One launch per call, no scratch in global memory, no
// memset.
//
// The scalar draw (event_fuse_kernel, no engine caller) keeps the one-block-
// per-row design: one block walks N with coalesced int32 loads and reduces
// with warp shuffles, then across warps through shared memory.
//
// Exactness: counts are integers, so any summation order gives the same
// count. The ledger multiplies each count once by its watts; the scalar draw
// adds the five products in the fixed order s = 0..4 with round-to-nearest
// intrinsics (no contraction into FMAs); the occupancy counts are exact in
// f32 below 2**24. So each kernel agrees with its plain PyTorch version bit
// for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStates = 5;
constexpr int kCols = 8;
constexpr int kSwitchingOn = 1;
constexpr int kSwitchingOff = 4;
constexpr int kInfTime = 1 << 30;
// a CTA's histogram and the leader's accumulator, G * 8 int32 cells each;
// G <= 1536 keeps both within 96 KB of dynamic shared memory
constexpr int kMaxHistBytes = 48 * 1024;
// quads a thread loads before it uses the first of them
constexpr int kQuads = 4;
constexpr int kMaxCluster = 16;

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

// ---- the cluster-split rows ----------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

// An arrive that publishes no memory, cheaper than the release form: for a
// CTA that has written nothing another CTA reads.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Nodes i0..i0+3 of an int32 row of n, `fill` where a node is outside
// [0, n): one 16-byte load when `vec` (the quad's address is 16-byte
// aligned) and all four are inside, else four scalar loads.
__device__ __forceinline__ int4 load_quad(const int* __restrict__ p, int i0, int n,
                                          bool vec, int fill) {
  if (vec && i0 >= 0 && i0 + 3 < n) return __ldg(reinterpret_cast<const int4*>(p + i0));
  int4 r;
  r.x = (i0 >= 0 && i0 < n) ? __ldg(p + i0) : fill;
  r.y = (i0 + 1 >= 0 && i0 + 1 < n) ? __ldg(p + i0 + 1) : fill;
  r.z = (i0 + 2 >= 0 && i0 + 2 < n) ? __ldg(p + i0 + 2) : fill;
  r.w = (i0 + 3 >= 0 && i0 + 3 < n) ? __ldg(p + i0 + 3) : fill;
  return r;
}

__device__ __forceinline__ int quad_get(const int4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// One CTA's share of a row: quads [k0, k1) of the row's quads, quad k
// holding nodes 4k - a .. 4k - a + 3, where the state row starts `a` int32s
// past a 16-byte boundary.
struct Slice {
  int a, k0, k1;
};

__device__ __forceinline__ Slice cta_slice(const int* state, int n, int rank, int c) {
  Slice sl;
  sl.a = static_cast<int>((reinterpret_cast<uintptr_t>(state) >> 2) & 3);
  const long long quads = (sl.a + static_cast<long long>(n) + 3) >> 2;
  sl.k0 = static_cast<int>(quads * rank / c);
  sl.k1 = static_cast<int>(quads * (rank + 1) / c);
  return sl;
}

__device__ __forceinline__ bool same_alignment(const void* p, const void* q) {
  return ((reinterpret_cast<uintptr_t>(p) - reinterpret_cast<uintptr_t>(q)) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
event_fuse_ledger_kernel(const int* __restrict__ node_state,
                         const int* __restrict__ node_until,
                         const int* __restrict__ t,
                         const float* __restrict__ power,
                         float* __restrict__ out,  // sums [e, 8], then next [e]
                         int rows,
                         int n,
                         int power_stride) {
  // in the leader: each CTA's five counts and min, one slot per CTA
  __shared__ int slots[kMaxCluster][kStates + 1];
  __shared__ int sh[kStates + 1][kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / c;
  cluster_arrive_relaxed();  // this CTA has started
  const int* state = node_state + static_cast<size_t>(e) * n;
  const int* until = node_until + static_cast<size_t>(e) * n;
  const int te = t[e];
  const Slice sl = cta_slice(state, n, rank, c);
  const bool vec_u = same_alignment(until, state);
  int cnt[kStates] = {0, 0, 0, 0, 0};
  int mn = kInfTime;
  for (int base = sl.k0; base < sl.k1; base += kThreads * kQuads) {
    int4 s[kQuads], u[kQuads];
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int k = base + j * kThreads + threadIdx.x;
      const int i0 = k < sl.k1 ? 4 * k - sl.a : n;
      s[j] = load_quad(state, i0, n, true, -1);
      u[j] = load_quad(until, i0, n, vec_u, 0);
    }
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sv = quad_get(s[j], q);
#pragma unroll
        for (int k = 0; k < kStates; ++k) cnt[k] += (sv == k);
        mn = min(mn, masked_until(sv, quad_get(u[j], q), te));
      }
    }
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < kStates; ++k) cnt[k] = warp_sum(cnt[k]);
  mn = warp_min(mn);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStates; ++k) sh[k][warp] = cnt[k];
    sh[kStates][warp] = mn;
  }
  __syncthreads();
  const int k = threadIdx.x;  // thread k <= 5 reduces count k (5: the min)
  int v = k < kStates ? 0 : kInfTime;
  if (k <= kStates) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = k < kStates ? v + sh[k][w] : min(v, sh[k][w]);
  }
  cluster_wait();  // every CTA of the cluster has started
  if (k <= kStates) cluster.map_shared_rank(&slots[0][0], 0)[rank * (kStates + 1) + k] = v;
  cluster_arrive();
  cluster_wait();  // every CTA's slot is written
  if (rank != 0) return;
  if (k <= kStates) {
    v = k < kStates ? 0 : kInfTime;
    for (int r = 0; r < c; ++r) v = k < kStates ? v + slots[r][k] : min(v, slots[r][k]);
  }
  const float* pw = power + static_cast<size_t>(e) * power_stride;
  if (k < kCols)
    out[static_cast<size_t>(e) * kCols + k] =
        k < kStates ? __fmul_rn(static_cast<float>(v), pw[k]) : 0.0f;
  if (k == kStates) reinterpret_cast<int*>(out + static_cast<size_t>(rows) * kCols)[e] = v;
}

__global__ void __launch_bounds__(kThreads)
event_fuse_occ_kernel(const int* __restrict__ node_state,
                      const int* __restrict__ node_until,
                      const int* __restrict__ t,
                      const int* __restrict__ group_id,
                      float* __restrict__ out,  // occ [e, G, 8], then next [e]
                      int rows,
                      int n,
                      int n_groups,
                      int gid_stride) {
  // [cells] this CTA's histogram, then [cells] the cluster's (the leader's)
  extern __shared__ int smem[];
  __shared__ int acc_min;
  const int cells = n_groups * kCols;
  int* hist = smem;
  int* acc = smem + cells;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / c;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    hist[i] = 0;
    if (rank == 0) acc[i] = 0;
  }
  if (rank == 0 && threadIdx.x == 0) acc_min = kInfTime;
  if (rank == 0)
    cluster_arrive();  // publishes the zeroed accumulator
  else
    cluster_arrive_relaxed();
  __syncthreads();  // this CTA's histogram is zeroed

  const int* state = node_state + static_cast<size_t>(e) * n;
  const int* until = node_until + static_cast<size_t>(e) * n;
  const int* gid = group_id + static_cast<size_t>(e) * gid_stride;
  const int te = t[e];
  const Slice sl = cta_slice(state, n, rank, c);
  const bool vec_u = same_alignment(until, state);
  const bool vec_g = same_alignment(gid, state);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int mn = kInfTime;
  for (int base = sl.k0; base < sl.k1; base += kThreads * kQuads) {
    int4 s[kQuads], u[kQuads], g[kQuads];
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int k = base + j * kThreads + threadIdx.x;
      const int i0 = k < sl.k1 ? 4 * k - sl.a : n;
      s[j] = load_quad(state, i0, n, true, -1);
      u[j] = load_quad(until, i0, n, vec_u, 0);
      g[j] = load_quad(gid, i0, n, vec_g, -1);
    }
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      // warp-uniform: skip a step where no lane of the warp holds a quad,
      // so every lane of a warp reaches each match together
      if (base + j * kThreads + warp * 32 >= sl.k1) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sv = quad_get(s[j], q);
        const int gv = quad_get(g[j], q);
        mn = min(mn, masked_until(sv, quad_get(u[j], q), te));
        const int cell = (sv >= 0 && sv < kStates && gv >= 0 && gv < n_groups)
                             ? gv * kCols + sv : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, cell);
        if (cell >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[cell], __popc(peers));
      }
    }
  }
  mn = block_min(mn);  // its __syncthreads also completes the histogram

  cluster_wait();  // the leader's accumulator is zeroed
  int* lead = cluster.map_shared_rank(acc, 0);
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int v = hist[i];
    if (v != 0) atomicAdd(lead + i, v);
  }
  if (threadIdx.x == 0 && mn != kInfTime) atomicMin(cluster.map_shared_rank(&acc_min, 0), mn);
  cluster_arrive();
  cluster_wait();  // every CTA's counts are in
  if (rank != 0) return;
  float* row = out + static_cast<size_t>(e) * cells;
  for (int i = threadIdx.x; i < cells; i += kThreads)
    row[i] = (i % kCols) < kStates ? static_cast<float>(acc[i]) : 0.0f;
  if (threadIdx.x == 0)
    reinterpret_cast<int*>(out + static_cast<size_t>(rows) * cells)[e] = acc_min;
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

size_t occ_smem(int n_groups) {
  return 2 * static_cast<size_t>(n_groups) * kCols * sizeof(int);
}

// Launch `kernel` over rows * c CTAs in clusters of c on `stream`; the
// launch's own error, or the last error.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int rows, int c, size_t smem,
                    void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Allow clusters of up to 16 CTAs (and `smem` bytes of dynamic shared
// memory) for `kernel`, and find the largest power-of-two cluster size the
// card can hold at least once at that shared memory.
template <typename... Params>
int setup_clusters(void (*kernel)(Params...), size_t smem, int* max_cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > static_cast<size_t>(kMaxHistBytes))
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err == cudaSuccess && active > 0) {
      *max_cluster = c;
      return 0;
    }
    cudaGetLastError();  // a refused size: try the next smaller one
  }
  return static_cast<int>(err == cudaSuccess ? cudaErrorInvalidConfiguration : err);
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers of
// contiguous tensors: node_state/node_until int32 [e, n], t int32 [e],
// power float32 [5] (power_stride 0) or [e, 5] (power_stride 5), group_id
// int32 [n] (gid_stride 0) or [e, n] (gid_stride n); `out` is one buffer holding the
// float32 sums [e, 8] (or occ [e, n_groups, 8]) followed by the int32 next
// [e]; draw float32 [e] and next int32 [e] for the scalar draw. Each
// launches on `stream` and returns the launch's error (0 = launched).

// which = 0 (ledger) or 1 (occupancy): allow cluster sizes up to 16 (and,
// for the occupancy kernel, the shared memory of MAX_GROUPS groups) and
// write the largest cluster size the card holds to *max_cluster. Called once
// per kernel and device, on that device, before the first launch.
extern "C" int event_fuse_cluster_setup(int which, int* max_cluster) {
  if (which == 0) return setup_clusters(event_fuse_ledger_kernel, 0, max_cluster);
  if (which == 1)
    return setup_clusters(event_fuse_occ_kernel, 2 * static_cast<size_t>(kMaxHistBytes),
                          max_cluster);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int event_fuse_ledger_launch(const void* node_state, const void* node_until,
                                        const void* t, const void* power, void* out,
                                        int e, int n, int c, int power_stride,
                                        void* stream) {
  if (c < 1 || c > kMaxCluster || power_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(event_fuse_ledger_kernel, e, c, 0, stream,
                         static_cast<const int*>(node_state),
                         static_cast<const int*>(node_until),
                         static_cast<const int*>(t), static_cast<const float*>(power),
                         static_cast<float*>(out), e, n, power_stride);
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

// The histogram and the accumulator, G * 8 int32 cells each, must fit the
// 96 KB that event_fuse_cluster_setup allows (G <= 1536); a larger G, or a
// cluster size outside 1..16, is refused with cudaErrorInvalidValue before
// anything is launched.
extern "C" int event_fuse_occ_launch(const void* node_state, const void* node_until,
                                     const void* t, const void* group_id, void* out,
                                     int e, int n, int n_groups, int c, int gid_stride,
                                     void* stream) {
  const size_t smem = occ_smem(n_groups);
  if (n_groups <= 0 || smem > 2 * static_cast<size_t>(kMaxHistBytes) || c < 1 ||
      c > kMaxCluster || gid_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(event_fuse_occ_kernel, e, c, smem, stream,
                         static_cast<const int*>(node_state),
                         static_cast<const int*>(node_until),
                         static_cast<const int*>(t), static_cast<const int*>(group_id),
                         static_cast<float*>(out), e, n, n_groups, gid_stride);
}
