// The masked exact 1-nearest-neighbour scan of K2 (nn_corr.cu) and K3
// (nn_argmin.cu), for Hopper (sm_90a): refs compacted to the valid ones and
// split across the blocks of a thread-block cluster.
//
// Semantics (the TPU kernels', rivslam_tpu/ops/pallas_nn.py:29-61 and
// :74-128): per query, the minimum over the valid refs j of
// |q|^2 + |r_j|^2 - 2 q.r_j (unclamped) and the FIRST j reaching it; 1e30 and
// index 0 when no valid ref beats 1e30. Scanning the refs in index order with
// a strict "<" gives that winner, whatever the tiling.
//
// Numerics. Every product and sum of the distance is rounded on its own
// (__fmul_rn/__fadd_rn, no FMA contraction), in the order of the plain twin
// (ops/nn_argmin.nearest_neighbor_plain), so the two agree bitwise on d2 and
// on the winner. Do not build with --use_fast_math.
//
// Design.
//   - Compaction. A block walks the refs in chunks of kChunk. Each thread
//     flags kPerThread refs of the chunk (consecutive threads on consecutive
//     refs, so the loads coalesce, and every load of a chunk in flight at
//     once); a warp ballot and the per-warp counts give every valid ref its
//     rank among the problem's valid refs, and the block stages only the
//     valid refs of its slice in shared memory, in index order, as float4
//     (x, y, z, |r|^2) with their indices. The scan then visits only valid
//     refs (about 313 of the engine's 1024 slots). A masked ref never won
//     before (its distance was NaN or 1e30 and failed every "<"), so
//     compaction changes no result.
//   - Split. The grid is S ref slices x query blocks x problems. Block s
//     scans the valid refs of rank [s V / S, (s + 1) V / S) (V: the
//     problem's valid refs, counted by the block first), so the slices hold
//     equal shares of the valid refs wherever the mask puts them. The S
//     blocks of a query block form one cluster; each leaves its slice's
//     (minimum, first index) per query in shared memory, and after a
//     cluster barrier each block combines the S partials of its share of the
//     queries through distributed shared memory, in slice order with a
//     strict "<". A minimum with its first index, combined in index order,
//     is associative, so the result is bitwise the serial scan's, whatever
//     S. With S = 1 (a grid that already covers the card, B = 256) there is
//     no count, no cluster and no combine.
//   - Numbers (chip_smoke.py phase 12, PERF.md section 6; NVIDIA H100 80GB
//     HBM3 at 700 W), K3 / K2 at the engine's B=1, S=8, in a CUDA graph:
//     this form 5.8 / 6.4 us (the unsplit scan of all 1024 slots, one
//     block per 64 queries: 15.4 / 15.6 us; an empty kernel on the same
//     grid: 1.1 us).
//     Forms measured and not kept: the same split in two passes, partials
//     to global memory and a combine kernel, 6.6 / 9.4 us; slices
//     interleaved by rank (s modulo S, no count, combined by the smaller
//     distance then index), 6.4 / 7.2 us (a division by the run-time S per
//     staged ref); 16 refs staged a thread per chunk (M=1024 in one round
//     of loads), 0.1-0.3 us faster at B=1 but 12-16% slower at B=256.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nnscan {

namespace cg = cooperative_groups;

constexpr int kThreads = 64;                   // queries per block
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;                  // refs a thread flags per chunk
constexpr int kChunk = kThreads * kPerThread;  // refs per staged chunk
constexpr int kMaxSplit = 8;                   // blocks of a cluster (the portable maximum)
constexpr float kBig = 1e30f;

struct Smem {
  float4 tile[kChunk];            // the slice's valid refs of a chunk: x, y, z, |r|^2
  int tile_j[kChunk];             // their indices, in index order
  int count[kPerThread][kWarps];  // valid refs of a chunk by (row, warp)
  int valid[kWarps];              // the problem's valid refs, by warp
  float part_d[kThreads];         // this block's slice minimum per query
  int part_j[kThreads];           // and its first index
  int win[kThreads];              // K2: the winners of the rows this block gathers, -1: none
};

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Same operation order as the plain twin; see the note above.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float qn,
                                        float rx, float ry, float rz, float rn) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, rx), __fmul_rn(qy, ry)), __fmul_rn(qz, rz));
  return __fsub_rn(__fadd_rn(qn, rn), __fmul_rn(2.0f, cross));
}

// The ranks [lo, hi) of the valid refs that block s of S scans; with S > 1
// the block first counts the problem's valid refs (it synchronizes the
// block).
__device__ void slice_of(Smem& sh, const uint8_t* __restrict__ m, int M, int s, int S,
                         int& lo, int& hi) {
  lo = 0;
  hi = M;
  if (S == 1) return;
  int c = 0;
  for (int j = threadIdx.x; j < M; j += kThreads) c += m[j] != 0;
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) sh.valid[threadIdx.x >> 5] = c;
  __syncthreads();
  long long V = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) V += sh.valid[w];
  lo = (int)(V * s / S);
  hi = (int)(V * (s + 1) / S);
}

// Scans the valid refs of rank [lo, hi) of one problem in index order with a
// strict "<", from (best, best_j) on: they come out as the minimum and its
// first index, or unchanged where no ref of the slice is below best. All
// threads of the block call it (it synchronizes the block).
__device__ void scan_slice(Smem& sh, const float* __restrict__ r, const uint8_t* __restrict__ m,
                           int M, int lo, int hi, float qx, float qy, float qz, float qn,
                           float& best, int& best_j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;  // valid refs before this chunk
  for (int start = 0; start < M && base < hi; start += kChunk) {
    bool v[kPerThread];
    float x[kPerThread], y[kPerThread], z[kPerThread];
    int pre[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int j = start + k * kThreads + threadIdx.x;
      const bool in = j < M;
      v[k] = in && m[j] != 0;
      x[k] = in ? r[j * 3 + 0] : 0.0f;
      y[k] = in ? r[j * 3 + 1] : 0.0f;
      z[k] = in ? r[j * 3 + 2] : 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, v[k]);
      pre[k] = __popc(ballot & below);
      if (lane == 0) sh.count[k][warp] = __popc(ballot);
    }
    __syncthreads();  // the counts are in; the previous chunk's tile is no longer read
    int ofs[kPerThread] = {};
    int n_chunk = 0;  // valid refs in this chunk; ofs: those before this thread's row k
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) ofs[k] = n_chunk;
        n_chunk += sh.count[k][w];
      }
    }
    const int cs = max(lo, base), ce = min(hi, base + n_chunk);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int o = base + ofs[k] + pre[k];
      if (v[k] && o >= cs && o < ce) {
        sh.tile[o - cs] = make_float4(x[k], y[k], z[k], norm2(x[k], y[k], z[k]));
        sh.tile_j[o - cs] = start + k * kThreads + threadIdx.x;
      }
    }
    __syncthreads();  // the tile is staged
    const int n = max(ce - cs, 0);
    int bp = -1;
#pragma unroll 8
    for (int p = 0; p < n; ++p) {
      const float4 t = sh.tile[p];
      const float d = sqdist(qx, qy, qz, qn, t.x, t.y, t.z, t.w);
      if (d < best) {
        best = d;
        bp = p;
      }
    }
    if (bp >= 0) best_j = sh.tile_j[bp];
    base += n_chunk;
  }
}

// The cluster's S partials of local query q (each block left its slice's
// minimum and first index in part_d/part_j), read together, then combined
// in slice order with a strict "<": the minimum over the problem's valid
// refs and its first index.
__device__ void combine(Smem& sh, int S, int q, float& best, int& best_j) {
  cg::cluster_group cluster = cg::this_cluster();
  float d[kMaxSplit];
  int j[kMaxSplit];
#pragma unroll
  for (int rank = 0; rank < kMaxSplit; ++rank) {
    if (rank < S) {
      d[rank] = cluster.map_shared_rank(sh.part_d, rank)[q];
      j[rank] = cluster.map_shared_rank(sh.part_j, rank)[q];
    }
  }
  best = kBig;
  best_j = 0;
#pragma unroll
  for (int rank = 0; rank < kMaxSplit; ++rank) {
    if (rank < S && d[rank] < best) {
      best = d[rank];
      best_j = j[rank];
    }
  }
}

// Launches `kernel` on a grid of S slices x query blocks x B problems, the S
// slices of a query block as one cluster (none when S = 1); returns the
// launch's cudaError_t.
template <typename... Params, typename... Args>
int launch_split(void (*kernel)(Params...), int B, int N, int S, void* stream, Args... args) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (S < 1 || S > kMaxSplit) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (N + kThreads - 1) / kThreads, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace nnscan
