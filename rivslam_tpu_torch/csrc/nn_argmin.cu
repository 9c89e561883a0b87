// K3: exact masked 1-nearest-neighbour search (first-index argmin and its
// squared distance), batched over problems, for Hopper (sm_90a).
//
// Replaces the TPU kernel rivslam_tpu/ops/pallas_nn.py:29-61 (_nn_kernel
// under nearest_neighbor_pallas, :289-324). On the per-frame engine it is
// the nearest-neighbour pass of the window backend's edge-information
// fitness (factors/infomat.fitness_score, once per frame) and of the
// keyframe graph's odometry edges.
//
// Contract (per problem b, query i):
//   d2[b, i]  = min over valid refs j of |q|^2 + |r_j|^2 - 2 q.r_j
//               (unclamped: it may be slightly negative), or 1e30 when
//               problem b has no valid ref;
//   idx[b, i] = the FIRST j reaching that minimum, or 0 when there is none.
// The TPU kernel takes the first index within a 512-ref tile and replaces
// its running minimum only on a strictly smaller tile minimum; scanning the
// refs in index order with a strict "<" gives the same winner, whatever the
// tiling. Valid refs are taken to be finite.
//
// What bounds it on an H100. Per (query, valid ref) pair the scan costs 8
// unfused float32 instructions for the distance plus a compare and two
// selects (11); the card issues SMs x 128 of them a clock. At B=256,
// N=M=1024, every ref valid, that is 0.088 ms against 6.6 MB of traffic
// (0.002 ms): bound by instructions. At the engine's shape (B=1, N=M=1024,
// ~313 valid refs) the bound is 0.1 us, and the time is latency: a launch,
// one round of loads, the scan of one thread's refs, the combine.
//
// Design (csrc/nn_scan.cuh): one thread per query; the block stages only
// the valid refs, compacted in index order, and a grid that would leave SMs
// idle splits them into S slices (ops/nn_argmin.split_for: S = 8 at the
// engine's B=1, 1 at B=256) scanned by the S blocks of a cluster and
// combined through distributed shared memory.

#include "nn_scan.cuh"

namespace {

using nnscan::kBig;
using nnscan::kThreads;

__global__ void __launch_bounds__(kThreads)
nn_argmin_kernel(const float* __restrict__ query,   // [B, N, 3]
                 const float* __restrict__ ref,     // [B, M, 3]
                 const uint8_t* __restrict__ mask,  // [B, M] (bool)
                 int32_t* __restrict__ idx_out,     // [B, N]
                 float* __restrict__ d2_out,        // [B, N]
                 int N, int M) {
  __shared__ nnscan::Smem sh;

  const int S = gridDim.x, s = blockIdx.x, b = blockIdx.z;
  const int i0 = blockIdx.y * kThreads;
  const int i = i0 + threadIdx.x;
  const bool live = i < N;
  const float* q = query + ((size_t)b * N + (live ? i : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float qn = nnscan::norm2(qx, qy, qz);

  const float* r = ref + (size_t)b * M * 3;
  const uint8_t* m = mask + (size_t)b * M;
  int lo, hi;
  nnscan::slice_of(sh, m, M, s, S, lo, hi);
  float best = kBig;
  int best_j = 0;
  nnscan::scan_slice(sh, r, m, M, lo, hi, qx, qy, qz, qn, best, best_j);
  if (S == 1) {
    if (live) {
      d2_out[(size_t)b * N + i] = best;
      idx_out[(size_t)b * N + i] = best_j;
    }
    return;
  }
  sh.part_d[threadIdx.x] = best;
  sh.part_j[threadIdx.x] = best_j;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();  // every slice's partials are in
  // block s writes queries [q0, q0 + nq) of the query block
  const int q0 = s * kThreads / S, nq = (s + 1) * kThreads / S - q0;
  const int qi = q0 + (int)threadIdx.x;
  if ((int)threadIdx.x < nq && i0 + qi < N) {
    float d;
    int j;
    nnscan::combine(sh, S, qi, d, j);
    d2_out[(size_t)b * N + i0 + qi] = d;
    idx_out[(size_t)b * N + i0 + qi] = j;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

__global__ void nn_empty_kernel() {}

}  // namespace

// Launches K3 on `stream`, the refs split into S slices (1..8), and returns
// the launch's cudaError_t (0 on success). Pointers are device pointers to
// contiguous tensors of the shapes noted on the kernel; the caller allocates
// the outputs.
extern "C" int rivslam_nn_argmin_f32(const float* query, const float* ref,
                                     const uint8_t* mask, int32_t* idx_out,
                                     float* d2_out, int B, int N, int M, int S,
                                     void* stream) {
  return nnscan::launch_split(nn_argmin_kernel, B, N, S, stream, query, ref, mask, idx_out,
                              d2_out, N, M);
}

// An empty kernel on the same grid (S x query blocks x B, the S blocks of a
// query block as one cluster): the floor of such a launch, for the timing.
extern "C" int rivslam_nn_empty(int B, int N, int S, void* stream) {
  return nnscan::launch_split(nn_empty_kernel, B, N, S, stream);
}
