// K2: fused correspondence -- exact masked 1-nearest-neighbour search (first
// index) plus a gather of the winner's feature row, batched over problems,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel rivslam_tpu/ops/pallas_nn.py:74-128 (_corr_kernel
// under fused_correspondence_pallas, :131-170). In the port it is the
// correspondence step of the exact registration
// (frontend/apdgicp._correspondences): it gathers each transformed source
// point's nearest target xyz and covariance in one pass.
//
// Contract (per problem b, query i):
//   d2[b, i]   = min over valid refs j of |q|^2 + |r_j|^2 - 2 q.r_j
//                (unclamped: it may be slightly negative), or 1e30 when
//                problem b has no valid ref;
//   idx[b, i]  = the FIRST j reaching that minimum, or 0 when there is none;
//   g[b, i, :] = feats[b, idx[b, i], :] exactly, or zeros when there is none.
// The scan is K3's (csrc/nn_scan.cuh): refs in index order with a strict
// "<", which picks the TPU kernel's winner (first index within a 512-ref
// tile, strict "<" across tiles) whatever the tiling. The TPU kernel gathers
// with a one-hot matmul per tile; this kernel reads the winning row directly
// once the scan is done, which equals it for finite features. Valid refs are
// taken to be finite.
//
// What bounds it on an H100. As K3 (csrc/nn_argmin.cu): instructions at
// B=256 (11 a (query, valid ref) pair, 0.088 ms at N=M=1024 with every ref
// valid, against about 31 MB of traffic with F=12, 0.009 ms); latency at the
// exact engine's B=1.
//
// Design: K3's compacted, split scan (csrc/nn_scan.cuh; S slices from
// ops/nn_corr.split_for), then the gather: each block of the cluster takes
// its share of the query block's rows (with S = 1, all of them), puts their
// winners in shared memory and copies the rows of F floats cooperatively, so
// consecutive threads write consecutive floats of g.

#include "nn_scan.cuh"

namespace {

using nnscan::kBig;
using nnscan::kThreads;

// Rows [q0, q0 + nq) of the query block: their winners are in win.
__device__ void gather_rows(const int* win, const float* __restrict__ fb,
                            float* __restrict__ gb, int q0, int nq, int F) {
  for (int k = threadIdx.x; k < nq * F; k += kThreads) {
    const int row = q0 + k / F;
    const int j = win[row];
    gb[(size_t)row * F + (k % F)] = j >= 0 ? fb[(size_t)j * F + (k % F)] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
nn_corr_kernel(const float* __restrict__ query,   // [B, N, 3]
               const float* __restrict__ ref,     // [B, M, 3]
               const uint8_t* __restrict__ mask,  // [B, M] (bool)
               const float* __restrict__ feats,   // [B, M, F]
               int32_t* __restrict__ idx_out,     // [B, N]
               float* __restrict__ d2_out,        // [B, N]
               float* __restrict__ g_out,         // [B, N, F]
               int N, int M, int F) {
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

  const float* fb = feats + (size_t)b * M * F;
  float* gb = g_out + ((size_t)b * N + i0) * F;
  const int live_rows = min(kThreads, N - i0);
  if (S == 1) {
    // a query updates its minimum only from a valid ref below 1e30, exactly
    // when the TPU kernel's gathered row replaces its zero initial value
    sh.win[threadIdx.x] = best < kBig ? best_j : -1;
    if (live) {
      d2_out[(size_t)b * N + i] = best;
      idx_out[(size_t)b * N + i] = best_j;
    }
    __syncthreads();
    gather_rows(sh.win, fb, gb, 0, live_rows, F);
    return;
  }
  sh.part_d[threadIdx.x] = best;
  sh.part_j[threadIdx.x] = best_j;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();  // every slice's partials are in
  // block s writes and gathers queries [q0, q0 + nq) of the query block
  const int q0 = s * kThreads / S, nq = (s + 1) * kThreads / S - q0;
  const int qi = q0 + (int)threadIdx.x;
  if ((int)threadIdx.x < nq) {
    float d;
    int j;
    nnscan::combine(sh, S, qi, d, j);
    sh.win[qi] = d < kBig ? j : -1;
    if (i0 + qi < N) {
      d2_out[(size_t)b * N + i0 + qi] = d;
      idx_out[(size_t)b * N + i0 + qi] = j;
    }
  }
  __syncthreads();
  gather_rows(sh.win, fb, gb, q0, max(min(nq, live_rows - q0), 0), F);
  cluster.sync();  // no block leaves while another reads its partials
}

}  // namespace

// Launches K2 on `stream`, the refs split into S slices (1..8), and returns
// the launch's cudaError_t (0 on success). Pointers are device pointers to
// contiguous tensors of the shapes noted on the kernel; the caller allocates
// the outputs.
extern "C" int rivslam_nn_corr_f32(const float* query, const float* ref,
                                   const uint8_t* mask, const float* feats,
                                   int32_t* idx_out, float* d2_out, float* g_out,
                                   int B, int N, int M, int F, int S, void* stream) {
  return nnscan::launch_split(nn_corr_kernel, B, N, S, stream, query, ref, mask, feats, idx_out,
                              d2_out, g_out, N, M, F);
}
