// K3: exact masked 1-nearest-neighbour search (first-index argmin and its
// squared distance), batched over problems, for Hopper (sm_90a).
//
// Replaces the TPU kernel rivslam_tpu/ops/pallas_nn.py:29-61 (_nn_kernel
// under nearest_neighbor_pallas, :289-324). On the per-frame engine it is
// the nearest-neighbour pass of the window backend's edge-information
// fitness (factors/infomat.fitness_score, once per frame).
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
// Numerics. The distance is K1's (csrc/nn_gather.cu): the expanded form
//     d2 = (|q|^2 + |r|^2) - 2 (qx rx + qy ry + qz rz)
// with every product and sum rounded on its own (__fmul_rn/__fadd_rn, no
// FMA contraction), in the order of the plain twin
// (ops/nn_argmin.nearest_neighbor_plain), so the two agree bitwise on d2
// and on the winner. A masked ref carries a NaN norm: every comparison with
// NaN is false, so it never wins. Do not build with --use_fast_math.
//
// What bounds it on an H100. At the engine's shape (B=1, N=M=1024) the scan
// visits 1.0e6 pairs at 8 float32 operations each (8.4e6 operations, 0.13 us
// at 67 TFLOP/s of non-tensor-core float32) and moves about 25 KB; at B=256
// it is 2.1e9 operations (32 us) against 6.6 MB: bound by operations. The
// design is K1's scan without the gather: one thread per query keeps
// (best, first index) in registers; a block of kThreads queries walks the
// refs in tiles staged in shared memory as float4 (x, y, z, |r|^2 or NaN),
// read as a broadcast. At B=1 only N/kThreads blocks exist, far fewer than
// the card's 132 SMs: splitting the refs across blocks (a second reduction
// pass), tensor-core cross terms and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // queries per block
constexpr int kTile = 512;    // refs staged per shared-memory tile
constexpr float kBig = 1e30f;

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Same operation order as nearest_neighbor_plain; see the note above.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float qn,
                                        float rx, float ry, float rz, float rn) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, rx), __fmul_rn(qy, ry)), __fmul_rn(qz, rz));
  return __fsub_rn(__fadd_rn(qn, rn), __fmul_rn(2.0f, cross));
}

__global__ void __launch_bounds__(kThreads)
nn_argmin_kernel(const float* __restrict__ query,   // [B, N, 3]
                 const float* __restrict__ ref,     // [B, M, 3]
                 const uint8_t* __restrict__ mask,  // [B, M] (bool)
                 int32_t* __restrict__ idx_out,     // [B, N]
                 float* __restrict__ d2_out,        // [B, N]
                 int N, int M) {
  __shared__ float4 tile[kTile];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < N;
  const float* q = query + ((size_t)b * N + (live ? i : 0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float qn = norm2(qx, qy, qz);
  const float* r = ref + (size_t)b * M * 3;
  const uint8_t* m = mask + (size_t)b * M;
  const float nan = __int_as_float(0x7fffffff);

  float best = kBig;
  int best_j = 0;

  for (int start = 0; start < M; start += kTile) {
    const int n = min(kTile, M - start);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int j = start + t;
      const float x = r[j * 3 + 0], y = r[j * 3 + 1], z = r[j * 3 + 2];
      tile[t] = make_float4(x, y, z, m[j] ? norm2(x, y, z) : nan);
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      const float4 p = tile[t];
      const float d = sqdist(qx, qy, qz, qn, p.x, p.y, p.z, p.w);
      if (d < best) {
        best = d;
        best_j = start + t;
      }
    }
  }
  if (!live) return;
  d2_out[(size_t)b * N + i] = best;
  idx_out[(size_t)b * N + i] = best_j;
}

}  // namespace

// Launches K3 on `stream` and returns the launch's cudaError_t (0 on
// success). Pointers are device pointers to contiguous tensors of the shapes
// noted on the kernel; the caller allocates the outputs.
extern "C" int rivslam_nn_argmin_f32(const float* query, const float* ref,
                                     const uint8_t* mask, int32_t* idx_out,
                                     float* d2_out, int B, int N, int M,
                                     void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  nn_argmin_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      query, ref, mask, idx_out, d2_out, N, M);
  return (int)cudaGetLastError();
}
