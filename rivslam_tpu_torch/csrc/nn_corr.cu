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
// The scan is K3's (csrc/nn_argmin.cu), operation for operation: refs in
// index order with a strict "<", which picks the TPU kernel's winner
// (first index within a 512-ref tile, strict "<" across tiles) whatever the
// tiling. The TPU kernel gathers with a one-hot matmul per tile; this kernel
// reads the winning row directly once the scan is done, which equals it for
// finite features. Valid refs are taken to be finite.
//
// Numerics. Every product and sum of the distance is rounded on its own
// (__fmul_rn/__fadd_rn, no FMA contraction), in the order of the plain twin
// (ops/nn_corr.fused_correspondence_plain), so the two agree bitwise on d2,
// idx and g. A masked ref carries a NaN norm: every comparison with NaN is
// false, so it never wins. Do not build with --use_fast_math.
//
// What bounds it on an H100. At B=256, N=M=1024 the scan visits 2.7e8
// pairs at 8 float32 operations each (2.1e9 operations, 32 us at 67 TFLOP/s
// of non-tensor-core float32) against about 31 MB of inputs and outputs
// with F=12 (9 us at 3.35 TB/s): bound by operations. The design is K3's
// scan: one thread per query keeps (best, first index) in registers; a
// block of kThreads queries walks the refs in tiles staged in shared memory
// as float4 (x, y, z, |r|^2 or NaN), read as a broadcast. The gather comes
// after the scan: the block's winners go to shared memory, and the block
// copies its kThreads rows of F floats cooperatively, so consecutive
// threads write consecutive floats of g.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // queries per block
constexpr int kTile = 512;    // refs staged per shared-memory tile
constexpr float kBig = 1e30f;

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

__global__ void __launch_bounds__(kThreads)
nn_corr_kernel(const float* __restrict__ query,   // [B, N, 3]
               const float* __restrict__ ref,     // [B, M, 3]
               const uint8_t* __restrict__ mask,  // [B, M] (bool)
               const float* __restrict__ feats,   // [B, M, F]
               int32_t* __restrict__ idx_out,     // [B, N]
               float* __restrict__ d2_out,        // [B, N]
               float* __restrict__ g_out,         // [B, N, F]
               int N, int M, int F) {
  __shared__ float4 tile[kTile];
  __shared__ int winner[kThreads];  // the block's winning ref rows, -1: none

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
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
  // a query updates its minimum only from a valid ref below 1e30, exactly
  // when the TPU kernel's gathered row replaces its zero initial value
  winner[threadIdx.x] = best < kBig ? best_j : -1;
  if (live) {
    d2_out[(size_t)b * N + i] = best;
    idx_out[(size_t)b * N + i] = best_j;
  }
  __syncthreads();

  const int nq = min(kThreads, N - i0);
  const float* fb = feats + (size_t)b * M * F;
  float* gb = g_out + ((size_t)b * N + i0) * F;
  for (int k = threadIdx.x; k < nq * F; k += kThreads) {
    const int row = k / F;
    const int j = winner[row];
    gb[k] = j >= 0 ? fb[(size_t)j * F + (k - row * F)] : 0.0f;
  }
}

}  // namespace

// Launches K2 on `stream` and returns the launch's cudaError_t (0 on
// success). Pointers are device pointers to contiguous tensors of the shapes
// noted on the kernel; the caller allocates the outputs.
extern "C" int rivslam_nn_corr_f32(const float* query, const float* ref,
                                   const uint8_t* mask, const float* feats,
                                   int32_t* idx_out, float* d2_out, float* g_out,
                                   int B, int N, int M, int F, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  nn_corr_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      query, ref, mask, feats, idx_out, d2_out, g_out, N, M, F);
  return (int)cudaGetLastError();
}
