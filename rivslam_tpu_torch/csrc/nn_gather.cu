// K1: fused masked nearest-neighbour distance + tie-averaged feature gather,
// batched over registration problems, for Hopper (sm_90a).
//
// Replaces the TPU kernel rivslam_tpu/ops/pallas_nn.py:179-286
// (_gather_kernel under fused_gather_pallas), the correspondence step of every
// LM iteration of frontend/apdgicp_fast.register_fast with
// use_pallas_correspondence=True.
//
// Contract (per problem b, query i):
//   d2[b, i]   = min over valid targets j of |q|^2 + |r_j|^2 - 2 q.r_j,
//                or 1e30 when problem b has no valid target;
//   g[b, :, i] = the mean of feats_t[b, :, j] over every valid j whose
//                distance equals that minimum exactly (zeros when none).
// The TPU kernel finds this set tile by tile (targets equal to the tile's
// minimum, summed across tiles whose minima are equal); that is exactly the
// set of targets at the global minimum, which one running minimum with a tie
// count finds too, whatever the tiling.
// Exact ties are AVERAGED, as in the TPU kernel; the flag-off XLA path
// (apdgicp_fast.py:278-289) takes the first index instead. On real scans an
// exact f32 tie needs duplicate target points, so the two agree in practice.
//
// Numerics. The distance keeps K1's expanded form
//     d2 = (|q|^2 + |r|^2) - 2 (qx rx + qy ry + qz rz)
// and every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no
// FMA contraction), in the same order as the plain twin
// (ops/nn_gather.fused_gather_plain). The two therefore produce bitwise equal
// distances, so they pick the same winner and the same ties. Masked targets
// carry a NaN norm: every comparison with NaN is false, so they never win
// and never tie. Do not build this file with --use_fast_math.
//
// What bounds it on an H100. At B=256, N=M=1024 the scan visits 2.7e8
// (query, target) pairs at 8 float32 operations each (2.1e9 operations,
// 32 us at 67 TFLOP/s of non-tensor-core float32), while the bytes it must
// move (inputs once, outputs once) are about 26 MB (8 us at 3.35 TB/s): it
// is bound by operations. The design spends nothing else per pair:
//   - one thread per query keeps (best, first index, tie count) in
//     registers; a block of 128 queries walks the target in tiles staged in
//     shared memory as float4 (x, y, z, |r|^2 or NaN), read as a broadcast;
//   - features are not touched in the scan at all. After it, a thread with
//     one winner reads its 9 features once; a thread with an exact tie (rare)
//     rescans the target from global memory and sums the tied features.
// Tensor-core cross terms, TMA and warp specialisation are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kTile = 512;     // targets staged per shared-memory tile
constexpr float kBig = 1e30f;

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Same operation order as fused_gather_plain; see the note above.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float qn,
                                        float rx, float ry, float rz, float rn) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, rx), __fmul_rn(qy, ry)), __fmul_rn(qz, rz));
  return __fsub_rn(__fadd_rn(qn, rn), __fmul_rn(2.0f, cross));
}

__global__ void __launch_bounds__(kThreads)
nn_gather_kernel(const float* __restrict__ query,     // [B, N, 3]
                 const float* __restrict__ ref,       // [B, M, 3]
                 const uint8_t* __restrict__ mask,    // [B, M] (bool)
                 const float* __restrict__ feats_t,   // [B, F, M]
                 float* __restrict__ d2_out,          // [B, N]
                 float* __restrict__ g_out,           // [B, F, N]
                 int N, int M, int F) {
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
  int best_j = -1;
  int count = 0;

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
        count = 1;
      } else if (d == best) {
        ++count;
      }
    }
  }
  if (!live) return;

  d2_out[(size_t)b * N + i] = best;
  const float* f = feats_t + (size_t)b * F * M;
  float* g = g_out + (size_t)b * F * N + i;
  if (count <= 1) {
    for (int k = 0; k < F; ++k) g[(size_t)k * N] = count ? f[(size_t)k * M + best_j] : 0.0f;
    return;
  }
  // Exact tie: sum the features of every target at the minimum distance and
  // divide (a true division, as the plain twin does).
  for (int k = 0; k < F; ++k) {
    float acc = 0.0f;
    for (int j = best_j; j < M; ++j) {
      if (!m[j]) continue;
      const float rx = r[j * 3 + 0], ry = r[j * 3 + 1], rz = r[j * 3 + 2];
      if (sqdist(qx, qy, qz, qn, rx, ry, rz, norm2(rx, ry, rz)) == best)
        acc += f[(size_t)k * M + j];
    }
    g[(size_t)k * N] = acc / (float)count;
  }
}

}  // namespace

// Launches K1 on `stream` and returns the launch's cudaError_t (0 on
// success). Pointers are device pointers to contiguous tensors of the shapes
// noted on the kernel; the caller allocates the outputs.
extern "C" int rivslam_nn_gather_f32(const float* query, const float* ref,
                                     const uint8_t* mask, const float* feats_t,
                                     float* d2_out, float* g_out, int B, int N,
                                     int M, int F, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  nn_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      query, ref, mask, feats_t, d2_out, g_out, N, M, F);
  return (int)cudaGetLastError();
}
