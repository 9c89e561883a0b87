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
//                distance equals that minimum exactly (zeros when none):
//                the features summed in ascending index order, then divided
//                by the count.
// The TPU kernel finds this set tile by tile (targets equal to the tile's
// minimum, summed across tiles whose minima are equal); that is exactly the
// set of targets at the global minimum. Exact ties are AVERAGED, as in the
// TPU kernel; the flag-off XLA path (apdgicp_fast.py:278-289) takes the
// first index instead.
//
// Numerics. The distance keeps the expanded form
//     d2 = (|q|^2 + |r|^2) - 2 (qx rx + qy ry + qz rz)
// and every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no
// FMA contraction), in the same order as the plain twin
// (ops/nn_gather.fused_gather_plain). The two therefore produce bitwise equal
// distances, so they pick the same winner and the same ties; the gathered
// features are bitwise equal wherever the order of the tie sum cannot matter
// (one winner, or a tie of two). Masked targets carry a NaN norm: every
// comparison with NaN is false, so they never win and never tie. Do not
// build this file with --use_fast_math.
//
// What bounds it on an H100. At B=256, N=M=1024 the scan visits 2.7e8
// (query, target) pairs. Each costs 8 unfused float32 instructions for the
// distance plus a compare and two selects for the running minimum (11), and
// the card issues SMs x 128 thread-instructions a clock (3.35e13 a second at
// 1980 MHz): 0.088 ms. The bytes it must move (inputs once, outputs once)
// are about 27 MB, 0.008 ms: it is bound by instructions, and every extra
// instruction per pair in the scan loop costs time in proportion.
//
// Design (the A/B is chip_smoke.py phase 12, the times in PERF.md, NVIDIA
// H100 80GB HBM3 at 700 W).
//   - The scan is K2's loop (csrc/nn_corr.cu), branch-free: each query keeps
//     (best, first index) with a strict "<", and a second index that takes
//     every target with d <= best: a tie is first != last. Targets are
//     staged 512 at a time in shared memory as float4 (x, y, z, |r|^2 or
//     NaN) and read as a broadcast. A block holds kThreads threads of kQpt
//     queries each; one float4 read feeds kQpt distances.
//   - A query without a tie reads its winner's F features once.
//   - Tied queries leave the scan's critical path and are resolved one warp
//     per query by the block's own warps after its scan: the lanes test 32
//     consecutive targets at a time from the first winner on, with the same
//     rounded arithmetic, __ballot_sync gives the tied indices in index
//     order, and lane k sums feature k over them in that order (a serial sum
//     per feature), then divides by the count.
//   - Two instantiations are built, and the wrapper picks by the grid
//     (ops/nn_gather.variant_for): 128 threads of two queries while every SM
//     still gets a block (B=256: 0.155-0.157 ms), else 64 threads of one
//     (B=1, N=M=1024: the grid is 16 blocks for 132 SMs and each thread's
//     serial scan is the time, 18 us).
//   - Designs that lost the A/B and were removed (their measured times):
//     a tie flag set by d == best and cleared by d < best, one instruction
//     more a pair (0.170 against 0.157 ms at B=256); a second kernel of warps
//     spread over the card, fed a list of tied queries the scan appends to
//     (0.18-0.20 against 0.16-0.17 ms at B=256, 26-54 against 18-50 us at
//     B=1: the memset and the second launch cost more than the rare ties);
//     other block shapes at B=256 (64 threads of two: 0.157-0.162 ms; one a
//     thread: 0.161-0.165; four: 0.160) and at B=1 (two a thread: 28 us,
//     four: 48 us).
//   - The scan-match inputs have ~7.6e-5 exact ties (20 of 262,144
//     queries, all two-way); the first design rescanned the target from global
//     memory once per feature for each of them with its warp waiting
//     (0.67 ms). The tail was not the whole gap: with the ties in the block
//     and the flag form, K1 still took 1.27x K2, the cost of its bookkeeping
//     instructions.
// Tensor cores stay out: TF32 would lose the cancellation headroom the
// expanded distance needs, and the no-FMA rounding must hold. cp.async or
// TMA staging of the target tiles is not tried: the scan is bound by
// instructions, not by the tile loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;  // targets staged per shared-memory tile
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

// One warp resolves one tied query: the mean of the features of every valid
// target at distance `best`, from the first winner j0 on, summed in
// ascending index order by lane k for feature k.
__device__ void resolve_tie(const float* __restrict__ q3, const float* __restrict__ r,
                            const uint8_t* __restrict__ m, const float* __restrict__ f,
                            float* __restrict__ g, float best, int j0, int M, int N,
                            int F, int lane) {
  const float qx = q3[0], qy = q3[1], qz = q3[2];
  const float qn = norm2(qx, qy, qz);
  for (int k0 = 0; k0 < F; k0 += 32) {
    const int k = k0 + lane;
    float acc = 0.0f;
    int count = 0;
    for (int base = j0; base < M; base += 32) {
      const int j = base + lane;
      bool hit = false;
      if (j < M && m[j]) {
        const float rx = r[j * 3 + 0], ry = r[j * 3 + 1], rz = r[j * 3 + 2];
        hit = sqdist(qx, qy, qz, qn, rx, ry, rz, norm2(rx, ry, rz)) == best;
      }
      unsigned bal = __ballot_sync(0xffffffffu, hit);
      count += __popc(bal);
      while (bal) {
        const int l = __ffs(bal) - 1;
        bal &= bal - 1;
        if (k < F) acc = __fadd_rn(acc, f[(size_t)k * M + base + l]);
      }
    }
    if (k < F) g[(size_t)k * N] = __fdiv_rn(acc, (float)count);
  }
}

template <int kThreads, int kQpt>
__global__ void __launch_bounds__(kThreads)
nn_gather_kernel(const float* __restrict__ query,     // [B, N, 3]
                 const float* __restrict__ ref,       // [B, M, 3]
                 const uint8_t* __restrict__ mask,    // [B, M] (bool)
                 const float* __restrict__ feats_t,   // [B, F, M]
                 float* __restrict__ d2_out,          // [B, N]
                 float* __restrict__ g_out,           // [B, F, N]
                 int N, int M, int F) {
  constexpr int kQueries = kThreads * kQpt;
  __shared__ float4 tile[kTile];
  __shared__ int tied[kQueries];  // block-local query slots with a tie
  __shared__ float tied_best[kQueries];
  __shared__ int tied_j0[kQueries];
  __shared__ int n_tied;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kQueries;
  const float* r = ref + (size_t)b * M * 3;
  const uint8_t* m = mask + (size_t)b * M;
  const float nan = __int_as_float(0x7fffffff);
  if (threadIdx.x == 0) n_tied = 0;

  float qx[kQpt], qy[kQpt], qz[kQpt], qn[kQpt], best[kQpt];
  int best_j[kQpt], last_j[kQpt];
#pragma unroll
  for (int s = 0; s < kQpt; ++s) {
    const int i = i0 + s * kThreads + threadIdx.x;
    const float* q = query + ((size_t)b * N + (i < N ? i : 0)) * 3;
    qx[s] = q[0];
    qy[s] = q[1];
    qz[s] = q[2];
    qn[s] = norm2(qx[s], qy[s], qz[s]);
    best[s] = kBig;
    best_j[s] = -1;
    last_j[s] = -1;
  }

  for (int start = 0; start < M; start += kTile) {
    const int n = min(kTile, M - start);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int j = start + t;
      const float x = r[j * 3 + 0], y = r[j * 3 + 1], z = r[j * 3 + 2];
      tile[t] = make_float4(x, y, z, m[j] ? norm2(x, y, z) : nan);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float4 p = tile[t];
      const int j = start + t;
#pragma unroll
      for (int s = 0; s < kQpt; ++s) {
        const float d = sqdist(qx[s], qy[s], qz[s], qn[s], p.x, p.y, p.z, p.w);
        const bool lt = d < best[s];
        last_j[s] = d <= best[s] ? j : last_j[s];
        best_j[s] = lt ? j : best_j[s];
        best[s] = lt ? d : best[s];
      }
    }
  }

  const float* f = feats_t + (size_t)b * F * M;
#pragma unroll
  for (int s = 0; s < kQpt; ++s) {
    const int local = s * kThreads + threadIdx.x;
    const int i = i0 + local;
    if (i >= N) continue;
    d2_out[(size_t)b * N + i] = best[s];
    float* g = g_out + (size_t)b * F * N + i;
    if (last_j[s] == best_j[s] || best_j[s] < 0) {  // one winner, or none
      for (int k = 0; k < F; ++k)
        g[(size_t)k * N] = best_j[s] >= 0 ? f[(size_t)k * M + best_j[s]] : 0.0f;
    } else {
      const int e = atomicAdd(&n_tied, 1);
      tied[e] = local;
      tied_best[e] = best[s];
      tied_j0[e] = best_j[s];
    }
  }

  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < n_tied; e += kThreads / 32) {
    const int i = i0 + tied[e];
    resolve_tie(query + ((size_t)b * N + i) * 3, r, m, f, g_out + (size_t)b * F * N + i,
                tied_best[e], tied_j0[e], M, N, F, lane);
  }
}

template <int kThreads, int kQpt>
int launch(const float* query, const float* ref, const uint8_t* mask, const float* feats_t,
           float* d2_out, float* g_out, int B, int N, int M, int F, cudaStream_t stream) {
  const dim3 grid((N + kThreads * kQpt - 1) / (kThreads * kQpt), B);
  nn_gather_kernel<kThreads, kQpt><<<grid, kThreads, 0, stream>>>(
      query, ref, mask, feats_t, d2_out, g_out, N, M, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream` and returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for a block shape that is not built).
// Pointers are device pointers to contiguous tensors of the shapes noted on
// the kernel; the caller allocates the outputs. The block shape: 128
// threads of two queries each, or 64 threads of one.
extern "C" int rivslam_nn_gather_f32(const float* query, const float* ref,
                                     const uint8_t* mask, const float* feats_t,
                                     float* d2_out, float* g_out, int B, int N, int M,
                                     int F, int threads, int qpt, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (threads == 128 && qpt == 2)
    return launch<128, 2>(query, ref, mask, feats_t, d2_out, g_out, B, N, M, F, s);
  if (threads == 64 && qpt == 1)
    return launch<64, 1>(query, ref, mask, feats_t, d2_out, g_out, B, N, M, F, s);
  return (int)cudaErrorInvalidValue;
}
