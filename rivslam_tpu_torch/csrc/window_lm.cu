// The sliding window's whole LM (or GN) solve in one launch: one thread
// block per window, every intermediate in shared memory.
//
// Replaces no TPU kernel. The JAX package runs the solve as nested
// lax.while_loops that XLA compiles (rivslam_tpu/solver/window.py,
// solve_window); the port ran one outer iteration as a CUDA graph of ~5,800
// small kernels (jacfwd under vmap, dense solves) and read a done flag on the
// host after each. The problem is tiny: W*15 = 90 dimensions at W = 6, one
// damped factorization ~0.25 MFLOP. So the solve is bound by latency, the
// chain of dependent steps (up to 8 outer iterations, each a linearization
// and up to 8 lambda tries, each a banded Cholesky of N = 15 W columns and
// two triangular solves), not by operations or bytes. The design keeps that
// chain inside one block: no launch, no host read and no round trip through
// device memory between steps, and a try or an iteration whose result is
// already known is not run.
//
// Per window, in the order of the plain twin (solver/window.py,
// solve_window / window_iteration):
//   1. once: the whitening factors (Cholesky of each slot's rel_info,
//      prior_info and preint_info plus 1e-12 I, NaN where it fails; square
//      roots of the diagonal informations) and the block masks;
//   2. each outer iteration: the 7 blocks' robust weights at x (IRLS,
//      frozen for the iteration); each slot's 33 whitened residuals and
//      their 33 x 30 Jacobian at delta = 0 of the pair's retraction, by
//      forward-mode dual numbers, one thread per (slot, tangent direction),
//      so every branch (small angle, near pi) is taken as the twin's jacfwd
//      takes it; the block-tridiagonal H (lower band) and g; then the lambda
//      search (LM) or the damped Gauss-Newton step (GN) with the twin's
//      accept, lambda and stopping rules; the first accepted try ends the
//      search, and a done iteration ends the solve;
//   3. the final chi2 at the final state, its robust weights recomputed.
// The damped system keeps H's pattern: blocks (i, i-1), (i, i), so a row of
// the lower triangle holds at most 30 entries (BAND). Its Cholesky is the
// dense one with the exact zeros skipped; a failed factorization gives NaN,
// which the accept test rejects. Jacobi equilibration as _damped_solve.
// Arithmetic in the window's dtype (float or double), no tensor cores.
//
// Slot 0's factors are masked, so its Jacobian is exact zeros while its
// residuals are finite; the twin's wrap of slot 0's previous-frame blocks
// onto block W-1 therefore adds zeros, and the band leaves it out.
//
// Inputs: the pointers of In (every field [B, W, ...] contiguous, in the
// dtype, masks as bytes); outputs: the state (R, p, v, bg, ba) [B, W, ...],
// chi2 [B], and counts [B, 2] int32 (outer iterations, lambda tries).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RES = 33;    // residual rows of a slot
constexpr int DIM = 15;    // tangent dims of a slot: theta, p, v, bg, ba
constexpr int PAIR = 30;   // tangent dims of the frame pair a slot couples
constexpr int BAND = 30;   // stored entries of a row of H's lower band
constexpr int BLOCKS = 7;  // factor blocks of a slot
constexpr int INNER_TRIES = 8;
constexpr int NSTATE = 21;  // R (9), p, v, bg, ba
constexpr int NFAC = 102;   // a slot's measurements (the F_ layout)
constexpr int NWH = 157;    // a slot's whitening factors (the WH_ layout)
// shared-memory elements a slot takes: x, x_new, factors, whitening, masks,
// weights, J, r0, H and its damped copy (band), g, d, s, y, chi2 pieces
constexpr int SLOT_ELEMS = 2 * NSTATE + NFAC + NWH + 2 * BLOCKS + RES * PAIR + RES
                           + 2 * DIM * BAND + 4 * DIM + BLOCKS;
constexpr int SMEM_LIMIT = 232448;   // a block's shared memory on sm_90
constexpr int STATIC_RESERVE = 1024;  // the kernel's static shared scalars

constexpr int max_window(int elem) { return (SMEM_LIMIT - STATIC_RESERVE) / (SLOT_ELEMS * elem); }

// a slot's measurements
enum {
  F_RELR = 0, F_RELP = 9, F_PRIR = 12, F_PRIP = 21, F_DT = 24, F_DR = 25, F_DV = 34, F_DP = 37,
  F_DRDBG = 40, F_DVDBG = 49, F_DVDBA = 58, F_DPDBG = 67, F_DPDBA = 76, F_PBG = 85, F_PBA = 88,
  F_VEL = 91, F_PNODE = 94, F_PMEAS = 98
};
// a slot's whitening factors: Cholesky L of rel_info, prior_info, preint_info; sqrt of the diagonals
enum { WH_REL = 0, WH_PRIOR = 36, WH_PRE = 72, WH_VEL = 153, WH_PLANE = 156 };

enum In {
  I_R, I_P, I_V, I_BG, I_BA, I_FRAME_MASK, I_REL_R, I_REL_P, I_REL_INFO, I_PRIOR_R, I_PRIOR_P,
  I_PRIOR_INFO, I_DT, I_DR, I_DV, I_DP, I_DR_DBG, I_DV_DBG, I_DV_DBA, I_DP_DBG, I_DP_DBA, I_PRE_BG,
  I_PRE_BA, I_PREINT_INFO, I_VEL_MEAS, I_VEL_INFO, I_PLANE_NODE, I_PLANE_MEAS, I_PLANE_INFO,
  I_PLANE_VALID, N_IN
};
enum Out { O_R, O_P, O_V, O_BG, O_BA, O_CHI2, O_COUNTS, N_OUT };

struct Params {
  const void* in[N_IN];
  void* out[N_OUT];
  double ksize[BLOCKS];  // robust kernel size of each block
  int kind[BLOCKS];      // robust kernel of each block (the wrapper's KERNELS order)
  double sqrt_bg, sqrt_ba, gravity, rel_tol;
  int gn, max_iters, W;
};

template <class T>
struct Ctl {  // the block's scalars, written by thread 0 between barriers
  T y0, lam, nu, eps, ynew, dmax, floor, denom, nrm2, dmaxd, y1;
  int iters, tries, done, accept, stop, success;
};

// ---- scalars: float and double, and forward-mode duals of them -------------

template <class T>
struct Dual {
  T v, d;
  __device__ Dual() {}
  __device__ Dual(T a) : v(a), d(T(0)) {}
  __device__ Dual(T a, T b) : v(a), d(b) {}
};

template <class S> struct Base { using type = S; };
template <class T> struct Base<Dual<T>> { using type = T; };

template <class T> __device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <class T> __device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <class T> __device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, a.d / b.v - b.d * q / b.v};
}
template <class T> __device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }
template <class T> __device__ __forceinline__ Dual<T> operator/(T a, Dual<T> b) {
  const T q = a / b.v;
  return {q, -(b.d * q) / b.v};
}

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ double val(double a) { return a; }
template <class T> __device__ __forceinline__ T val(Dual<T> a) { return a.v; }

__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float rsqrt_(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_(double a) { return rsqrt(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }
__device__ __forceinline__ float nan_(float) { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ double nan_(double) { return __longlong_as_double(0x7fffffffffffffffLL); }
__device__ __forceinline__ float inf_(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double inf_(double) { return __longlong_as_double(0x7ff0000000000000LL); }

// torch's jvp of each function
template <class T> __device__ __forceinline__ Dual<T> sqrt_(Dual<T> a) {
  const T r = sqrt_(a.v);
  return {r, a.d / (T(2) * r)};
}
template <class T> __device__ __forceinline__ Dual<T> sin_(Dual<T> a) { return {sin_(a.v), a.d * cos_(a.v)}; }
template <class T> __device__ __forceinline__ Dual<T> cos_(Dual<T> a) { return {cos_(a.v), a.d * -sin_(a.v)}; }
template <class T> __device__ __forceinline__ Dual<T> atan2_(Dual<T> y, Dual<T> x) {
  const T den = y.v * y.v + x.v * x.v;
  return {atan2_(y.v, x.v), y.d * x.v / den + x.d * -y.v / den};
}

// torch.clamp / clamp_min: NaN stays NaN; the derivative passes inside the range
template <class S, class T> __device__ __forceinline__ S clamp_(S x, T lo, T hi) {
  const T v = val(x);
  return v < lo ? S(lo) : (v > hi ? S(hi) : x);
}
template <class S, class T> __device__ __forceinline__ S clamp_min_(S x, T lo) { return val(x) < lo ? S(lo) : x; }
// torch.max / torch.maximum: NaN wins
template <class T> __device__ __forceinline__ T max_nan(T a, T b) { return (b > a || b != b) ? b : a; }

__device__ __forceinline__ float norm3(const float* x) { return sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]); }
__device__ __forceinline__ double norm3(const double* x) { return sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]); }
template <class T> __device__ __forceinline__ Dual<T> norm3(const Dual<T>* x) {
  const T n = sqrt_(x[0].v * x[0].v + x[1].v * x[1].v + x[2].v * x[2].v);
  const T t = x[0].v * x[0].d + x[1].v * x[1].d + x[2].v * x[2].d;
  return {n, n == T(0) ? T(0) : t / n};
}

// ---- 3x3 row-major algebra, any mix of scalars -------------------------------

template <class A, class B, class C> __device__ __forceinline__ void mm(const A* a, const B* b, C* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}
template <class A, class B> __device__ __forceinline__ void transpose(const A* a, B* b) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) b[3 * i + j] = a[3 * j + i];
}
template <class A, class B, class C> __device__ __forceinline__ void mv(const A* a, const B* x, C* y) {
  for (int i = 0; i < 3; ++i) y[i] = a[3 * i] * x[0] + a[3 * i + 1] * x[1] + a[3 * i + 2] * x[2];
}
template <class A, class B, class C> __device__ __forceinline__ void mtv(const A* a, const B* x, C* y) {
  for (int i = 0; i < 3; ++i) y[i] = a[i] * x[0] + a[3 + i] * x[1] + a[6 + i] * x[2];
}

// core/lie.py so3_exp: Rodrigues with Taylor terms below theta^2 = 1e-8
template <class S> __device__ void so3_exp(const S* w, S* R) {
  using T = typename Base<S>::type;
  const S x2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  S a, b;
  if (val(x2) < T(1e-8)) {
    a = T(1) - x2 / T(6);
    b = T(0.5) - x2 / T(24);
  } else {
    const S x = sqrt_(x2);
    a = sin_(x) / x;
    b = (T(1) - cos_(x)) / x2;
  }
  const S z(T(0));
  const S Wm[9] = {z, -w[2], w[1], w[2], z, -w[0], -w[1], w[0], z};
  S WW[9];
  mm(Wm, Wm, WW);
  for (int i = 0; i < 9; ++i) R[i] = ((i % 4 == 0) ? T(1) : T(0)) + a * Wm[i] + b * WW[i];
}

// core/lie.py so3_log: robust near 0 and pi
template <class S> __device__ void so3_log(const S* R, S* w) {
  using T = typename Base<S>::type;
  const S tr = R[0] + R[4] + R[8];
  const S c = clamp_((tr - T(1)) * T(0.5), T(-1), T(1));
  const S ws[3] = {T(0.5) * (R[7] - R[5]), T(0.5) * (R[2] - R[6]), T(0.5) * (R[3] - R[1])};
  const S s2 = ws[0] * ws[0] + ws[1] * ws[1] + ws[2] * ws[2];
  const bool small = val(s2) < T(1e-12);
  const S s = small ? S(T(1)) : sqrt_(s2);
  const S theta = atan2_(s, c);
  if (!(val(c) < T(-1.0 + 1e-11))) {
    const S scale = small ? T(1) + s2 / T(6) : theta / s;
    for (int i = 0; i < 3; ++i) w[i] = ws[i] * scale;
    return;
  }
  // near pi: the axis from the largest diagonal entry of (R + I) / 2
  S B[9];
  for (int i = 0; i < 9; ++i) B[i] = (R[i] + ((i % 4 == 0) ? T(1) : T(0))) / T(2);
  int k = 0;
  if (val(B[4]) > val(B[0])) k = 1;
  if (val(B[8]) > val(B[4 * k])) k = 2;
  const S col[3] = {B[k], B[3 + k], B[6 + k]};
  const S n = clamp_min_(norm3(col), T(1e-8));
  S axis[3];
  for (int i = 0; i < 3; ++i) axis[i] = col[i] / n;
  const T dot = val(axis[0]) * val(ws[0]) + val(axis[1]) * val(ws[1]) + val(axis[2]) * val(ws[2]);
  const S st = (dot < T(0) ? T(-1) : T(1)) * theta;
  for (int i = 0; i < 3; ++i) w[i] = axis[i] * st;
}

__device__ __forceinline__ int block_size(int k) { return (k == 2 || k == 3) ? 6 : (k == 4 ? 9 : 3); }
__device__ __forceinline__ int block_offset(int k) {
  return k < 2 ? 3 * k : (k < 4 ? 6 * k - 6 : (k == 4 ? 18 : 3 * k + 12));
}

// factors/residuals.py, block k of solver/window.py _slot_blocks: the raw
// residual of slot (xp = frame i-1, xc = frame i) with measurements f
template <class S, class T>
__device__ void block_residual(int k, const S* xp, const S* xc, const T* f, T grav, S* r) {
  switch (k) {
    case 0:  // bias_rw(bgp, bgc)
    case 1: {  // bias_rw(bap, bac)
      const int o = k == 0 ? 15 : 18;
      for (int i = 0; i < 3; ++i) r[i] = xc[o + i] - xp[o + i];
      return;
    }
    case 2: {  // relative_se3(Rc, pc, Rp, pp, rel_R, rel_p)
      T mt[9];
      S ct[9], a[9], m[9], dp[3], e[3];
      transpose(f + F_RELR, mt);
      transpose(xc, ct);
      mm(mt, ct, a);
      mm(a, xp, m);
      so3_log(m, r);
      for (int i = 0; i < 3; ++i) dp[i] = xp[9 + i] - xc[9 + i];
      mtv(xc, dp, e);
      for (int i = 0; i < 3; ++i) r[3 + i] = e[i] - f[F_RELP + i];
      return;
    }
    case 3: {  // pose_prior(Rc, pc, prior_R, prior_p)
      T mt[9];
      S m[9];
      transpose(f + F_PRIR, mt);
      mm(mt, xc, m);
      so3_log(m, r);
      for (int i = 0; i < 3; ++i) r[3 + i] = xc[9 + i] - f[F_PRIP + i];
      return;
    }
    case 4: {  // imu_preintegration(Rp, pp, vp, bgp, bap, Rc, pc, vc, preint)
      const T dt = f[F_DT];
      S dbg[3], dba[3], om[3], E[9], dR[9], t1[3], t2[3], dv[3], dpp[3];
      for (int i = 0; i < 3; ++i) {
        dbg[i] = xp[15 + i] - f[F_PBG + i];
        dba[i] = xp[18 + i] - f[F_PBA + i];
      }
      mv(f + F_DRDBG, dbg, om);
      so3_exp(om, E);
      mm(f + F_DR, E, dR);
      mv(f + F_DVDBG, dbg, t1);
      mv(f + F_DVDBA, dba, t2);
      for (int i = 0; i < 3; ++i) dv[i] = f[F_DV + i] + t1[i] + t2[i];
      mv(f + F_DPDBG, dbg, t1);
      mv(f + F_DPDBA, dba, t2);
      for (int i = 0; i < 3; ++i) dpp[i] = f[F_DP + i] + t1[i] + t2[i];
      S dRt[9], pt[9], a[9], m[9], u[3], q[3], e[3];
      transpose(dR, dRt);
      transpose(xp, pt);
      mm(dRt, pt, a);
      mm(a, xc, m);
      so3_log(m, r);
      const T g[3] = {T(0), T(0), grav};
      for (int i = 0; i < 3; ++i) {
        u[i] = xc[12 + i] - xp[12 + i] + g[i] * dt;
        q[i] = xc[9 + i] - xp[9 + i] - xp[12 + i] * dt + T(0.5) * g[i] * dt * dt;
      }
      mtv(xp, u, e);
      for (int i = 0; i < 3; ++i) r[3 + i] = e[i] - dv[i];
      mtv(xp, q, e);
      for (int i = 0; i < 3; ++i) r[6 + i] = e[i] - dpp[i];
      return;
    }
    case 5:  // velocity_prior(vc, vel_meas)
      for (int i = 0; i < 3; ++i) r[i] = xc[12 + i] - f[F_VEL + i];
      return;
    default: {  // se3_plane(Rc, pc, plane_node, plane_meas)
      const T* node = f + F_PNODE;
      const T* meas = f + F_PMEAS;
      S l[3];
      mtv(xc, node, l);
      const S ld = node[3] + (node[0] * xc[9] + node[1] * xc[10] + node[2] * xc[11]);
      const S nl = clamp_min_(norm3(l), T(1e-12));
      S ne[3];
      for (int i = 0; i < 3; ++i) ne[i] = l[i] / nl;
      const T nmn = clamp_min_(norm3(meas), T(1e-12));
      const T nx = meas[0] / nmn, ny = meas[1] / nmn, nz = meas[2] / nmn;
      const T a = T(-1) / (T(1) + clamp_min_(nz, T(-1.0 + 1e-6)));
      const T b = nx * ny * a;
      const T t1[3] = {T(1) + nx * nx * a, b, -nx};
      const T t2[3] = {b, T(1) + ny * ny * a, -ny};
      r[0] = t1[0] * ne[0] + t1[1] * ne[1] + t1[2] * ne[2];
      r[1] = t2[0] * ne[0] + t2[1] * ne[1] + t2[2] * ne[2];
      r[2] = ld - meas[3];
      return;
    }
  }
}

// whiten_cache / _apply_whiten: c * r for the diagonal factors, L^T r for the Cholesky ones
template <class S, class T>
__device__ void whiten(int k, const S* r, const T* wh, T sqrt_bg, T sqrt_ba, S* w) {
  const int n = block_size(k);
  if (k == 2 || k == 3 || k == 4) {
    const T* L = wh + (k == 2 ? WH_REL : (k == 3 ? WH_PRIOR : WH_PRE));
    for (int i = 0; i < n; ++i) {
      S acc = L[i] * r[0];
      for (int j = 1; j < n; ++j) acc = acc + L[j * n + i] * r[j];
      w[i] = acc;
    }
    return;
  }
  for (int i = 0; i < n; ++i) {
    const T c = k == 0 ? sqrt_bg : (k == 1 ? sqrt_ba : (k == 5 ? wh[WH_VEL + i] : wh[WH_PLANE]));
    w[i] = c * r[i];
  }
}

// factors/robust.py kernel_weight, by the wrapper's KERNELS order
template <class T> __device__ T robust_weight(int kind, double size, T chi2) {
  const T delta = T(size), d2 = T(size * size);
  switch (kind) {
    case 0: return T(1);
    case 1: return chi2 <= d2 ? T(1) : delta / sqrt_(clamp_min_(chi2, T(1e-30)));
    case 2: return T(1) / (T(1) + chi2 / d2);
    case 3: { const T q = d2 / (d2 + chi2); return q * q; }
    case 4: return exp_(-chi2 / d2);
    case 5: return T(1) / (T(1) + sqrt_(clamp_min_(chi2, T(1e-30))) / delta);
    case 6: { T q = T(2.0 * size) / (delta + chi2); q = q * q; return q > T(1) ? T(1) : q; }
    case 7: return chi2 <= d2 ? T(1) : d2 / clamp_min_(chi2, T(1e-30));
    case 8: { const T u = T(1) - chi2 / d2; return chi2 <= d2 ? u * u : T(0); }
    default: return T(1) / sqrt_(T(1) + chi2 / d2);
  }
}

// lower Cholesky of the n x n info + 1e-12 I in place; NaN everywhere when it fails
template <class T> __device__ void chol_small(T* a, int n) {
  for (int i = 0; i < n; ++i) a[i * n + i] = a[i * n + i] + T(1e-12);
  bool ok = true;
  for (int j = 0; j < n && ok; ++j) {
    T s = a[j * n + j];
    for (int k = 0; k < j; ++k) s -= a[j * n + k] * a[j * n + k];
    if (!(s > T(0))) {
      ok = false;
      break;
    }
    const T l = sqrt_(s);
    a[j * n + j] = l;
    for (int i = j + 1; i < n; ++i) {
      T t = a[i * n + j];
      for (int k = 0; k < j; ++k) t -= a[i * n + k] * a[j * n + k];
      a[i * n + j] = t / l;
    }
  }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      if (!ok) a[i * n + j] = nan_(T(0));
      else if (j > i) a[i * n + j] = T(0);
}

// H's lower band: row r keeps columns lo(r) .. r, lo(r) = 15 (block(r) - 1)
__device__ __forceinline__ int band_lo(int r) { return DIM * (r / DIM - 1); }
__device__ __forceinline__ int band(int r, int c) { return r * BAND + c - band_lo(r); }

// the chi2 of block k of slot w at state x: sum of (L^T r * sqrt(kw) * mask)^2,
// with kw frozen (fresh false) or recomputed at x (fresh true, stored)
template <class T>
__device__ T block_chi2(const Params& p, int w, int k, const T* x, const T* fac, const T* wh,
                        const T* msk, T* kw, bool fresh) {
  const int W = p.W;
  const T* xp = x + ((w + W - 1) % W) * NSTATE;
  const T* xc = x + w * NSTATE;
  T r[9], wv[9];
  block_residual(k, xp, xc, fac + w * NFAC, T(p.gravity), r);
  whiten(k, r, wh + w * NWH, T(p.sqrt_bg), T(p.sqrt_ba), wv);
  const int n = block_size(k);
  T kwt;
  if (fresh) {
    T chi = T(0);
    for (int i = 0; i < n; ++i) chi += wv[i] * wv[i];
    kwt = robust_weight(p.kind[k], p.ksize[k], chi);
    kw[w * BLOCKS + k] = kwt;
  } else {
    kwt = kw[w * BLOCKS + k];
  }
  const T q = sqrt_(kwt) * msk[w * BLOCKS + k];
  T acc = T(0);
  for (int i = 0; i < n; ++i) {
    const T e = wv[i] * q;
    acc += e * e;
  }
  return acc;
}

// slot w's 33 weighted whitened residuals at x and their derivative along
// tangent direction j of the pair (j < 15: frame i-1, else frame i), by
// dual numbers; the weights from the residuals' values, frozen (no
// derivative). Writes J's column j, and r0 and the weights for j = 0.
template <class T>
__device__ void linearize(const Params& p, int w, int j, const T* x, const T* fac, const T* wh,
                          const T* msk, T* kw, T* J, T* r0) {
  using D = Dual<T>;
  const int W = p.W;
  const T* sp = x + ((w + W - 1) % W) * NSTATE;
  const T* sc = x + w * NSTATE;
  D xp[NSTATE], xc[NSTATE];
  for (int i = 0; i < NSTATE; ++i) {
    xp[i] = D(sp[i]);
    xc[i] = D(sc[i]);
  }
  D* side = j < DIM ? xp : xc;
  const int m = j % DIM;
  if (m < 3) {  // R @ so3_exp(delta) at delta = 0 along e_m
    D om[3] = {D(T(0)), D(T(0)), D(T(0))};
    om[m].d = T(1);
    D E[9], Rn[9];
    so3_exp(om, E);
    mm(side, E, Rn);
    for (int i = 0; i < 9; ++i) side[i] = Rn[i];
  } else {  // p, v, bg, ba + delta
    side[m + 6].d = T(1);
  }
  for (int k = 0; k < BLOCKS; ++k) {
    D r[9], wv[9];
    block_residual(k, xp, xc, fac + w * NFAC, T(p.gravity), r);
    whiten(k, r, wh + w * NWH, T(p.sqrt_bg), T(p.sqrt_ba), wv);
    const int n = block_size(k), o = block_offset(k);
    T chi = T(0);
    for (int i = 0; i < n; ++i) chi += wv[i].v * wv[i].v;
    const T kwt = robust_weight(p.kind[k], p.ksize[k], chi);
    const T q = sqrt_(kwt) * msk[w * BLOCKS + k];
    for (int i = 0; i < n; ++i) J[(w * RES + o + i) * PAIR + j] = wv[i].d * q;
    if (j == 0) {
      for (int i = 0; i < n; ++i) r0[w * RES + o + i] = wv[i].v * q;
      kw[w * BLOCKS + k] = kwt;
    }
  }
}

// entry (r, band column k) of H = J^T J, assembled block-tridiagonally:
// block (i, i) = Jc_i^T Jc_i + Jp_{i+1}^T Jp_{i+1}, block (i, i-1) = (Jp_i^T Jc_i)^T
template <class T> __device__ T hessian_entry(int W, int r, int k, const T* J) {
  const int i = r / DIM, a = r % DIM, col = band_lo(r) + k;
  if (col < 0 || col > r) return T(0);
  const T* Ji = J + i * RES * PAIR;
  T h = T(0);
  if (k >= DIM) {
    const int b = k - DIM;
    for (int q = 0; q < RES; ++q) h += Ji[q * PAIR + DIM + a] * Ji[q * PAIR + DIM + b];
    if (i + 1 < W) {
      const T* Jn = Ji + RES * PAIR;
      T h2 = T(0);
      for (int q = 0; q < RES; ++q) h2 += Jn[q * PAIR + a] * Jn[q * PAIR + b];
      h = h + h2;
    }
    return h;
  }
  for (int q = 0; q < RES; ++q) h += Ji[q * PAIR + k] * Ji[q * PAIR + DIM + a];
  return h;
}

template <class T> __device__ T gradient_entry(int W, int r, const T* J, const T* r0) {
  const int i = r / DIM, a = r % DIM;
  const T* Ji = J + i * RES * PAIR;
  const T* ri = r0 + i * RES;
  T gv = T(0);
  for (int q = 0; q < RES; ++q) gv += Ji[q * PAIR + DIM + a] * ri[q];
  if (i + 1 < W) {
    const T* Jn = Ji + RES * PAIR;
    const T* rn = ri + RES;
    T g2 = T(0);
    for (int q = 0; q < RES; ++q) g2 += Jn[q * PAIR + a] * rn[q];
    gv = gv + g2;
  }
  return gv;
}

// _damped_solve of (H + lam I) d = -g on the band: Jacobi scales, the
// banded Cholesky (the whole block, two barriers a column), the two
// triangular solves (warp 0); d NaN where the factorization fails
template <class T>
__device__ void damped_solve(Ctl<T>& c, T lam, int N, const T* H, const T* g, T* A, T* s, T* y, T* d) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    T mx = abs_(H[band(0, 0)] + lam);
    for (int r = 1; r < N; ++r) mx = max_nan(mx, abs_(H[band(r, r)] + lam));
    c.floor = T(1e-12) * mx + T(1e-30);
  }
  __syncthreads();
  for (int r = tid; r < N; r += THREADS) s[r] = rsqrt_(max_nan(abs_(H[band(r, r)] + lam), c.floor));
  __syncthreads();
  for (int e = tid; e < N * BAND; e += THREADS) {
    const int r = e / BAND, col = band_lo(r) + e % BAND;
    if (col >= 0 && col <= r) A[e] = (H[e] + (col == r ? lam : T(0))) * s[r] * s[col];
  }
  __syncthreads();
  bool failed = false;
  for (int j = 0; j < N; ++j) {
    const T ajj = A[band(j, j)];
    if (!(ajj > T(0))) {
      failed = true;
      break;
    }
    const T ljj = sqrt_(ajj);
    const int m = min(N - 1, DIM * (j / DIM + 2) - 1) - j;  // rows below j that reach column j
    if (tid < m) A[band(j + 1 + tid, j)] = A[band(j + 1 + tid, j)] / ljj;
    __syncthreads();
    if (tid == 0) A[band(j, j)] = ljj;
    for (int e = tid; e < m * (m + 1) / 2; e += THREADS) {
      int rr = int((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
      while (rr * (rr + 1) / 2 > e) --rr;
      while ((rr + 1) * (rr + 2) / 2 <= e) ++rr;
      const int r = j + 1 + rr, col = j + 1 + e - rr * (rr + 1) / 2;
      A[band(r, col)] -= A[band(r, j)] * A[band(col, j)];
    }
    __syncthreads();
  }
  if (failed) {
    for (int r = tid; r < N; r += THREADS) d[r] = nan_(T(0));
    __syncthreads();
    return;
  }
  if (tid < 32) {
    const int lane = tid;
    for (int r = lane; r < N; r += 32) y[r] = -g[r] * s[r];
    __syncwarp();
    for (int j = 0; j < N; ++j) {  // L z = y; z into d
      const T zj = y[j] / A[band(j, j)];
      const int m = min(N - 1, DIM * (j / DIM + 2) - 1) - j;
      if (lane < m) y[j + 1 + lane] -= A[band(j + 1 + lane, j)] * zj;
      if (lane == 0) d[j] = zj;
      __syncwarp();
    }
    for (int j = N - 1; j >= 0; --j) {  // L^T x = z; x into y
      const T xj = d[j] / A[band(j, j)];
      const int lo = max(0, band_lo(j));
      if (lane < j - lo) d[lo + lane] -= A[band(j, lo + lane)] * xj;
      if (lane == 0) y[j] = xj;
      __syncwarp();
    }
    for (int r = lane; r < N; r += 32) d[r] = y[r] * s[r];
  }
  __syncthreads();
}

// a try: x_new = retract(x, d); the pieces of chi2 at x_new with the frozen
// weights; the last warp meanwhile reduces d (d.(lam d - g), |d|^2, max|d|)
template <class T>
__device__ void trial(const Params& p, Ctl<T>& c, T lam, const T* x, T* xn, const T* d, const T* g,
                      const T* fac, const T* wh, const T* msk, T* kw, T* part) {
  const int tid = threadIdx.x, W = p.W, N = DIM * W;
  for (int w = tid; w < W; w += THREADS) {
    const T* xs = x + w * NSTATE;
    T* xo = xn + w * NSTATE;
    T E[9];
    so3_exp(d + w * DIM, E);
    mm(xs, E, xo);
    for (int i = 0; i < 12; ++i) xo[9 + i] = xs[9 + i] + d[w * DIM + 3 + i];
  }
  __syncthreads();
  if (tid < THREADS - 32) {
    for (int e = tid; e < W * BLOCKS; e += THREADS - 32)
      part[e] = block_chi2(p, e / BLOCKS, e % BLOCKS, xn, fac, wh, msk, kw, false);
  } else if (tid == THREADS - 32) {
    T den = T(0), n2 = T(0), mx = abs_(d[0]);
    for (int r = 0; r < N; ++r) {
      den += d[r] * (lam * d[r] - g[r]);
      n2 += d[r] * d[r];
      mx = max_nan(mx, abs_(d[r]));
    }
    c.denom = den;
    c.nrm2 = n2;
    c.dmaxd = mx;
  }
  __syncthreads();
  if (tid == 0) {
    T y1 = T(0);
    for (int e = 0; e < W * BLOCKS; ++e) y1 += part[e];
    c.y1 = y1;
  }
  __syncthreads();
}

template <class T> __device__ void copy_state(T* dst, const T* src, int W) {
  for (int e = threadIdx.x; e < W * NSTATE; e += THREADS) dst[e] = src[e];
}

template <class T>
__global__ void __launch_bounds__(THREADS) window_lm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Ctl<T> c;
  const int W = p.W, N = DIM * W, tid = threadIdx.x;
  const long b = blockIdx.x;
  T* const xs = reinterpret_cast<T*>(smem_raw);
  T* const xn = xs + NSTATE * W;
  T* const fac = xn + NSTATE * W;
  T* const wh = fac + NFAC * W;
  T* const msk = wh + NWH * W;
  T* const kw = msk + BLOCKS * W;
  T* const J = kw + BLOCKS * W;
  T* const r0 = J + RES * PAIR * W;
  T* const H = r0 + RES * W;
  T* const A = H + DIM * BAND * W;
  T* const g = A + DIM * BAND * W;
  T* const d = g + N;
  T* const s = d + N;
  T* const y = s + N;
  T* const part = y + N;

  auto load = [&](T* dst, int stride, int off, int field, int width) {
    const T* src = static_cast<const T*>(p.in[field]) + b * W * width;
    for (int e = tid; e < W * width; e += THREADS) dst[(e / width) * stride + off + e % width] = src[e];
  };
  load(xs, NSTATE, 0, I_R, 9);
  load(xs, NSTATE, 9, I_P, 3);
  load(xs, NSTATE, 12, I_V, 3);
  load(xs, NSTATE, 15, I_BG, 3);
  load(xs, NSTATE, 18, I_BA, 3);
  load(fac, NFAC, F_RELR, I_REL_R, 9);
  load(fac, NFAC, F_RELP, I_REL_P, 3);
  load(fac, NFAC, F_PRIR, I_PRIOR_R, 9);
  load(fac, NFAC, F_PRIP, I_PRIOR_P, 3);
  load(fac, NFAC, F_DT, I_DT, 1);
  load(fac, NFAC, F_DR, I_DR, 9);
  load(fac, NFAC, F_DV, I_DV, 3);
  load(fac, NFAC, F_DP, I_DP, 3);
  load(fac, NFAC, F_DRDBG, I_DR_DBG, 9);
  load(fac, NFAC, F_DVDBG, I_DV_DBG, 9);
  load(fac, NFAC, F_DVDBA, I_DV_DBA, 9);
  load(fac, NFAC, F_DPDBG, I_DP_DBG, 9);
  load(fac, NFAC, F_DPDBA, I_DP_DBA, 9);
  load(fac, NFAC, F_PBG, I_PRE_BG, 3);
  load(fac, NFAC, F_PBA, I_PRE_BA, 3);
  load(fac, NFAC, F_VEL, I_VEL_MEAS, 3);
  load(fac, NFAC, F_PNODE, I_PLANE_NODE, 4);
  load(fac, NFAC, F_PMEAS, I_PLANE_MEAS, 4);
  load(wh, NWH, WH_REL, I_REL_INFO, 36);
  load(wh, NWH, WH_PRIOR, I_PRIOR_INFO, 36);
  load(wh, NWH, WH_PRE, I_PREINT_INFO, 81);
  {
    const T* vi = static_cast<const T*>(p.in[I_VEL_INFO]) + b * W * 3;
    const T* pi = static_cast<const T*>(p.in[I_PLANE_INFO]) + b * W;
    const uint8_t* fm = static_cast<const uint8_t*>(p.in[I_FRAME_MASK]) + b * W;
    const uint8_t* pv = static_cast<const uint8_t*>(p.in[I_PLANE_VALID]) + b * W;
    for (int e = tid; e < W * 3; e += THREADS) wh[(e / 3) * NWH + WH_VEL + e % 3] = sqrt_(clamp_min_(vi[e], T(0)));
    for (int w = tid; w < W; w += THREADS) wh[w * NWH + WH_PLANE] = sqrt_(clamp_min_(pi[w], T(0)));
    for (int e = tid; e < W * BLOCKS; e += THREADS) {
      const int w = e / BLOCKS;
      bool edge = w > 0 && fm[w] && fm[w - 1];
      if (e % BLOCKS == 6) edge = edge && pv[w];
      msk[e] = edge ? T(1) : T(0);
    }
  }
  __syncthreads();
  for (int e = tid; e < 3 * W; e += THREADS)
    chol_small(wh + (e / 3) * NWH + (e % 3 == 0 ? WH_REL : (e % 3 == 1 ? WH_PRIOR : WH_PRE)), e % 3 == 2 ? 9 : 6);
  if (tid == 0) {
    c.lam = p.gn ? T(0) : T(-1);
    c.iters = 0;
    c.tries = 0;
  }
  __syncthreads();

  const T rel = T(p.rel_tol), step_tol = T(1e-6);
  for (int it = 0; it < p.max_iters; ++it) {
    // the linearization at x
    for (int e = tid; e < W * PAIR; e += THREADS) linearize(p, e / PAIR, e % PAIR, xs, fac, wh, msk, kw, J, r0);
    __syncthreads();
    for (int e = tid; e < N * BAND; e += THREADS) H[e] = hessian_entry(W, e / BAND, e % BAND, J);
    for (int r = tid; r < N; r += THREADS) g[r] = gradient_entry(W, r, J, r0);
    __syncthreads();
    if (tid == 0) {
      T y0 = T(0);
      for (int e = 0; e < W * RES; ++e) y0 += r0[e] * r0[e];
      T mx = abs_(H[band(0, 0)]);
      for (int r = 1; r < N; ++r) mx = max_nan(mx, abs_(H[band(r, r)]));
      c.y0 = y0;
      c.done = 0;
      if (p.gn) {
        // one (near-)undamped step; a rejected step escalates the damping
        c.eps = (c.lam < T(1e-8) ? T(1e-8) : c.lam) * (mx < T(1) ? T(1) : mx);
      } else {
        if (c.lam < T(0)) c.lam = T(1e-5) * mx;
        c.nu = T(2);
        c.success = 0;
        c.dmax = inf_(T(0));
        c.ynew = y0;
      }
    }
    __syncthreads();
    if (p.gn) {
      const T eps = c.eps;
      damped_solve(c, eps, N, H, g, A, s, y, d);
      trial(p, c, eps, xs, xn, d, g, fac, wh, msk, kw, part);
      if (tid == 0) {
        const T y0 = c.y0, y1 = c.y1, lam = c.lam;
        const bool acc = y1 < y0;
        const bool conv = (acc && abs_(y0 - y1) < rel * (y0 < T(1) ? T(1) : y0)) || (acc && c.dmaxd < step_tol)
                          || (!acc && lam >= T(1e6));
        const T down = lam / T(10);
        c.lam = acc ? (down < T(0) ? T(0) : down) : (lam < T(1e-8) ? T(1e-8) : lam) * T(100);
        c.accept = acc;
        c.done = conv;
        c.tries += 1;
      }
      __syncthreads();
      if (c.accept) copy_state(xs, xn, W);
    } else {
      for (int t = 0; t < INNER_TRIES; ++t) {
        const T lam = c.lam;
        damped_solve(c, lam, N, H, g, A, s, y, d);
        trial(p, c, lam, xs, xn, d, g, fac, wh, msk, kw, part);
        if (tid == 0) {
          const T y0 = c.y0, y1 = c.y1, denom = c.denom;
          const T rho = (y0 - y1) / (abs_(denom) < T(1e-30) ? T(1e-30) : denom);
          const bool acc = rho > T(0) && y1 < y0;
          if (acc) {
            const T u = T(2) * rho - T(1);
            const T q = T(1) - u * u * u;
            c.lam = lam * (q < T(1.0 / 3.0) ? T(1.0 / 3.0) : q);
            c.dmax = c.dmaxd;
            c.ynew = y1;
          } else {
            c.lam = lam * c.nu;
            c.nu = T(2) * c.nu;
          }
          c.success = acc;
          c.accept = acc;
          c.stop = acc || sqrt_(c.nrm2) < T(1e-8);
          c.tries += 1;
        }
        __syncthreads();
        if (c.accept) copy_state(xs, xn, W);
        if (c.stop) break;
      }
      if (tid == 0) {
        const T y0 = c.y0;
        const bool conv = c.success && (abs_(y0 - c.ynew) < rel * (y0 < T(1) ? T(1) : y0) || c.dmax < step_tol);
        c.done = conv || !c.success;
      }
    }
    if (tid == 0) c.iters += 1;
    __syncthreads();
    if (c.done) break;
  }

  // the final chi2, its weights recomputed at the final state
  for (int e = tid; e < W * BLOCKS; e += THREADS) part[e] = block_chi2(p, e / BLOCKS, e % BLOCKS, xs, fac, wh, msk, kw, true);
  __syncthreads();
  const int widths[5] = {9, 3, 3, 3, 3};
  int off = 0;
  for (int f = 0; f < 5; ++f) {
    T* out = static_cast<T*>(p.out[O_R + f]) + b * W * widths[f];
    for (int e = tid; e < W * widths[f]; e += THREADS) out[e] = xs[(e / widths[f]) * NSTATE + off + e % widths[f]];
    off += widths[f];
  }
  if (tid == 0) {
    T chi2 = T(0);
    for (int e = 0; e < W * BLOCKS; ++e) chi2 += part[e];
    static_cast<T*>(p.out[O_CHI2])[b] = chi2;
    int* counts = static_cast<int*>(p.out[O_COUNTS]) + 2 * b;
    counts[0] = c.iters;
    counts[1] = c.tries;
  }
}

template <class T> cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int max_bytes = SLOT_ELEMS * max_window(sizeof(T)) * int(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(window_lm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
  if (err != cudaSuccess) return err;
  window_lm_kernel<T><<<B, THREADS, size_t(SLOT_ELEMS) * p.W * sizeof(T), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rivslam_window_lm_max_window(int is_double) { return max_window(is_double ? 8 : 4); }

extern "C" int rivslam_window_lm_slot_elems() { return SLOT_ELEMS; }

// in: N_IN device pointers; out: N_OUT device pointers; dparams: ksize[7],
// sqrt_bg, sqrt_ba, gravity, rel_tol; iparams: kind[7], gn, max_iters.
// Returns the cudaError_t of the launch.
extern "C" int rivslam_window_lm(const void* const* in, void* const* out, const double* dparams,
                                 const int* iparams, int B, int W, int is_double, void* stream) {
  if (B < 1 || W < 1 || W > max_window(is_double ? 8 : 4)) return int(cudaErrorInvalidValue);
  Params p;
  for (int i = 0; i < N_IN; ++i) p.in[i] = in[i];
  for (int i = 0; i < N_OUT; ++i) p.out[i] = out[i];
  for (int k = 0; k < BLOCKS; ++k) {
    p.ksize[k] = dparams[k];
    p.kind[k] = iparams[k];
  }
  p.sqrt_bg = dparams[BLOCKS];
  p.sqrt_ba = dparams[BLOCKS + 1];
  p.gravity = dparams[BLOCKS + 2];
  p.rel_tol = dparams[BLOCKS + 3];
  p.gn = iparams[BLOCKS];
  p.max_iters = iparams[BLOCKS + 1];
  p.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_double ? launch<double>(p, B, s) : launch<float>(p, B, s));
}
