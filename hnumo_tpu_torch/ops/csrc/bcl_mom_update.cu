// The end of each baroclinic half-step, one launch a call, CUDA C++ for
// sm_90a (NVIDIA Hopper).
//
// The tail of core/stepper._momentum_update after the layer momentum's three
// terms, and evaluate_bcl (the predictor) or evaluate_bcl_v1 (the corrector)
// without the face extraction of the new primes (reference momentum and
// momentum_mass, src/mod_splitting.F90:128-175, 239-282;
// src/mod_layer_terms.F90:139-320). Its plain version is
// ops/bcl_mom_update.bcl_mom_update_plain, whose arithmetic this kernel
// repeats operation for operation, in the same order, each value rounded
// where PyTorch's elementwise operation rounds it. It replaces no TPU
// kernel: the JAX package leaves these functions to XLA's fusion. In plain
// PyTorch they are ~100-110 operations a half-step on tensors of a few tens
// of thousands of values, each a launch of ~1.7 us on the card; here they are
// one launch.
//
//   bcl_mom_update_kernel, one thread a (element, node), the layers streamed:
//   pass 1, per layer: the scatter of the face fluxes' values at the
//     element's edge nodes (core/faces.scatter_face_x / _y: -SuL on the east
//     and north edges, +SuR on the west and south ones, -SuL at a west or
//     south domain wall), + the static reference terms, the inverse mass, +
//     the viscosity, q + dt * rhs, the semi-implicit Coriolis rotation, the
//     wall projection (core/faces.apply_wall_projection); then the velocity
//     u = qu / dp and the running layer sums of u dp (extract_velocity) and,
//     in the predictor, of the thickness (eta_t);
//   pass 2, per layer: the smoothed velocity and momentum (the first
//     extract_velocity), the velocity of the smoothed momentum and its
//     running layer sums (the second), and the thickness prime: the
//     predictor's from eta_t in the delta form, or the corrector's, kept;
//   pass 3, per layer: the velocity primes.
//   Between the passes a layer's velocities wait in the outputs' own slots,
//   each read back only by the thread that wrote it.
//   With the vertical shear stress (ad_mlswe > 0) a call is two launches:
//   MODE_FIRST writes q + dt * rhs of each layer (pass 1 to there), the
//   caller runs the plain shear solve (a tridiagonal solve down each quad
//   point's column), and MODE_REST takes its momenta from the rotation on.
//
// What bounds it on this card: latency. At the 25x25 main path a launch has
// 625 elements x 25 nodes x 2 layers and moves ~2 MB in f32: a fraction of a
// microsecond of bytes, one wave of 123 blocks. The layers are streamed one at
// a time and nothing of a layer is kept after its turn but the running layer
// sums, so a column of any number of layers (up to LMAX, the limit of
// bcl_flux.cu) runs the same build with the same registers: no per-layer
// array, in registers or in local memory. Neighbouring threads read and write
// neighbouring addresses of every nodal operand. The layer sums add in layer
// order, as torch.sum does at L=2. No fast-math, and no product is contracted
// into a fused multiply-add (mul_rn): where a field is a small difference of
// large terms (the primes of a column of one layer are rounding noise) the
// kernel then gives the plain version's bits, not a rounding of its own.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LMAX = 64;      // the most layers (ops/bcl_mom_update.MAX_LAYERS)
constexpr int THREADS = 128;  // a block: 123 blocks at the 25x25 main path, one wave

// the launches of ops/bcl_mom_update (WHOLE, FIRST, REST)
enum { MODE_WHOLE, MODE_FIRST, MODE_REST };

// operands, in the order of ops/bcl_mom_update.OPERANDS
enum {
  kQd,      // q_df (3, L, E, n2): ddp, u dp, v dp
  kVol,     // rhs_vol (2, L, E, n2): the volume term
  kRef,     // P.bcl_rhs_ref (2, L, E, n2)
  kVisc,    // rhs_visc (2, L, E, n2); null without viscosity
  kMinv,    // g.massinv (E, n2)
  kFdt2,    // P.fdt2_bcl (E, n2)
  kA, kB,   // P.a_bcl, P.b_bcl (E, n2)
  kDref,    // P.dpp_ref_df (L, E, n2)
  kResid,   // P.sum_ref_residual (E, n2)
  kOopb,    // P.one_over_pbprime_df (E, n2)
  kQb,      // qb_df (4, E, n2): pb, pb', pb ub, pb vb
  kDpp,     // dpprime (L, E, n2): the corrector's thickness prime; null in the predictor
  kSx,      // the x-faces' SuL, SuR, SvL, SvR (L, ly, lx+1, ngl), 4 operands
  kSy = kSx + 4,  // the y-faces' (L, ly+1, lx, ngl), 4 operands
  NIN = kSy + 4
};
// the pointers after the NIN operands, in the order of ops/bcl_mom_update._launch
enum { xQ, xQp, xQuT, xQvT, NEXTRA };

template <typename T>
struct Args {
  const T* in[NIN];
  T* q;         // (3, L, E, n2): the new q_df
  T* qp;        // (3, L, E, n2): the new qprime_df
  T* qt[2];     // (L, E, n2) each: q + dt * rhs, written by MODE_FIRST, read by MODE_REST
  T dt;
  int L, ngl, ly, lx, xwall, ywall, wall_bits, visc, keep_dpp;
};

// a product rounded on its own, never merged into a fused multiply-add
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// extract_velocity's velocity of a layer whose column's mean is ubar, made to
// mean the barotropic ub: u - ubar + ub, in torch's order
template <typename T>
__device__ __forceinline__ T u_smooth(T u, T ubar, T ub) {
  return (u - ubar) + ub;
}

template <int MODE, typename T>
__global__ void __launch_bounds__(THREADS)
bcl_mom_update_kernel(const __grid_constant__ Args<T> a) {
  const int ngl = a.ngl, n2 = ngl * ngl, L = a.L, lx = a.lx, ly = a.ly;
  const int E = ly * lx;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= E * n2) return;
  const int e = t / n2, n = t - e * n2;
  const int ey = e / lx, ex = e - ey * lx;
  const int j = n / ngl, i = n - j * ngl;      // the node's row (y) and column (x)
  const size_t EN = size_t(E) * n2, LEN = size_t(L) * EN;
  const T* qd = a.in[kQd];

  // ---- the node's place: the edges it lies on, and its faces ---------------
  const bool east = i == ngl - 1, west = i == 0, north = j == ngl - 1, south = j == 0;
  const bool west_wall = west && ex == 0 && a.xwall;
  const bool south_wall = south && ey == 0 && a.ywall;
  const size_t fxs = size_t(ly) * (lx + 1) * ngl, fys = size_t(ly + 1) * lx * ngl;
  const size_t fe = (size_t(ey) * (lx + 1) + ex + 1) * ngl + j;   // the east x-face
  const size_t fw = fe - ngl;                                    // the west x-face
  const size_t fs = (size_t(ey) * lx + ex) * ngl + i;            // the south y-face
  const size_t fn = fs + size_t(lx) * ngl;                       // the north y-face
  // the wall projection's zeroed components (ops/bcl_mom_update.wall_bits)
  int zero = 0;
  if (west && ex == 0) zero |= a.wall_bits & 3;
  if (east && ex == lx - 1) zero |= (a.wall_bits >> 2) & 3;
  if (south && ey == 0) zero |= (a.wall_bits >> 4) & 3;
  if (north && ey == ly - 1) zero |= (a.wall_bits >> 6) & 3;

  T su = T(0), sv = T(0), esum = T(0);
  T fdt2 = T(0), ca = T(0), cb = T(0), minv = T(0);
  if constexpr (MODE != MODE_REST) minv = a.in[kMinv][t];
  if constexpr (MODE != MODE_FIRST) {
    fdt2 = a.in[kFdt2][t];
    ca = a.in[kA][t];
    cb = a.in[kB][t];
  }

  // ---- pass 1 ----------------------------------------------------------------
  for (int k = 0; k < L; ++k) {
    const size_t off = size_t(k) * EN + t;
    const T q0 = qd[off], q1 = qd[LEN + off], q2 = qd[2 * LEN + off];
    T qut, qvt;
    if constexpr (MODE != MODE_REST) {
      T ru = a.in[kVol][off], rv = a.in[kVol][LEN + off];
      const T* const* Sx = a.in + kSx;
      const T* const* Sy = a.in + kSy;
      const size_t kx = size_t(k) * fxs, ky = size_t(k) * fys;
      if (east) {
        ru = ru - Sx[0][kx + fe];
        rv = rv - Sx[2][kx + fe];
      }
      if (west) {
        ru = west_wall ? ru + -Sx[0][kx + fw] : ru + Sx[1][kx + fw];
        rv = west_wall ? rv + -Sx[2][kx + fw] : rv + Sx[3][kx + fw];
      }
      if (north) {
        ru = ru - Sy[0][ky + fn];
        rv = rv - Sy[2][ky + fn];
      }
      if (south) {
        ru = south_wall ? ru + -Sy[0][ky + fs] : ru + Sy[1][ky + fs];
        rv = south_wall ? rv + -Sy[2][ky + fs] : rv + Sy[3][ky + fs];
      }
      ru = ru + a.in[kRef][off];
      rv = rv + a.in[kRef][LEN + off];
      ru = mul_rn(minv, ru) + (a.visc ? a.in[kVisc][off] : T(0));
      rv = mul_rn(minv, rv) + (a.visc ? a.in[kVisc][LEN + off] : T(0));
      qut = q1 + mul_rn(a.dt, ru);
      qvt = q2 + mul_rn(a.dt, rv);
      if constexpr (MODE == MODE_FIRST) {
        a.qt[0][off] = qut;
        a.qt[1][off] = qvt;
        continue;
      }
    } else {
      qut = a.qt[0][off];
      qvt = a.qt[1][off];
    }
    // the rotation and the wall projection
    const T tu = qut + mul_rn(fdt2, q2);
    const T tv = qvt - mul_rn(fdt2, q1);
    T qu = mul_rn(ca, tu) + mul_rn(cb, tv);
    T qv = mul_rn(-cb, tu) + mul_rn(ca, tv);
    if (zero & 1) qu = T(0);
    if (zero & 2) qv = T(0);
    // the first extract_velocity's velocities and layer sums
    const T dp = a.in[kDref][off] + q0;
    const T u = qu / dp, v = qv / dp;
    su = k ? su + mul_rn(u, dp) : mul_rn(u, dp);
    sv = k ? sv + mul_rn(v, dp) : mul_rn(v, dp);
    esum = k ? esum + q0 : q0;
    a.q[off] = q0;
    a.q[LEN + off] = u;         // read back in pass 2
    a.q[2 * LEN + off] = v;
  }
  if constexpr (MODE == MODE_FIRST) return;

  // ---- pass 2 ----------------------------------------------------------------
  const T* qb = a.in[kQb];
  const T pb = qb[t];
  const bool ok = pb > T(0);
  const T ub = qb[2 * EN + t] / pb, vb = qb[3 * EN + t] / pb;
  const T ubar = su / pb, vbar = sv / pb;
  const T eta = mul_rn(esum + a.in[kResid][t], a.in[kOopb][t]);
  su = T(0);
  sv = T(0);
  for (int k = 0; k < L; ++k) {
    const size_t off = size_t(k) * EN + t;
    const T dref = a.in[kDref][off];
    const T q0 = qd[off];
    const T dp = dref + q0;
    const T u1 = ok ? u_smooth(a.q[LEN + off], ubar, ub) : T(0);
    const T v1 = ok ? u_smooth(a.q[2 * LEN + off], vbar, vb) : T(0);
    const T mu = mul_rn(u1, dp), mv = mul_rn(v1, dp);
    a.q[LEN + off] = mu;
    a.q[2 * LEN + off] = mv;
    const T u2 = mu / dp, v2 = mv / dp;
    su = k ? su + mul_rn(u2, dp) : mul_rn(u2, dp);
    sv = k ? sv + mul_rn(v2, dp) : mul_rn(v2, dp);
    a.qp[off] = a.keep_dpp ? a.in[kDpp][off] : (q0 - mul_rn(dref, eta)) / (T(1) + eta);
    a.qp[LEN + off] = u2;       // read back in pass 3
    a.qp[2 * LEN + off] = v2;
  }

  // ---- pass 3 ----------------------------------------------------------------
  const T ubar2 = su / pb, vbar2 = sv / pb;
  for (int k = 0; k < L; ++k) {
    const size_t off = size_t(k) * EN + t;
    const T u3 = ok ? u_smooth(a.qp[LEN + off], ubar2, ub) : T(0);
    const T v3 = ok ? u_smooth(a.qp[2 * LEN + off], vbar2, vb) : T(0);
    a.qp[LEN + off] = u3 - ub;
    a.qp[2 * LEN + off] = v3 - vb;
  }
}

template <int MODE, typename T>
cudaError_t run(const Args<T>& a, int blocks, cudaStream_t stream) {
  bcl_mom_update_kernel<MODE, T><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int mode, int L, int ngl, int ly, int lx, int xwall, int ywall,
                   int wall_bits, int visc, int keep_dpp, const void* const* ptrs, double dt,
                   cudaStream_t stream) {
  if (mode < MODE_WHOLE || mode > MODE_REST || L < 1 || L > LMAX || ngl < 2 || ly < 0 ||
      lx < 0 || (visc && !ptrs[kVisc]) || (keep_dpp && !ptrs[kDpp]))
    return cudaErrorInvalidValue;
  Args<T> a;
  for (int i = 0; i < NIN; ++i) a.in[i] = static_cast<const T*>(ptrs[i]);
  const void* const* x = ptrs + NIN;
  a.q = static_cast<T*>(const_cast<void*>(x[xQ]));
  a.qp = static_cast<T*>(const_cast<void*>(x[xQp]));
  a.qt[0] = static_cast<T*>(const_cast<void*>(x[xQuT]));
  a.qt[1] = static_cast<T*>(const_cast<void*>(x[xQvT]));
  if (mode != MODE_WHOLE && (!a.qt[0] || !a.qt[1])) return cudaErrorInvalidValue;
  a.dt = T(dt);
  a.L = L;
  a.ngl = ngl;
  a.ly = ly;
  a.lx = lx;
  a.xwall = xwall;
  a.ywall = ywall;
  a.wall_bits = wall_bits;
  a.visc = visc;
  a.keep_dpp = keep_dpp;
  const long long nodes = (long long)ly * lx * ngl * ngl;
  if (nodes == 0) return cudaSuccess;
  const int blocks = int((nodes + THREADS - 1) / THREADS);
  switch (mode) {
    case MODE_WHOLE: return run<MODE_WHOLE>(a, blocks, stream);
    case MODE_FIRST: return run<MODE_FIRST>(a, blocks, stream);
    default: return run<MODE_REST>(a, blocks, stream);
  }
}

}  // namespace

extern "C" {

// Launch `mode` (0 the whole end of the half-step, 1 its part to q + dt * rhs,
// 2 the rest from the rotation on) on `stream`; does not synchronise. `ptrs`:
// the NIN operands in the order of ops/bcl_mom_update.OPERANDS (the viscosity
// null where `visc` is 0, the thickness prime null where `keep_dpp` is 0),
// then the new q_df, the new qprime_df, and q + dt * rhs of u and of v (mode
// 1 writes them, mode 2 reads them, mode 0 takes null). `xwall` / `ywall`: the
// block's first x / y face is a wall whose L side is its first element;
// `wall_bits`: the wall projection's zeroed components
// (ops/bcl_mom_update.wall_bits). Returns the launch's cudaError_t.
int bcl_mom_update_launch(int mode, int is_double, int L, int ngl, int ly, int lx, int xwall,
                          int ywall, int wall_bits, int visc, int keep_dpp,
                          const void* const* ptrs, double dt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_double ? launch<double>(mode, L, ngl, ly, lx, xwall, ywall, wall_bits, visc,
                                        keep_dpp, ptrs, dt, s)
                       : launch<float>(mode, L, ngl, ly, lx, xwall, ywall, wall_bits, visc,
                                       keep_dpp, ptrs, dt, s));
}

const char* bcl_mom_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bcl_mom_update_operand_count() { return NIN; }

}  // extern "C"
