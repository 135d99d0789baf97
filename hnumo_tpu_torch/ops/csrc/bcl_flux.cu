// Layer-momentum face fluxes of the baroclinic step, both face directions in
// one launch, CUDA C++ for sm_90a (NVIDIA Hopper).
//
// The per-face body of core/bcl.layer_momentum_face_values (reference
// Apply_layers_fluxes, src/mod_create_rhs_mlswe.F90:458-820); its plain
// version is ops/bcl_flux.bcl_momentum_fluxes_plain, whose arithmetic this
// kernel repeats operation for operation. It replaces no TPU kernel: the JAX
// package leaves this function to XLA's fusion. In plain PyTorch it is ~1,100
// operations a call on tensors of a few thousand values, each a launch of
// ~1.6 us on the card; here it is one launch. Per face and quad point, over
// the L layers of the column:
//   - the interpolation of the L/R traces of (ddp', u', v') to the quad point,
//   - the upwind advective fluxes and their flux-deficit weighting,
//   - the conditioned interface pressures pi and elevations zeta (cumsums),
//   - the one-sided dH, the O(L^2) layer-overlap dH, the wall one-sided H and
//     the interior interface corrections,
//   - the match of the vertical sum to the barotropic average dH,
// and per face the integration of the four integrands (SuL, SuR, SvL, SvR)
// against the edge basis, (L, F, ngl) each. The scatter into the elements'
// edges stays with the caller.
//
// What bounds it on this card: latency. At the 25x25 main path a launch has
// 1,300 faces x 9 quad points (11,700 columns) and moves ~1 MB in f32:
// under a microsecond of bytes, under a wave of threads. What the design does
// about it:
//   - one thread a (face, quad point) carries the column's L layers: the
//     cumsums and the L^2 overlap run in the thread, with no barrier and no
//     second pass. Up to LMAX_REG layers the column is in registers (the
//     layer loops unrolled to LMAX_REG and guarded by the run-time L); above
//     it, up to LMAX_MID and then up to LMAX, in arrays of that size in local
//     memory, the loops not unrolled;
//   - a block takes FPB whole faces of one direction (FPB*nq <= 96 threads,
//     fewer where FPB faces' staging would not fit in shared memory), so the
//     25x25 launch is ~130 blocks, one wave on 132 SMs; it stages the
//     block's nodal traces (one coalesced run per channel and layer) and the
//     edge basis in shared memory; the per-point tables are read once each,
//     neighbouring threads on neighbouring addresses;
//   - the integration against the edge basis reads the block's integrands
//     from shared memory after one barrier, one thread an output value, and
//     each output is written once; no atomics, so the result is the same
//     from run to run.
// The delta-form arithmetic of docs/float32.md is kept as the plain version
// writes it (conditioned sqrt factors, (reference part, zeta part) pairs
// through the minimum, the Vref / 2 Pe[kt+1] anchoring); no fast-math.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LMAX_REG = 4;       // the most layers a column carries in registers
constexpr int LMAX_MID = 16;      // ... in the smaller local-memory build
constexpr int LMAX = 64;          // the most layers (ops/bcl_flux.MAX_LAYERS)
constexpr int MAX_THREADS = 128;  // the most quad points a face (ops/bcl_flux.MAX_NQ)
constexpr int TARGET_THREADS = 96;
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may opt in to

// The layer loops of a build for at most NL layers. Where the column is in
// registers a loop makes all NL trips (or NL + 1), the layers past L
// skipped with `continue` so that the trip count stays exact, and unrolls
// wholly; where it is in local memory a loop makes L trips (or L + 1) and
// does not unroll.
template <int NL>
struct LayerTier {
  static constexpr bool in_registers = NL <= LMAX_REG;
  static constexpr int unroll = in_registers ? NL : 1;
  static constexpr int unroll1 = in_registers ? NL + 1 : 1;
  __device__ __forceinline__ static int trips(int L) { return in_registers ? NL : L; }
};

// operands of one direction, in the order of ops/bcl_flux
constexpr int NTR = 6;    // traces ddp' L, R, u' L, R, v' L, R: (L, F, ngl)
constexpr int NFA = 14;   // face averages (F, nq): dH QuU QuV QvU QvV muL muR mu2L mu2R
                          // mue2 ubL ubR vbL vbR
constexpr int NGEO = 9;   // nx ny jac Hedge_ref (F, nq); wall4 (F); dpp_ref_face_q
                          // Hk_ref_edge (L, F, nq); P_ref_edge z_ref_face (L+1, F, nq)
constexpr int NOUT = 4;   // SuL SuR SvL SvR: (L, F, ngl)
constexpr int NPTR = NTR + NFA + NGEO + NOUT;

enum { kDH, kQuU, kQuV, kQvU, kQvV, kMuL, kMuR, kMu2L, kMu2R, kMue2, kUbL, kUbR, kVbL, kVbR };
enum { kNx, kNy, kJac, kHedge, kWall, kDref, kHk, kPe, kZr };

template <typename T>
struct Dir {
  const T* tr[NTR];
  const T* fa[NFA];
  const T* geo[NGEO];
  T* out[NOUT];
  int F;       // faces of this direction
  int blocks;  // blocks of this direction
};

template <typename T>
struct Args {
  Dir<T> d[2];      // x-faces, y-faces
  const T* alpha;   // (L,)
  const T* psiq;    // (ngl, nq)
  T grav;
  int L, ngl, nq, fpb;
};

template <typename T>
size_t smem_bytes(int L, int ngl, int nq, int fpb) {
  return sizeof(T) * (size_t(ngl) * nq + size_t(NTR) * L * fpb * ngl +
                      size_t(NOUT) * L * fpb * nq);
}

// faces a block takes: TARGET_THREADS / nq, or as many as fit in SMEM_MAX; 0
// where not even one face fits
template <typename T>
int faces_per_block(int L, int ngl, int nq) {
  const int want = nq >= TARGET_THREADS ? 1 : TARGET_THREADS / nq;
  int fpb = 0;
  while (fpb < want && smem_bytes<T>(L, ngl, nq, fpb + 1) <= SMEM_MAX) ++fpb;
  return fpb;
}

// sum_n f[n] psi[n, q] over a face's staged nodal row (psi points at psiq[0, q])
template <int NGL_, typename T>
__device__ __forceinline__ T dot_row(const T* f, const T* psi, int ngl, int nq) {
  T s = f[0] * psi[0];
  if (NGL_) {
#pragma unroll
    for (int n = 1; n < NGL_; ++n) s = s + f[n] * psi[n * nq];
  } else {
    for (int n = 1; n < ngl; ++n) s = s + f[n] * psi[n * nq];
  }
  return s;
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

// (Ra, pa) or (Rb, pb), whichever has the smaller sum: the plain version's take_min
template <typename T>
__device__ __forceinline__ void take_min(T Ra, T pa, T Rb, T pb, T& R, T& p) {
  const bool a_lt = (Ra + pa) < (Rb + pb);
  R = a_lt ? Ra : Rb;
  p = a_lt ? pa : pb;
}

// delta of the hydrostatic 1/2 alpha (p[k+1]^2 - p[k]^2) of layer k given interface pi
template <typename T>
__device__ __forceinline__ T dH_int(T al, T Pe0, T Pe1, T pi0, T pi1) {
  return al * ((Pe1 * pi1 - Pe0 * pi0) + T(0.5) * (pi1 * pi1 - pi0 * pi0));
}

// delta of the layer-intersection H of target layer k from the source column
template <int NL, typename T>
__device__ __forceinline__ T overlap_dH(int k, int L, const T* Zr, const T* Pe, const T* al,
                                        const T* ga, const T* pi_src, const T* z_src,
                                        const T* z_tgt) {
  using Tier = LayerTier<NL>;
  const T zt_u = z_tgt[k], zt_l = z_tgt[k + 1];
  const T R2 = Zr[k] - Zr[k + 1], p2 = zt_u - zt_l;
  const T Vref = Pe[k + 1] + Pe[k];
  T tot = T(0);
#pragma unroll (Tier::unroll)
  for (int kt = 0; kt < Tier::trips(L); ++kt) {
    if (kt >= L) continue;
    const T ga_s = ga[kt], al_s = al[kt];
    const T zs_u = z_src[kt], zs_l = z_src[kt + 1];
    const T R1 = Zr[kt] - Zr[kt + 1], p1 = zs_u - zs_l;
    const T R3 = Zr[kt] - Zr[k + 1], p3 = zs_u - zt_l;
    const T R4 = Zr[k] - Zr[kt + 1], p4 = zt_u - zs_l;
    T Ra, pa, Rb, pb, Rm, pm;
    take_min(R1, p1, R2, p2, Ra, pa);
    take_min(R3, p3, R4, p4, Rb, pb);
    take_min(Ra, pa, Rb, pb, Rm, pm);
    const T Dzov = tmin(tmin(R1, R2), tmin(R3, R4));
    const T ddz_ov = pm + (Rm - Dzov);
    const bool mask = (Dzov + ddz_ov) > T(0);
    const T umU = ga_s * (ddz_ov + tmin(Dzov, T(0)));
    const T U = Dzov > T(0) ? ga_s * Dzov : T(0);
    const T A_bot = (Zr[kt + 1] - Zr[k + 1]) + (zs_l - zt_l);
    const T nA = -A_bot;
    const T pi_bot = pi_src[kt + 1] - ga_s * (nA > T(0) ? nA : T(0));
    const T vmV = T(2) * pi_bot - umU;
    const T v = (k == kt ? Vref : T(2) * Pe[kt + 1]) + vmV;
    const T contrib = (T(0.5) * al_s) * (umU * v + U * vmV);
    tot = tot + (mask ? contrib : ((T(-0.5) * al_s) * U) * Vref);
  }
  return tot;
}

// NL: the most layers this build carries (LMAX_REG, LMAX_MID or LMAX)
template <typename T, int NGL_, int NQ_, int NL>
__global__ void __launch_bounds__(MAX_THREADS)
bcl_flux_kernel(const __grid_constant__ Args<T> a) {
  using Tier = LayerTier<NL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ngl = NGL_ ? NGL_ : a.ngl;
  const int nq = NQ_ ? NQ_ : a.nq;
  const int L = a.L, fpb = a.fpb;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  int b = blockIdx.x;
  const int dir = b < a.d[0].blocks ? 0 : 1;
  if (dir) b -= a.d[0].blocks;
  const Dir<T>& D = a.d[dir];
  const int F = D.F;
  const int f0 = b * fpb;
  const int nf = min(fpb, F - f0);

  T* s_psi = smem;                          // (ngl, nq)
  T* s_tr = s_psi + ngl * nq;               // (NTR, L, fpb*ngl)
  T* s_red = s_tr + NTR * L * fpb * ngl;    // (NOUT, L, fpb, nq)

  // ---- stage the edge basis and the block's nodal traces -------------------
  for (int i = tid; i < ngl * nq; i += nthreads) s_psi[i] = a.psiq[i];
  const int run = nf * ngl;
  const size_t plane = size_t(F) * ngl;
  for (int i = tid; i < NTR * L * run; i += nthreads) {
    const int ck = i / run, j = i - ck * run;
    const int c = ck / L, k = ck - c * L;
    s_tr[ck * fpb * ngl + j] = D.tr[c][k * plane + size_t(f0) * ngl + j];
  }
  __syncthreads();

  const int lf = tid / nq, q = tid - lf * nq;
  if (lf < nf) {
    const size_t FQ = size_t(F) * nq;
    const size_t fq = size_t(f0 + lf) * nq + q;
    const T* psi = s_psi + q;

    // traces at the quad point
    T tq[NTR][NL];
#pragma unroll
    for (int c = 0; c < NTR; ++c)
#pragma unroll (Tier::unroll)
      for (int k = 0; k < Tier::trips(L); ++k)
        if (k < L) tq[c][k] = dot_row<NGL_>(s_tr + ((c * L + k) * fpb + lf) * ngl, psi, ngl, nq);

    const T nx = D.geo[kNx][fq], ny = D.geo[kNy][fq], jac = D.geo[kJac][fq];
    const T muL = D.fa[kMuL][fq], muR = D.fa[kMuR][fq];
    const T ubL = D.fa[kUbL][fq], ubR = D.fa[kUbR][fq];
    const T vbL = D.fa[kVbL][fq], vbR = D.fa[kVbR][fq];

    T dref[NL], Hk[NL], Pe[NL + 1], Zr[NL + 1], al[NL], a_g[NL], g_a[NL];
#pragma unroll (Tier::unroll1)
    for (int k = 0; k <= Tier::trips(L); ++k) {
      if (k > L) continue;
      Pe[k] = D.geo[kPe][k * FQ + fq];
      Zr[k] = D.geo[kZr][k * FQ + fq];
      if (k < L) {
        dref[k] = D.geo[kDref][k * FQ + fq];
        Hk[k] = D.geo[kHk][k * FQ + fq];
        al[k] = a.alpha[k];
        a_g[k] = al[k] / a.grav;
        g_a[k] = a.grav / al[k];
      }
    }

    // ---- upwind advective fluxes and the flux-deficit weighting --------------
    T f1u[NL], f1v[NL], f2u[NL], f2v[NL];
    T aul[NL], aur[NL], avl[NL], avr[NL];
    T s1u = T(0), s1v = T(0), s2u = T(0), s2v = T(0);
    T dlu = T(0), dru = T(0), dlv = T(0), drv = T(0);
#pragma unroll (Tier::unroll)
    for (int k = 0; k < Tier::trips(L); ++k) {
      if (k >= L) continue;
      const T dpl = (T(1) + muL) * (dref[k] + tq[0][k]);
      const T dpr = (T(1) + muR) * (dref[k] + tq[1][k]);
      const T ul = tq[2][k] + ubL, ur = tq[3][k] + ubR;
      const T vl = tq[4][k] + vbL, vr = tq[5][k] + vbR;
      const T uu = T(0.5) * (ul + ur), vv = T(0.5) * (vl + vr);
      const T udpl = ul * dpl, udpr = ur * dpr, vdpl = vl * dpl, vdpr = vr * dpr;
      const bool upx = uu * nx > T(0), upy = vv * ny > T(0);
      f1u[k] = upx ? uu * udpl : uu * udpr;
      f1v[k] = upx ? uu * vdpl : uu * vdpr;
      f2u[k] = upy ? vv * udpl : vv * udpr;
      f2v[k] = upy ? vv * vdpl : vv * vdpr;
      s1u = s1u + f1u[k];
      s2u = s2u + f2u[k];
      s1v = s1v + f1v[k];
      s2v = s2v + f2v[k];
      aul[k] = fabs(udpl);
      aur[k] = fabs(udpr);
      avl[k] = fabs(vdpl);
      avr[k] = fabs(vdpr);
      dlu = dlu + (aul[k] + T(1.0e-20));
      dru = dru + (aur[k] + T(1.0e-20));
      dlv = dlv + (avl[k] + T(1.0e-20));
      drv = drv + (avr[k] + T(1.0e-20));
    }
    const T uu_def = D.fa[kQuU][fq] - s1u, uv_def = D.fa[kQuV][fq] - s2u;
    const T vu_def = D.fa[kQvU][fq] - s1v, vv_def = D.fa[kQvV][fq] - s2v;
    const bool su = uu_def * nx > T(0), suv = uv_def * ny > T(0);
    const bool svu = vu_def * nx > T(0), sv = vv_def * ny > T(0);
    T flux_x[NL], flux_y[NL];
#pragma unroll (Tier::unroll)
    for (int k = 0; k < Tier::trips(L); ++k) {
      if (k >= L) continue;
      const T wl_u = aul[k] / dlu, wr_u = aur[k] / dru;
      const T wl_v = avl[k] / dlv, wr_v = avr[k] / drv;
      const T g1u = f1u[k] + (su ? wl_u : wr_u) * uu_def;
      const T g2u = f2u[k] + (suv ? wl_u : wr_u) * uv_def;
      const T g1v = f1v[k] + (svu ? wl_v : wr_v) * vu_def;
      const T g2v = f2v[k] + (sv ? wl_v : wr_v) * vv_def;
      flux_x[k] = nx * g1u + ny * g2u;
      flux_y[k] = nx * g1v + ny * g2v;
    }

    // ---- H_face: conditioned interface pressures and elevations -------------
    const T mu2L = D.fa[kMu2L][fq], mu2R = D.fa[kMu2R][fq], mue2 = D.fa[kMue2][fq];
    const T s_l = mu2L / (T(1) + sqrt(T(1) + mu2L));
    const T s_r = mu2R / (T(1) + sqrt(T(1) + mu2R));
    const T s_e = mue2 / (T(1) + sqrt(T(1) + mue2));
    // pi: [0, cumsum(inc)]; zeta: [reverse cumsum(a_g inc), 0]
    T piFL[NL + 1], piFR[NL + 1], piEL[NL + 1], piER[NL + 1];
    T zFL[NL + 1], zFR[NL + 1], zEL[NL + 1], zER[NL + 1];
    T thFL[NL], thFR[NL], thEL[NL], thER[NL];
    piFL[0] = piFR[0] = piEL[0] = piER[0] = T(0);
#pragma unroll (Tier::unroll)
    for (int k = 0; k < Tier::trips(L); ++k) {
      if (k >= L) continue;
      const T iFL = s_l * dref[k] + (T(1) + s_l) * tq[0][k];
      const T iFR = s_r * dref[k] + (T(1) + s_r) * tq[1][k];
      const T iEL = s_e * dref[k] + (T(1) + s_e) * tq[0][k];
      const T iER = s_e * dref[k] + (T(1) + s_e) * tq[1][k];
      piFL[k + 1] = piFL[k] + iFL;
      piFR[k + 1] = piFR[k] + iFR;
      piEL[k + 1] = piEL[k] + iEL;
      piER[k + 1] = piER[k] + iER;
      thFL[k] = a_g[k] * iFL;
      thFR[k] = a_g[k] * iFR;
      thEL[k] = a_g[k] * iEL;
      thER[k] = a_g[k] * iER;
    }
#pragma unroll (Tier::unroll1)
    for (int k = Tier::trips(L); k >= 0; --k) {
      if (k > L) continue;
      if (k == L || k == NL) {
        zFL[k] = zFR[k] = zEL[k] = zER[k] = T(0);
      } else {
        zFL[k] = zFL[k + 1] + thFL[k];
        zFR[k] = zFR[k + 1] + thFR[k];
        zEL[k] = zEL[k + 1] + thEL[k];
        zER[k] = zER[k + 1] + thER[k];
      }
    }

    // ---- one-sided and overlap dH, wall, interface corrections --------------
    const bool wall = D.geo[kWall][f0 + lf] > T(0.5);
    T dHL[NL], dHR[NL];
    T sdL = T(0), sdR = T(0);
#pragma unroll (Tier::unroll)
    for (int k = 0; k < Tier::trips(L); ++k) {
      if (k >= L) continue;
      T hL, hR;
      if (wall) {
        hL = dH_int(al[k], Pe[k], Pe[k + 1], piFL[k], piFL[k + 1]);
        hR = dH_int(al[k], Pe[k], Pe[k + 1], piFR[k], piFR[k + 1]);
      } else {
        hL = T(0.5) * (dH_int(al[k], Pe[k], Pe[k + 1], piEL[k], piEL[k + 1]) +
                       overlap_dH<NL>(k, L, Zr, Pe, al, g_a, piER, zER, zEL));
        hR = T(0.5) * (dH_int(al[k], Pe[k], Pe[k + 1], piER[k], piER[k + 1]) +
                       overlap_dH<NL>(k, L, Zr, Pe, al, g_a, piEL, zEL, zER));
        if (L > 1) {
          // Hc at interface i (1..L-1): 1/2 alpha[i-1] pinc (2 pf + pinc)
          T cL = T(0), cR = T(0), bL = T(0), bR = T(0);
          if (k < L - 1) {     // the interface below layer k: -Hc(k+1)
            const int i = k + 1;
            const T pL = g_a[i - 1] * (zFL[i] - zEL[i]), pR = g_a[i - 1] * (zFR[i] - zER[i]);
            const T fL = Pe[i] + piFL[i], fR = Pe[i] + piFR[i];
            cL = -(((T(0.5) * al[i - 1]) * pL) * (T(2) * fL + pL));
            cR = -(((T(0.5) * al[i - 1]) * pR) * (T(2) * fR + pR));
          }
          if (k > 0) {         // the interface above layer k: +Hc(k)
            const int i = k;
            const T pL = g_a[i - 1] * (zFL[i] - zEL[i]), pR = g_a[i - 1] * (zFR[i] - zER[i]);
            const T fL = Pe[i] + piFL[i], fR = Pe[i] + piFR[i];
            bL = ((T(0.5) * al[i - 1]) * pL) * (T(2) * fL + pL);
            bR = ((T(0.5) * al[i - 1]) * pR) * (T(2) * fR + pR);
          }
          hL = hL + (cL + bL);
          hR = hR + (cR + bR);
        }
      }
      dHL[k] = hL;
      dHR[k] = hR;
      sdL = sdL + hL;
      sdR = sdR + hR;
    }

    // ---- match the vertical sum to the barotropic average, integrands --------
    const T dHb = D.fa[kDH][fq], Hedge = D.geo[kHedge][fq];
    const T sL_full = Hedge + sdL, sR_full = Hedge + sdR;
    const T w1L = sL_full > T(0) ? (dHb - sdL) / sL_full : T(0);
    const T w1R = sR_full > T(0) ? (dHb - sdR) / sR_full : T(0);
    const int slot = lf * nq + q, out_plane = fpb * nq;
#pragma unroll (Tier::unroll)
    for (int k = 0; k < Tier::trips(L); ++k) {
      if (k >= L) continue;
      const T hL = dHL[k] + (Hk[k] + dHL[k]) * w1L;
      const T hR = dHR[k] + (Hk[k] + dHR[k]) * w1R;
      s_red[(0 * L + k) * out_plane + slot] = jac * (nx * hL + flux_x[k]);
      s_red[(1 * L + k) * out_plane + slot] = jac * (nx * hR + flux_x[k]);
      s_red[(2 * L + k) * out_plane + slot] = jac * (ny * hL + flux_y[k]);
      s_red[(3 * L + k) * out_plane + slot] = jac * (ny * hR + flux_y[k]);
    }
  }
  __syncthreads();

  // ---- integration against the edge basis: one thread an output value -------
  const int per = nf * ngl;
  for (int i = tid; i < NOUT * L * per; i += nthreads) {
    const int jk = i / per, m = i - jk * per;
    const int j = jk / L, k = jk - j * L;
    const int f = m / ngl, n = m - f * ngl;
    const T* g = s_red + jk * fpb * nq + f * nq;
    const T* p = s_psi + n * nq;
    T s = g[0] * p[0];
    for (int qq = 1; qq < nq; ++qq) s = s + g[qq] * p[qq];
    D.out[j][k * plane + size_t(f0) * ngl + m] = s;
  }
}

// the build for at most NL layers, at compile-time sizes NGL_ x NQ_ (0: at run time)
template <typename T, int NGL_, int NQ_, int NL>
cudaError_t run(const Args<T>& a, int blocks, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcl_flux_kernel<T, NGL_, NQ_, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  bcl_flux_kernel<T, NGL_, NQ_, NL><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int L, int ngl, int nq, int Fx, int Fy, const void* const* ptrs,
                   const void* alpha, const void* psiq, double grav, cudaStream_t stream) {
  if (L < 1 || L > LMAX || nq < 1 || nq > MAX_THREADS || ngl < 2 || ngl > 64 ||
      Fx < 0 || Fy < 0)
    return cudaErrorInvalidValue;
  const int fpb = faces_per_block<T>(L, ngl, nq);
  if (fpb < 1) return cudaErrorInvalidValue;
  Args<T> a;
  const int F[2] = {Fx, Fy};
  for (int d = 0; d < 2; ++d) {
    const void* const* p = ptrs + d * NPTR;
    for (int i = 0; i < NTR; ++i) a.d[d].tr[i] = static_cast<const T*>(p[i]);
    for (int i = 0; i < NFA; ++i) a.d[d].fa[i] = static_cast<const T*>(p[NTR + i]);
    for (int i = 0; i < NGEO; ++i) a.d[d].geo[i] = static_cast<const T*>(p[NTR + NFA + i]);
    for (int i = 0; i < NOUT; ++i)
      a.d[d].out[i] = static_cast<T*>(const_cast<void*>(p[NTR + NFA + NGEO + i]));
    a.d[d].F = F[d];
    a.d[d].blocks = (F[d] + fpb - 1) / fpb;
  }
  a.alpha = static_cast<const T*>(alpha);
  a.psiq = static_cast<const T*>(psiq);
  a.grav = T(grav);
  a.L = L;
  a.ngl = ngl;
  a.nq = nq;
  a.fpb = fpb;
  const int blocks = a.d[0].blocks + a.d[1].blocks;
  if (blocks == 0) return cudaSuccess;
  const int threads = (fpb * nq + 31) / 32 * 32;
  const size_t smem = smem_bytes<T>(L, ngl, nq, fpb);
  if (L <= LMAX_REG) {
    if (ngl == 5 && nq == 9)   // the main path's sizes (p=4, exact integration)
      return run<T, 5, 9, LMAX_REG>(a, blocks, threads, smem, stream);
    return run<T, 0, 0, LMAX_REG>(a, blocks, threads, smem, stream);
  }
  if (L <= LMAX_MID) return run<T, 0, 0, LMAX_MID>(a, blocks, threads, smem, stream);
  return run<T, 0, 0, LMAX>(a, blocks, threads, smem, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; does not synchronise. `ptrs`: for the x-faces, then the
// y-faces, the 6 traces, 14 face averages, 9 face tables and 4 outputs in
// the order of ops/bcl_flux. Returns the launch's cudaError_t.
int bcl_flux_launch(int is_double, int L, int ngl, int nq, int Fx, int Fy,
                    const void* const* ptrs, const void* alpha, const void* psiq,
                    double grav, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_double ? launch<double>(L, ngl, nq, Fx, Fy, ptrs, alpha, psiq, grav, s)
                       : launch<float>(L, ngl, nq, Fx, Fy, ptrs, alpha, psiq, grav, s));
}

// Faces a block of the launch takes; 0 where one face's staging does not fit
// in a block's shared memory, and the launch would be refused.
int bcl_flux_faces_per_block(int is_double, int L, int ngl, int nq) {
  return is_double ? faces_per_block<double>(L, ngl, nq) : faces_per_block<float>(L, ngl, nq);
}

const char* bcl_flux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
