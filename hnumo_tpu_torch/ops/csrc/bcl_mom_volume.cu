// Layer-momentum volume term of the baroclinic step, one launch a call, CUDA
// C++ for sm_90a (NVIDIA Hopper).
//
// The body of core/bcl.layer_momentum_volume (reference
// create_rhs_dynamics_volume_layers, src/mod_create_rhs_mlswe.F90:281-456);
// its plain version is ops/bcl_mom_volume.bcl_mom_volume_plain, whose
// arithmetic this kernel repeats operation for operation, summing the
// tensor-product contractions in another order. It replaces no TPU kernel:
// the JAX package leaves this function to XLA's fusion. In plain PyTorch it is
// ~190 operations a call on tensors of a few tens of thousands of values,
// each a launch of ~1.4 us on the card; here it is one launch. Per element
// and quad point, over the L layers of the column:
//   - the delta-form interface elevation zeta at the nodes (the reverse
//     cumulative sum of ddz) and its gradient at the quad point,
//   - the interpolation of (ddp', u', v') and of (u dp, v dp) to the point,
//   - the conditioned interface-pressure cumsum pi and the layer dH,
//   - the momentum-flux consistency weights and the pressure-force weight,
//   - the wind and bottom-stress distribution (the documented cumulative
//     prime pressure, or the reference's verbatim slip under `compat`),
//   - the interface-slope source,
// and per element the weak-form integral of (dHq + var_uu, var_uv, source_x)
// and (var_vu, dHq + var_vv, source_y) against the basis: rhs (2, L, E,
// ngl, ngl), without the inverse mass.
//
// What bounds it on this card: latency. At the 25x25 main path a launch has
// 625 elements x 81 quad points (50,625 columns) and moves ~1.7 MB in f32:
// half a microsecond of bytes, one wave of threads. What the design does:
//   - one thread a (element, quad point) carries the column's L layers:
//     the cumsums and the layer sums run in the thread, with no barrier.
//     Up to LMAX_REG layers the column is in registers (the layer loops
//     unrolled, the layers past L skipped); above it, up to LMAX_MID and
//     then up to LMAX, in arrays of that size in local memory;
//   - a block takes EPB whole elements (EPB * nq^2 <= TARGET_THREADS, so the
//     25x25 launch is 209 blocks of 243 threads: one wave on 132 SMs). Layer
//     by layer it stages the elements' nodal inputs in shared memory, where
//     each thread interpolates them to its point (sum-factorised within the
//     thread: a row of the basis, then a column), and, after the column's
//     work, stages the six weak-form integrands, contracts them over the
//     quad points in two sum-factorised passes and writes each output value
//     once: no atomics, so the result is the same from run to run;
//   - the basis tables live in shared memory; per-point tables are read
//     once each, neighbouring threads on neighbouring addresses.
// No fast-math.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LMAX_REG = 4;       // the most layers a column carries in registers
constexpr int LMAX_MID = 16;      // ... in the smaller local-memory build
constexpr int LMAX = 64;          // the most layers (ops/bcl_mom_volume.MAX_LAYERS)
constexpr int MAX_NQ = 17;        // the most quad points an element side (ops/bcl_mom_volume.MAX_NQ)
constexpr int MAX_THREADS = 320;  // one thread a quad point of an element: 17 x 17 <= 320
constexpr int TARGET_THREADS = 256;
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may opt in to
constexpr double EPS1 = 1.0e-20;  // ops/bcl_flux.EPS1 (reference eps1)

// The layer loops of a build for at most NL layers (as in bcl_flux.cu): in
// registers a loop makes all NL trips, the layers past L skipped with
// `continue` so that the trip count stays exact, and unrolls wholly; in
// local memory a loop makes L trips and does not unroll.
template <int NL>
struct LayerTier {
  static constexpr bool in_registers = NL <= LMAX_REG;
  static constexpr int unroll = in_registers ? NL : 1;
  __device__ __forceinline__ static int trips(int L) { return in_registers ? NL : L; }
};

// operands, in the order of ops/bcl_mom_volume.OPERANDS
enum {
  kQp,      // qprime_df (3, L, E, n2): ddp', u', v'
  kQd,      // q_df (3, L, E, n2): channels 1, 2 (u dp, v dp) read
  kDrefDf,  // P.dpp_ref_df (L, E, n2)
  kMu2Df,   // avg.mu2_df (E, n2)
  kMu2, kMu, kUb, kVb, kQu, kQuv, kQv, kDH, kTbU, kTbV,   // avg (E, q2)
  kHref,    // P.H_bcl_ref (E, q2)
  kPbp,     // P.pbprime (E, q2)
  kTau,     // P.tau_wind (2, E, q2)
  kDrefQ,   // P.dpp_ref_q (L, E, q2)
  kHk,      // P.Hk_ref_q (L, E, q2)
  kPref,    // P.P_ref_q (L+1, E, q2)
  kGzRef,   // P.gz_ref (2, L+1, E, q2)
  kKsx, kKsy, kEtx, kEty, kWjac,  // g.ksiq_x, ksiq_y, etaq_x, etaq_y, wjac (E, q2)
  kAlpha,   // P.alpha (L)
  kPsi,     // g.psiq (ngl, nq)
  kDpsi,    // g.dpsiq (ngl, nq)
  NIN
};
constexpr int NNOD = 6;   // staged nodal fields: ddp', u', v', u dp, v dp, zeta
constexpr int NA = 6;     // weak-form integrands: (ksi, eta, source) of u and of v

template <typename T>
struct Args {
  const T* in[NIN];
  T* out;       // (2, L, E, n2)
  T grav, Ps, Pb;
  int L, ngl, nq, E, epb, compat;
};

template <typename T>
size_t smem_bytes(int ngl, int nq, int epb) {
  return sizeof(T) * (size_t(2) * ngl * nq + size_t(epb) * (NNOD * ngl * ngl + NA * nq * nq +
                                                            4 * nq * ngl));
}

// elements a block takes: TARGET_THREADS / nq^2 (at least one), or as many as
// fit in SMEM_MAX; 0 where not even one fits
template <typename T>
int elements_per_block(int ngl, int nq) {
  const int q2 = nq * nq;
  const int want = q2 >= TARGET_THREADS ? 1 : TARGET_THREADS / q2;
  int epb = 0;
  while (epb < want && smem_bytes<T>(ngl, nq, epb + 1) <= SMEM_MAX) ++epb;
  return epb;
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

// the most threads a block of the build for NQ_ quad points (0: at run time)
// has: a build whose elements fit TARGET_THREADS keeps that bound, which
// leaves a thread up to 255 registers (under a bound of 320 ptxas held the
// f64 <5,9,4> build to 168 registers, and it spilled)
constexpr int max_threads(int nq) {
  return nq && nq * nq <= TARGET_THREADS ? TARGET_THREADS : MAX_THREADS;
}

// NL: the most layers this build carries (LMAX_REG, LMAX_MID or LMAX);
// NGL_, NQ_: compile-time sizes, 0 at run time
template <typename T, int NGL_, int NQ_, int NL>
__global__ void __launch_bounds__(max_threads(NQ_))
bcl_mom_volume_kernel(const __grid_constant__ Args<T> a) {
  using Tier = LayerTier<NL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ngl = NGL_ ? NGL_ : a.ngl;
  const int nq = NQ_ ? NQ_ : a.nq;
  const int n2 = ngl * ngl, q2 = nq * nq;
  const int L = a.L, E = a.E, epb = a.epb;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int e0 = blockIdx.x * epb;
  const int nel = min(epb, E - e0);

  T* s_psi = smem;                         // (ngl, nq)
  T* s_dpsi = s_psi + ngl * nq;            // (ngl, nq)
  T* s_nod = s_dpsi + ngl * nq;            // (NNOD, epb, n2)
  T* s_A = s_nod + NNOD * epb * n2;        // (NA, epb, q2)
  T* s_T = s_A + NA * epb * q2;            // (epb, 2 outputs, 2 tables, nq, ngl)

  for (int i = tid; i < ngl * nq; i += nthreads) {
    s_psi[i] = a.in[kPsi][i];
    s_dpsi[i] = a.in[kDpsi][i];
  }

  // this thread's quad point (le, J, I) and nodal point (ln, n)
  const int le = tid / q2, p = tid - le * q2;
  const int J = p / nq, I = p - J * nq;
  const bool active = le < nel;
  const int e = e0 + le;
  const size_t EQ = size_t(E) * q2, EN = size_t(E) * n2;
  const size_t pt = size_t(e) * q2 + p;    // this point in an (E, q2) table
  const int ln = tid / n2, n = tid - ln * n2;
  const bool node = ln < nel;
  const size_t nd = size_t(e0 + ln) * n2 + n;   // this node in an (E, n2) table

  // ---- stage the nodes layer by layer (bottom up: zeta's reverse cumsum) -----
  // sq_ope_df - 1, conditioned: mu2 / (1 + sqrt(1 + mu2))
  T s_df = T(0), sq_df = T(1), zrun = T(0);
  if (node) {
    const T mu2 = a.in[kMu2Df][nd];
    s_df = mu2 / (T(1) + sqrt(T(1) + mu2));
    sq_df = T(1) + s_df;
  }
  T qp0[NL], qp1[NL], qp2[NL], udq[NL], vdq[NL];
  T gzx[NL + 1], gzy[NL + 1];   // gradient of zeta at interface k; zeta[L] = 0
#pragma unroll
  for (int k = 0; k <= NL; ++k) gzx[k] = gzy[k] = T(0);
  T last0 = T(0), last1 = T(0), last2 = T(0);   // ddp', u', v' of layer L-1 (compat)
  const T ksx = active ? a.in[kKsx][pt] : T(0), ksy = active ? a.in[kKsy][pt] : T(0);
  const T etx = active ? a.in[kEtx][pt] : T(0), ety = active ? a.in[kEty][pt] : T(0);
  __syncthreads();   // the basis is staged

#pragma unroll (Tier::unroll)
  for (int k = Tier::trips(L) - 1; k >= 0; --k) {
    if (k >= L) continue;
    if (node) {
      const size_t off = size_t(k) * EN + nd;
      const T v0 = a.in[kQp][off];
      const T dz = (a.in[kAlpha][k] / a.grav) * (s_df * a.in[kDrefDf][off] + sq_df * v0);
      zrun = zrun + dz;
      T* s = s_nod + ln * n2 + n;
      const size_t fplane = size_t(epb) * n2;
      s[0 * fplane] = v0;
      s[1 * fplane] = a.in[kQp][size_t(L) * EN + off];
      s[2 * fplane] = a.in[kQp][2 * size_t(L) * EN + off];
      s[3 * fplane] = a.in[kQd][size_t(L) * EN + off];
      s[4 * fplane] = a.in[kQd][2 * size_t(L) * EN + off];
      s[5 * fplane] = zrun;
    }
    __syncthreads();
    if (active) {
      // v[f] = sum_j psi[j,J] sum_i u_f[j,i] psi[i,I]; zeta's d_ksi takes
      // dpsi on i, its d_eta dpsi on j
      T v[NNOD], dk = T(0);
#pragma unroll
      for (int f = 0; f < NNOD; ++f) v[f] = T(0);
      T de = T(0);
      const T* nb = s_nod + le * n2;
      const size_t fplane = size_t(epb) * n2;
      for (int j = 0; j < ngl; ++j) {
        T r[NNOD], rd = T(0);
#pragma unroll
        for (int f = 0; f < NNOD; ++f) r[f] = T(0);
        for (int i = 0; i < ngl; ++i) {
          const T pi_ = s_psi[i * nq + I];
#pragma unroll
          for (int f = 0; f < NNOD; ++f) r[f] = r[f] + nb[f * fplane + j * ngl + i] * pi_;
          rd = rd + nb[5 * fplane + j * ngl + i] * s_dpsi[i * nq + I];
        }
        const T pj = s_psi[j * nq + J], dpj = s_dpsi[j * nq + J];
#pragma unroll
        for (int f = 0; f < NNOD; ++f) v[f] = v[f] + pj * r[f];
        dk = dk + pj * rd;
        de = de + dpj * r[5];
      }
      qp0[k] = v[0];
      qp1[k] = v[1];
      qp2[k] = v[2];
      udq[k] = v[3];
      vdq[k] = v[4];
      gzx[k] = dk * ksx + de * etx;
      gzy[k] = dk * ksy + de * ety;
      if (k == L - 1) {
        last0 = v[0];
        last1 = v[1];
        last2 = v[2];
      }
    }
    __syncthreads();
  }

  // ---- the column's layer sums ----------------------------------------------
  T mu2 = T(0), mu = T(0), ub = T(0), vb = T(0);
  T uu_def = T(0), uv_def = T(0), vv_def = T(0), w1 = T(0), stu = T(0), stv = T(0);
  T sq = T(1), s_q = T(0);
  if (active) {
    mu2 = a.in[kMu2][pt];
    mu = a.in[kMu][pt];
    ub = a.in[kUb][pt];
    vb = a.in[kVb][pt];
    s_q = mu2 / (T(1) + sqrt(T(1) + mu2));
    sq = T(1) + s_q;
    T pi_l = T(0), suu = T(0), suv = T(0), svv = T(0), sdH = T(0);
#pragma unroll (Tier::unroll)
    for (int k = 0; k < Tier::trips(L); ++k) {
      if (k >= L) continue;
      const T dr = a.in[kDrefQ][size_t(k) * EQ + pt];
      const T dinc = s_q * dr + sq * qp0[k];
      pi_l = pi_l + dinc;
      const T pi_u = pi_l - dinc;
      const T Pu = a.in[kPref][size_t(k) * EQ + pt], Pl = a.in[kPref][size_t(k + 1) * EQ + pt];
      sdH = sdH + a.in[kAlpha][k] * ((Pl * pi_l - Pu * pi_u) + T(0.5) * (pi_l * pi_l - pi_u * pi_u));
      const T dp = (dr + qp0[k]) * (T(1) + mu);
      const T u = qp1[k] + ub, v = qp2[k] + vb;
      suu = suu + dp * u * u;
      suv = suv + dp * u * v;
      svv = svv + dp * v * v;
      stu = stu + (fabs(udq[k]) + T(EPS1));
      stv = stv + (fabs(vdq[k]) + T(EPS1));
    }
    uu_def = a.in[kQu][pt] - suu;
    uv_def = a.in[kQuv][pt] - suv;
    vv_def = a.in[kQv][pt] - svv;
    const T sumH_full = a.in[kHref][pt] + sdH;
    w1 = sumH_full > T(0) ? (a.in[kDH][pt] - sdH) / sumH_full : T(0);
  }

  // ---- layer by layer: the integrands, then their weak-form integral --------
  const T wj = active ? a.in[kWjac][pt] : T(0);
  T pi_l = T(0), pp = T(0);
  const int tq = nq * ngl;                  // one (nq, ngl) table
#pragma unroll (Tier::unroll)
  for (int k = 0; k < Tier::trips(L); ++k) {
    if (k >= L) continue;
    if (active) {
      const T dr = a.in[kDrefQ][size_t(k) * EQ + pt];
      const T dinc = s_q * dr + sq * qp0[k];
      pi_l = pi_l + dinc;
      const T pi_u = pi_l - dinc;
      const T Pu = a.in[kPref][size_t(k) * EQ + pt], Pl = a.in[kPref][size_t(k + 1) * EQ + pt];
      const T al = a.in[kAlpha][k];
      const T dH_tmp = al * ((Pl * pi_l - Pu * pi_u) + T(0.5) * (pi_l * pi_l - pi_u * pi_u));
      const T dp = (dr + qp0[k]) * (T(1) + mu);
      const T u = qp1[k] + ub, v = qp2[k] + vb;
      const T u_udp = dp * u * u, v_vdp = dp * v * v, uv_dp = dp * u * v;
      const T wu = (fabs(udq[k]) + T(EPS1)) / stu;
      const T wv = (fabs(vdq[k]) + T(EPS1)) / stv;
      const T var_uu = u_udp + wu * uu_def;
      const T var_uv = uv_dp + wu * uv_def;
      const T var_vu = uv_dp + wv * uv_def;
      const T var_vv = v_vdp + wv * vv_def;
      const T dHq = dH_tmp + (a.in[kHk][size_t(k) * EQ + pt] + dH_tmp) * w1;

      // the k-th increment of the cumulative prime pressure
      T comp;
      if (a.compat)   // the reference's slip: (full dp', u', v') of layer L-1
        comp = k == 0 ? a.in[kDrefQ][size_t(L - 1) * EQ + pt] + last0 : (k == 1 ? last1 : last2);
      else
        comp = dr + qp0[k];
      const T pp_lower = pp + comp;
      const T pp_upper = pp_lower - comp;
      pp = pp_lower;
      const T temp1 = (tmin(pp_lower, a.Ps) - tmin(pp_upper, a.Ps)) / a.Ps;
      const T tau_u = temp1 * a.in[kTau][pt];
      const T tau_v = temp1 * a.in[kTau][EQ + pt];
      const T pbp = a.in[kPbp][pt];
      const T tempbot = (tmin(pbp - pp_lower, a.Pb) - tmin(pbp - pp_upper, a.Pb)) / a.Pb;

      // interface-slope source, dynamic part: P_ref gzeta + pi gz
      const size_t gu = size_t(k) * EQ + pt, gl = size_t(k + 1) * EQ + pt;
      const size_t gy = size_t(L + 1) * EQ;
      const T* gz_ref = a.in[kGzRef];
      const T src_x = a.grav * (((((tau_u - tempbot * a.in[kTbU][pt]) + Pu * gzx[k]) +
                                  pi_u * (gz_ref[gu] + gzx[k])) - Pl * gzx[k + 1]) -
                                pi_l * (gz_ref[gl] + gzx[k + 1]));
      const T src_y = a.grav * (((((tau_v - tempbot * a.in[kTbV][pt]) + Pu * gzy[k]) +
                                  pi_u * (gz_ref[gy + gu] + gzy[k])) - Pl * gzy[k + 1]) -
                                pi_l * (gz_ref[gy + gl] + gzy[k + 1]));

      const T fxu = dHq + var_uu, fyu = var_uv;
      const T fxv = var_vu, fyv = dHq + var_vv;
      const size_t aplane = size_t(epb) * q2;
      T* s = s_A + le * q2 + p;
      s[0 * aplane] = wj * (fxu * ksx + fyu * ksy);
      s[1 * aplane] = wj * (fxu * etx + fyu * ety);
      s[2 * aplane] = wj * src_x;
      s[3 * aplane] = wj * (fxv * ksx + fyv * ksy);
      s[4 * aplane] = wj * (fxv * etx + fyv * ety);
      s[5 * aplane] = wj * src_y;
    }
    __syncthreads();

    // pass 1, over I: T1[J,i] = sum_I (A_ksi dpsi[i,I] + A_s psi[i,I]),
    // T2[J,i] = sum_I A_eta psi[i,I], for each element and output
    for (int x = tid; x < nel * 4 * tq; x += nthreads) {
      const int lt = x / tq, m = x - lt * tq;      // lt = (element, output, table)
      const int el = lt >> 2, o = (lt >> 1) & 1, t = lt & 1;
      const int Jq = m / ngl, i = m - Jq * ngl;
      const size_t aplane = size_t(epb) * q2;
      const T* A = s_A + (3 * o) * aplane + el * q2 + Jq * nq;
      const T* ps = s_psi + i * nq;
      T acc = T(0);
      if (t == 0) {
        const T* dps = s_dpsi + i * nq;
        const T* As = A + 2 * aplane;
        for (int Iq = 0; Iq < nq; ++Iq) acc = acc + (A[Iq] * dps[Iq] + As[Iq] * ps[Iq]);
      } else {
        const T* Ae = A + aplane;
        for (int Iq = 0; Iq < nq; ++Iq) acc = acc + Ae[Iq] * ps[Iq];
      }
      s_T[lt * tq + m] = acc;
    }
    __syncthreads();

    // pass 2, over J: out[j,i] = sum_J psi[j,J] T1[J,i] + dpsi[j,J] T2[J,i]
    for (int x = tid; x < nel * 2 * n2; x += nthreads) {
      const int lo = x / n2, m = x - lo * n2;      // lo = (element, output)
      const int el = lo >> 1, o = lo & 1;
      const int j = m / ngl, i = m - j * ngl;
      const T* T1 = s_T + (2 * lo) * tq + i;
      const T* T2 = T1 + tq;
      const T* ps = s_psi + j * nq;
      const T* dps = s_dpsi + j * nq;
      T acc = T(0);
      for (int Jq = 0; Jq < nq; ++Jq) acc = acc + (ps[Jq] * T1[Jq * ngl] + dps[Jq] * T2[Jq * ngl]);
      a.out[(size_t(o) * L + k) * EN + size_t(e0 + el) * n2 + m] = acc;
    }
    // the next layer's integrands go to s_A, which pass 1 has finished
    // reading; its pass 1 writes s_T after the barrier that follows them
  }
}

// the build for at most NL layers, at compile-time sizes NGL_ x NQ_ (0: at run time)
template <typename T, int NGL_, int NQ_, int NL>
cudaError_t run(const Args<T>& a, int blocks, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcl_mom_volume_kernel<T, NGL_, NQ_, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  bcl_mom_volume_kernel<T, NGL_, NQ_, NL><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int L, int ngl, int nq, int E, int compat, const void* const* ptrs,
                   void* out, double grav, double Ps, double Pb, cudaStream_t stream) {
  if (L < 1 || L > LMAX || nq < 2 || nq > MAX_NQ || ngl < 2 || ngl > nq || E < 0 ||
      (compat && L > 3))
    return cudaErrorInvalidValue;
  const int epb = elements_per_block<T>(ngl, nq);
  if (epb < 1) return cudaErrorInvalidValue;
  Args<T> a;
  for (int i = 0; i < NIN; ++i) a.in[i] = static_cast<const T*>(ptrs[i]);
  a.out = static_cast<T*>(out);
  a.grav = T(grav);
  a.Ps = T(Ps);
  a.Pb = T(Pb);
  a.L = L;
  a.ngl = ngl;
  a.nq = nq;
  a.E = E;
  a.epb = epb;
  a.compat = compat;
  const int blocks = (E + epb - 1) / epb;
  if (blocks == 0) return cudaSuccess;
  const int threads = (epb * nq * nq + 31) / 32 * 32;
  const size_t smem = smem_bytes<T>(ngl, nq, epb);
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

// Launch on `stream`; does not synchronise. `ptrs`: the NIN operands in the
// order of ops/bcl_mom_volume.OPERANDS; `out`: (2, L, E, ngl, ngl). Returns the
// launch's cudaError_t.
int bcl_mom_volume_launch(int is_double, int L, int ngl, int nq, int E, int compat,
                          const void* const* ptrs, void* out, double grav, double Ps,
                          double Pb, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_double ? launch<double>(L, ngl, nq, E, compat, ptrs, out, grav, Ps, Pb, s)
                       : launch<float>(L, ngl, nq, E, compat, ptrs, out, grav, Ps, Pb, s));
}

// Elements a block of the launch takes; 0 where one element's staging does
// not fit in a block's shared memory, and the launch would be refused.
int bcl_mom_volume_elements_per_block(int is_double, int ngl, int nq) {
  return is_double ? elements_per_block<double>(ngl, nq) : elements_per_block<float>(ngl, nq);
}

const char* bcl_mom_volume_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bcl_mom_volume_operand_count() { return NIN; }

}  // extern "C"
