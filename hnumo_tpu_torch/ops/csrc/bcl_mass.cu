// Thickness update of the baroclinic step, two launches a call, CUDA C++ for
// sm_90a (NVIDIA Hopper).
//
// The body of core/stepper._thickness_update (reference thickness and
// momentum_mass, mass part, src/mod_splitting.F90:55-87, 220-235); its plain
// version is ops/bcl_mass.bcl_mass_plain, whose arithmetic these kernels
// repeat operation for operation, summing the tensor-product contractions in
// another order. They replace no TPU kernel: the JAX package leaves these
// functions to XLA's fusion. In plain PyTorch the update is ~255 operations a
// call on tensors of a few tens of thousands of values, each a launch of
// ~1.8 us on the card; here it is two launches, with the dp' face traces
// built between them by core/faces.extract_faces (where a decomposition's
// halo exchange stays, outside any kernel).
//
//   stage 0, bcl_mass_update_kernel (layer_mass_rhs, the update, the check):
//     per layer, the interpolation of (ddp', u', v') to the quad points, the
//     layer mass fluxes (u dp, v dp) and their weak-form integral, the upwind
//     face fluxes from the (ddp', u', v') traces and their face-quadrature
//     scatter into the element's edges, the inverse mass, and
//     q_df[0] + dt * rhs; the layer sums of the mass fluxes at the quad
//     points (slmf) and at the faces (slmf_face); the full-thickness check
//     ddp_ref + q_df[0] >= 0 of every node, and-reduced over the block into
//     one flag a block; then, per node, eta_t from the layer sum of the new
//     ddp and the new ddp' that the consistency's weights and traces take.
//   stage 1, bcl_mass_consistency_kernel (apply_consistency): per layer, the
//     weights of the new dp' at the quad points against the deficit of the
//     barotropic mass flux and its weak-form integral, the deficit's face
//     flux upwinded by its own sign from the dp' traces, and
//     q_df[0] + dt * massinv * rhs.
//
// Mass conservation: a face's scatter values go to both of its elements, -S
// to the L side and +S to the R side. Each element computes the faces of its
// own edges, so a face between two elements is computed twice; both
// computations run the same instructions (one loop over an element's four
// faces, its face selected by index) on the same operands in the same order,
// and give the same bits. Each face's layer sums are written once, by the
// element on its R side (by the element on its L side at the last face of a
// row or column).
//
// What bounds them on this card: latency. At the 25x25 main path a launch has
// 625 elements x 81 quad points x 2 layers and moves ~1 MB in f32: a third of
// a microsecond of bytes, one wave of threads. What the design does:
//   - one thread a (element, quad point), and one a (element, node), carry
//     the layer loop. The layers are streamed one at a time and nothing of a
//     layer is kept after its turn but the running layer sums, so a column of
//     any number of layers (up to LMAX, the limit of bcl_flux.cu) runs the same
//     build with the same registers: no per-layer array, in registers or in
//     local memory;
//   - a block takes EPB whole elements (EPB * nq^2 <= TARGET_THREADS, so the
//     25x25 launch is 209 blocks of 243 threads: one wave on 132 SMs). Layer
//     by layer it stages the elements' nodal inputs and their four faces'
//     traces in shared memory; each thread interpolates them to its quad point
//     or face quad point (sum-factorised within the thread), and the
//     weak-form integral and the face scatters are contracted in shared memory
//     in two sum-factorised passes; each output value is written once, with
//     no atomics, so the result is the same from run to run;
//   - the basis tables live in shared memory; per-point tables are read once
//     each, neighbouring threads on neighbouring addresses.
// No fast-math.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LMAX = 64;          // the most layers (ops/bcl_mass.MAX_LAYERS)
constexpr int MAX_NQ = 17;        // the most quad points an element side (ops/bcl_mass.MAX_NQ)
constexpr int MAX_THREADS = 320;  // one thread a quad point of an element: 17 x 17 <= 320
constexpr int TARGET_THREADS = 256;
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may opt in to

// element operands, in the order of ops/bcl_mass.ELEMENT_OPERANDS
enum {
  kQp,      // qprime_df (3, L, E, n2): ddp', u', v'
  kQd,      // q_df (3, L, E, n2)
  kDrefDf,  // P.dpp_ref_df (L, E, n2)
  kResid,   // P.sum_ref_residual (E, n2)
  kOopb,    // P.one_over_pbprime_df (E, n2)
  kMinv,    // g.massinv (E, n2)
  kDrefQ,   // P.dpp_ref_q (L, E, q2)
  kPbp,     // P.pbprime (E, q2)
  kMu, kUb, kVb, kMfU, kMfV,      // avg.mu, ub, vb, mfU, mfV (E, q2)
  kKsx, kKsy, kEtx, kEty, kWjac,  // g.ksiq_x, ksiq_y, etaq_x, etaq_y, wjac (E, q2)
  kPsi,     // g.psiq (ngl, nq)
  kDpsi,    // g.dpsiq (ngl, nq)
  NEL
};
// face operands of one direction, in the order of ops/bcl_mass.FACE_OPERANDS,
// those of the x-faces at NEL, those of the y-faces at NEL + NFD
enum {
  fDL, fDR, fUL, fUR, fVL, fVR,   // the (ddp', u', v') traces, L and R (L, F, ngl)
  fUbL, fUbR, fVbL, fVbR, fMuL, fMuR, fFluxU, fFluxV,  // avg.faces (F, nq)
  fNx, fNy, fJac, fPbL, fPbR,     // P.faces nx, ny, jac, pbprime_face_L, _R (F, nq)
  fDrefF,                         // P.faces dpp_ref_face_q (L, F, nq)
  NFD
};
constexpr int NIN = NEL + 2 * NFD;

template <typename T>
struct Args {
  const T* in[NIN];
  const T* ctr[2][2];     // the new dp' traces (L, F, ngl) [x, y][L, R]: stage 1
  T* out;                 // (3, L, E, n2): the new q_df
  T* dpp;                 // (L, E, n2): the new ddp' (stage 0 writes, stage 1 reads)
  T* slmf;                // (2, E, q2): the layer sums of (u dp, v dp) at the quad points
  T* sface[2];            // (2, F, nq) [x, y]: the layer sums of the face fluxes
  unsigned char* flags;   // (blocks,): 1 where every node of the block's elements is >= 0
  T dt;
  int L, ngl, nq, ly, lx, epb, xwall, ywall;
};

// both stages run with one layout of shared memory (stage 0's, the larger)
template <typename T>
size_t smem_bytes(int ngl, int nq, int epb) {
  const size_t n2 = size_t(ngl) * ngl, q2 = size_t(nq) * nq;
  return sizeof(T) * (size_t(2) * ngl * nq +
                      size_t(epb) * (3 * n2 + 4 * 6 * ngl + 2 * q2 + 4 * nq +
                                     2 * size_t(nq) * ngl + 4 * ngl + 2 * 4 * nq));
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

// the most threads a block of the build for NQ_ quad points (0: at run time) has
constexpr int max_threads(int nq) {
  return nq && nq * nq <= TARGET_THREADS ? TARGET_THREADS : MAX_THREADS;
}

// face f (0 west, 1 east, 2 south, 3 north) of element e of a block of
// (ly, lx) elements: its index among the x-faces (ly, lx+1) or the y-faces
// (ly+1, lx)
__device__ __forceinline__ int face_of(int e, int f, int lx) {
  const int ey = e / lx, ex = e - ey * lx;
  switch (f) {
    case 0: return ey * (lx + 1) + ex;
    case 1: return ey * (lx + 1) + ex + 1;
    case 2: return ey * lx + ex;
    default: return (ey + 1) * lx + ex;
  }
}

// faces of direction d (0: x, 1: y) of a block of (ly, lx) elements
__device__ __forceinline__ int faces_of(int d, int ly, int lx) {
  return d == 0 ? ly * (lx + 1) : (ly + 1) * lx;
}

// STAGE 0: the mass update and the check; STAGE 1: the consistency.
// NGL_, NQ_: compile-time sizes, 0 at run time
template <int STAGE, typename T, int NGL_, int NQ_>
__device__ __forceinline__ void thickness_stage(const Args<T>& a) {
  // what a layer stages: the traces of a face, (ddp', u', v') L and R or dp'
  // L and R, and the nodal fields, (ddp', u', v') or dp'
  constexpr int NTR = STAGE == 0 ? 6 : 2;
  constexpr int NNOD = STAGE == 0 ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ngl = NGL_ ? NGL_ : a.ngl;
  const int nq = NQ_ ? NQ_ : a.nq;
  const int n2 = ngl * ngl, q2 = nq * nq, tq = nq * ngl;
  const int L = a.L, lx = a.lx, ly = a.ly, epb = a.epb;
  const int E = ly * lx;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int e0 = blockIdx.x * epb;
  const int nel = min(epb, E - e0);

  T* s_psi = smem;                        // (ngl, nq)
  T* s_dpsi = s_psi + ngl * nq;           // (ngl, nq)
  T* s_nod = s_dpsi + ngl * nq;           // (NNOD, epb, n2)
  T* s_tr = s_nod + 3 * epb * n2;         // (epb, 4 faces, NTR, ngl)
  T* s_A = s_tr + epb * 4 * 6 * ngl;      // (2, epb, q2): the ksi and eta integrands
  T* s_F = s_A + 2 * epb * q2;            // (epb, 4 faces, nq): jac * the normal flux
  T* s_T = s_F + epb * 4 * nq;            // (epb, 2, nq, ngl): pass 1's two tables
  T* s_S = s_T + epb * 2 * tq;            // (epb, 4 faces, ngl): the face scatter values
  T* s_sum = s_S + epb * 4 * ngl;         // (2, epb, 4 faces, nq): the face flux sums

  for (int i = tid; i < ngl * nq; i += nthreads) {
    s_psi[i] = a.in[kPsi][i];
    s_dpsi[i] = a.in[kDpsi][i];
  }

  const size_t EN = size_t(E) * n2, EQ = size_t(E) * q2;
  // this thread's quad point (le, J, I) and node (ln, j, i)
  const int le = tid / q2, p = tid - le * q2;
  const int J = p / nq, I = p - J * nq;
  const bool active = le < nel;
  const size_t pt = size_t(e0 + le) * q2 + p;
  const int ln = tid / n2, n = tid - ln * n2;
  const int j = n / ngl, i = n - j * ngl;
  const bool node = ln < nel;
  const size_t nd = size_t(e0 + ln) * n2 + n;
  const int nface_pts = nel * 4 * nq;      // (element, face, face quad point)

  T ksx = T(0), ksy = T(0), etx = T(0), ety = T(0), wj = T(0);
  T c0 = T(0), c1 = T(0), c2 = T(0);       // stage 0: mu, ub, vb; stage 1: pbprime, deficits
  if (active) {
    ksx = a.in[kKsx][pt];
    ksy = a.in[kKsy][pt];
    etx = a.in[kEtx][pt];
    ety = a.in[kEty][pt];
    wj = a.in[kWjac][pt];
    if constexpr (STAGE == 0) {
      c0 = a.in[kMu][pt];
      c1 = a.in[kUb][pt];
      c2 = a.in[kVb][pt];
    } else {
      c0 = a.in[kPbp][pt];
      c1 = a.in[kMfU][pt] - a.slmf[pt];
      c2 = a.in[kMfV][pt] - a.slmf[EQ + pt];
    }
  }
  T su = T(0), sv = T(0);     // stage 0: the layer sums of (u dp, v dp) at the quad point
  T esum = T(0);              // stage 0: the layer sum of the new ddp at the node
  bool ok = true;             // stage 0: every new full thickness of the node >= 0
  __syncthreads();   // the basis is staged

  for (int k = 0; k < L; ++k) {
    // ---- stage the layer's nodes and its faces' traces ----------------------
    for (int x = tid; x < NNOD * nel * n2; x += nthreads) {
      const int f = x / (nel * n2), r = x - f * nel * n2;
      const T* src = STAGE == 0 ? a.in[kQp] + (size_t(f) * L + k) * EN : a.dpp + size_t(k) * EN;
      s_nod[f * epb * n2 + r] = src[size_t(e0) * n2 + r];
    }
    for (int x = tid; x < nel * 4 * NTR * ngl; x += nthreads) {
      const int m = x % ngl, y = x / ngl;
      const int t = y % NTR, ef = y / NTR;   // ef = element * 4 + face
      const int f = ef & 3, d = f >> 1;
      const T* tr = STAGE == 0 ? a.in[NEL + d * NFD + fDL + t] : a.ctr[d][t];
      s_tr[x] = tr[(size_t(k) * faces_of(d, ly, lx) + face_of(e0 + (ef >> 2), f, lx)) * ngl + m];
    }
    __syncthreads();

    // ---- the volume integrands at this thread's quad point --------------------
    if (active) {
      // v[f] = sum_j psi[j,J] sum_i u_f[j,i] psi[i,I]
      T v[NNOD];
#pragma unroll
      for (int f = 0; f < NNOD; ++f) v[f] = T(0);
      const T* nb = s_nod + le * n2;
      for (int jj = 0; jj < ngl; ++jj) {
        T r[NNOD];
#pragma unroll
        for (int f = 0; f < NNOD; ++f) r[f] = T(0);
        for (int ii = 0; ii < ngl; ++ii) {
          const T pi_ = s_psi[ii * nq + I];
#pragma unroll
          for (int f = 0; f < NNOD; ++f) r[f] = r[f] + nb[f * epb * n2 + jj * ngl + ii] * pi_;
        }
        const T pj = s_psi[jj * nq + J];
#pragma unroll
        for (int f = 0; f < NNOD; ++f) v[f] = v[f] + pj * r[f];
      }
      const T dr = a.in[kDrefQ][size_t(k) * EQ + pt];
      T udp, vdp;
      if constexpr (STAGE == 0) {
        const T dp = (dr + v[0]) * (T(1) + c0);
        udp = (v[1] + c1) * dp;
        vdp = (v[2] + c2) * dp;
        su = su + udp;
        sv = sv + vdp;
      } else {
        const T weight = (dr + v[0]) / c0;
        udp = weight * c1;
        vdp = weight * c2;
      }
      s_A[le * q2 + p] = wj * (udp * ksx + vdp * ksy);
      s_A[(epb + le) * q2 + p] = wj * (udp * etx + vdp * ety);
    }

    // ---- the normal flux at each face quad point of the block's elements ------
    // one code path for the four faces of every element: a face between two
    // elements gives the same bits in both
#pragma unroll 1
    for (int x = tid; x < nface_pts; x += nthreads) {
      const int ef = x / nq, q = x - ef * nq;
      const int f = ef & 3, d = f >> 1;
      const int face = face_of(e0 + (ef >> 2), f, lx);
      const T* const* op = a.in + NEL + d * NFD;
      const size_t fq = size_t(face) * nq + q;
      const size_t nfq = size_t(faces_of(d, ly, lx)) * nq;
      const T* tr = s_tr + ef * NTR * ngl;
      T v[NTR];
#pragma unroll
      for (int t = 0; t < NTR; ++t) v[t] = T(0);
      for (int m = 0; m < ngl; ++m) {
        const T ps = s_psi[m * nq + q];
#pragma unroll
        for (int t = 0; t < NTR; ++t) v[t] = v[t] + tr[t * ngl + m] * ps;
      }
      const T nx = op[fNx][fq], ny = op[fNy][fq];
      const T dref = op[fDrefF][size_t(k) * nfq + fq];
      T feu, fev;
      if constexpr (STAGE == 0) {
        // upwind mass flux (uu, vv) dp of the trace averages
        const T uu = T(0.5) * ((v[2] + op[fUbL][fq]) + (v[3] + op[fUbR][fq]));
        const T vv = T(0.5) * ((v[4] + op[fVbL][fq]) + (v[5] + op[fVbR][fq]));
        const T dpl = (T(1) + op[fMuL][fq]) * (dref + v[0]);
        const T dpr = (T(1) + op[fMuR][fq]) * (dref + v[1]);
        feu = uu * nx > T(0) ? uu * dpl : uu * dpr;
        fev = vv * ny > T(0) ? vv * dpl : vv * dpr;
        T* sum = s_sum + x;
        sum[0] = k ? sum[0] + feu : feu;
        sum[epb * 4 * nq] = k ? sum[epb * 4 * nq] + fev : fev;
      } else {
        // the deficit of the barotropic face flux, upwinded by its own sign
        const T wL = (dref + v[0]) / op[fPbL][fq];
        const T wR = (dref + v[1]) / op[fPbR][fq];
        const T defU = op[fFluxU][fq] - a.sface[d][fq];
        const T defV = op[fFluxV][fq] - a.sface[d][nfq + fq];
        const T dfUL = wL * defU, dfUR = wR * defU;
        const T dfVL = wL * defV, dfVR = wR * defV;
        feu = dfUL * nx > T(0) ? dfUL : dfUR;
        fev = dfVL * ny > T(0) ? dfVL : dfVR;
      }
      s_F[x] = op[fJac][fq] * (nx * feu + ny * fev);
    }
    __syncthreads();

    // ---- pass 1, over I: T1[J,i] = sum_I A_ksi dpsi[i,I], T2[J,i] = sum_I A_eta psi[i,I]
    for (int x = tid; x < nel * 2 * tq; x += nthreads) {
      const int lt = x / tq, m = x - lt * tq;     // lt = (element, table)
      const int el = lt >> 1, t = lt & 1;
      const int Jq = m / ngl, ii = m - Jq * ngl;
      const T* A = s_A + (t * epb + el) * q2 + Jq * nq;
      const T* tab = (t == 0 ? s_dpsi : s_psi) + ii * nq;
      T acc = T(0);
      for (int Iq = 0; Iq < nq; ++Iq) acc = acc + A[Iq] * tab[Iq];
      s_T[lt * tq + m] = acc;
    }
    // ... and each face's scatter values S[m] = sum_q F[q] psi[m,q]
#pragma unroll 1
    for (int x = tid; x < nel * 4 * ngl; x += nthreads) {
      const int ef = x / ngl, m = x - ef * ngl;
      const T* F = s_F + ef * nq;
      const T* ps = s_psi + m * nq;
      T acc = T(0);
      for (int q = 0; q < nq; ++q) acc = acc + F[q] * ps[q];
      s_S[x] = acc;
    }
    __syncthreads();

    // ---- pass 2, over J, the edges, the update: one thread a node -------------
    if (node) {
      const T* T1 = s_T + (2 * ln) * tq + i;
      const T* T2 = T1 + tq;
      const T* ps = s_psi + j * nq;
      const T* dps = s_dpsi + j * nq;
      T val = T(0);
      for (int Jq = 0; Jq < nq; ++Jq) val = val + (ps[Jq] * T1[Jq * ngl] + dps[Jq] * T2[Jq * ngl]);
      // the face scatter (core/faces.scatter_face_x/_y): -S on the east and
      // north edges, +S on the west and south ones, -S at a west or south wall
      const T* S = s_S + ln * 4 * ngl;
      const int e = e0 + ln, ey = e / lx, ex = e - ey * lx;
      if (i == ngl - 1) val = val - S[ngl + j];
      if (i == 0) val = ex == 0 && a.xwall ? val - S[j] : val + S[j];
      if (j == ngl - 1) val = val - S[3 * ngl + i];
      if (j == 0) val = ey == 0 && a.ywall ? val - S[2 * ngl + i] : val + S[2 * ngl + i];
      const T minv = a.in[kMinv][nd];
      const size_t off = size_t(k) * EN + nd;
      if constexpr (STAGE == 0) {
        const T qn = a.in[kQd][off] + a.dt * (minv * val);
        a.out[off] = qn;
        a.out[size_t(L) * EN + off] = a.in[kQd][size_t(L) * EN + off];
        a.out[2 * size_t(L) * EN + off] = a.in[kQd][2 * size_t(L) * EN + off];
        ok = ok && a.in[kDrefDf][off] + qn >= T(0);
        esum = esum + qn;
      } else {
        a.out[off] = a.out[off] + (a.dt * minv) * val;
      }
    }
    // the next layer's staging writes s_nod and s_tr, which this layer has
    // finished reading; its integrands and fluxes follow the barrier after it
  }

  if constexpr (STAGE == 0) {
    // the new ddp' of every layer, from the node's eta_t
    if (node) {
      const T eta = (esum + a.in[kResid][nd]) * a.in[kOopb][nd];
      for (int k = 0; k < L; ++k) {
        const size_t off = size_t(k) * EN + nd;
        a.dpp[off] = (a.out[off] - a.in[kDrefDf][off] * eta) / (T(1) + eta);
      }
    }
    if (active) {
      a.slmf[pt] = su;
      a.slmf[EQ + pt] = sv;
    }
    // each face's flux sums, from the element on its R side, or on its L side
    // at the last face of a row or column
    for (int x = tid; x < nface_pts; x += nthreads) {
      const int ef = x / nq, q = x - ef * nq;
      const int f = ef & 3, d = f >> 1;
      const int e = e0 + (ef >> 2), ey = e / lx, ex = e - ey * lx;
      if ((f == 1 && ex != lx - 1) || (f == 3 && ey != ly - 1)) continue;
      const size_t fq = size_t(face_of(e, f, lx)) * nq + q;
      a.sface[d][fq] = s_sum[x];
      a.sface[d][size_t(faces_of(d, ly, lx)) * nq + fq] = s_sum[epb * 4 * nq + x];
    }
    const int all_ok = __syncthreads_and(ok);
    if (tid == 0) a.flags[blockIdx.x] = all_ok ? 1 : 0;
  }
}

template <typename T, int NGL_, int NQ_>
__global__ void __launch_bounds__(max_threads(NQ_))
bcl_mass_update_kernel(const __grid_constant__ Args<T> a) {
  thickness_stage<0, T, NGL_, NQ_>(a);
}

template <typename T, int NGL_, int NQ_>
__global__ void __launch_bounds__(max_threads(NQ_))
bcl_mass_consistency_kernel(const __grid_constant__ Args<T> a) {
  thickness_stage<1, T, NGL_, NQ_>(a);
}

// the kernel of `stage` at compile-time sizes NGL_ x NQ_ (0: at run time)
template <typename T, int NGL_, int NQ_>
cudaError_t run(int stage, const Args<T>& a, int blocks, int threads, size_t smem,
                cudaStream_t stream) {
  void (*kernel)(Args<T>) = stage == 0 ? bcl_mass_update_kernel<T, NGL_, NQ_>
                                       : bcl_mass_consistency_kernel<T, NGL_, NQ_>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the pointers after the NIN operands, in the order of ops/bcl_mass.bcl_mass_cuda
enum { xOut, xDpp, xSlmf, xSfaceX, xSfaceY, xFlags, xCtrXL, xCtrXR, xCtrYL, xCtrYR, NEXTRA };

template <typename T>
cudaError_t launch(int stage, int L, int ngl, int nq, int ly, int lx, int xwall, int ywall,
                   const void* const* ptrs, double dt, cudaStream_t stream) {
  if (stage < 0 || stage > 1 || L < 1 || L > LMAX || nq < 2 || nq > MAX_NQ || ngl < 2 ||
      ngl > nq || ly < 0 || lx < 0)
    return cudaErrorInvalidValue;
  const int epb = elements_per_block<T>(ngl, nq);
  if (epb < 1) return cudaErrorInvalidValue;
  Args<T> a;
  for (int i = 0; i < NIN; ++i) a.in[i] = static_cast<const T*>(ptrs[i]);
  const void* const* x = ptrs + NIN;
  a.out = static_cast<T*>(const_cast<void*>(x[xOut]));
  a.dpp = static_cast<T*>(const_cast<void*>(x[xDpp]));
  a.slmf = static_cast<T*>(const_cast<void*>(x[xSlmf]));
  a.sface[0] = static_cast<T*>(const_cast<void*>(x[xSfaceX]));
  a.sface[1] = static_cast<T*>(const_cast<void*>(x[xSfaceY]));
  a.flags = static_cast<unsigned char*>(const_cast<void*>(x[xFlags]));
  a.ctr[0][0] = static_cast<const T*>(x[xCtrXL]);
  a.ctr[0][1] = static_cast<const T*>(x[xCtrXR]);
  a.ctr[1][0] = static_cast<const T*>(x[xCtrYL]);
  a.ctr[1][1] = static_cast<const T*>(x[xCtrYR]);
  a.dt = T(dt);
  a.L = L;
  a.ngl = ngl;
  a.nq = nq;
  a.ly = ly;
  a.lx = lx;
  a.epb = epb;
  a.xwall = xwall;
  a.ywall = ywall;
  const int blocks = (ly * lx + epb - 1) / epb;
  if (blocks == 0) return cudaSuccess;
  const int threads = (epb * nq * nq + 31) / 32 * 32;
  const size_t smem = smem_bytes<T>(ngl, nq, epb);
  if (ngl == 5 && nq == 9)   // the main path's sizes (p=4, exact integration)
    return run<T, 5, 9>(stage, a, blocks, threads, smem, stream);
  return run<T, 0, 0>(stage, a, blocks, threads, smem, stream);
}

}  // namespace

extern "C" {

// Launch stage 0 (the mass update and the check) or stage 1 (the
// consistency) on `stream`; does not synchronise. `ptrs`: the NIN operands in
// the order of ops/bcl_mass.OPERANDS, then the NEXTRA pointers above (stage 0
// reads no dp' trace; pass null there). `xwall` / `ywall`: the block's first
// x / y face is a wall whose L side is its first element. Returns the
// launch's cudaError_t.
int bcl_mass_launch(int stage, int is_double, int L, int ngl, int nq, int ly, int lx,
                    int xwall, int ywall, const void* const* ptrs, double dt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_double ? launch<double>(stage, L, ngl, nq, ly, lx, xwall, ywall, ptrs, dt, s)
                       : launch<float>(stage, L, ngl, nq, ly, lx, xwall, ywall, ptrs, dt, s));
}

// Elements a block of either launch takes (so each stage-0 launch writes
// ceil(E / this) flags); 0 where one element's staging does not fit in a
// block's shared memory, and the launch would be refused.
int bcl_mass_elements_per_block(int is_double, int ngl, int nq) {
  return is_double ? elements_per_block<double>(ngl, nq) : elements_per_block<float>(ngl, nq);
}

const char* bcl_mass_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bcl_mass_operand_count() { return NIN; }

}  // extern "C"
