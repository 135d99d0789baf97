// Barotropic-baroclinic coupling coefficients, two launches a call, CUDA C++
// for sm_90a (NVIDIA Hopper).
//
// The body of core/coupling.btp_bcl_coeffs (reference btp_bcl_coeffs_qdf,
// src/mod_barotropic_terms.F90:219-409); its plain version is
// ops/bcl_coeffs.bcl_coeffs_plain, whose arithmetic these kernels repeat
// operation for operation, summing the tensor-product contractions and the
// layer sums in another order. They replace no TPU kernel: the JAX package
// leaves this function to XLA's fusion. In plain PyTorch it is ~200
// operations a call on tensors of a few tens of thousands of values, each a
// launch of ~1.8 us on the card; here it is two launches, with the viscous
// face traces built between them by core/faces.extract_faces_stacked (where
// a decomposition's halo exchange stays, outside any kernel).
//
//   stage 0, bcl_coeffs_nodal_kernel (the element work): per layer, the
//     interpolation of (ddp', u', v') to the quad points, the full dp' from
//     the reference, the advective sums Q_uu_dp, Q_uv_dp, Q_vv_dp and the
//     delta-form layer pressure (core/coupling.delta_pressure_H: the running
//     sum of ddp' over the layers) summed into dH_bcl; with viscosity, per
//     layer and node, the nodal gradients of u' and v', dpp_graduv =
//     dpprime_visc * grad(u', v') beside dpprime_visc in one (5, L) stack,
//     and the layer sums btp_dpp_graduv and pbprime_visc.
//   stage 1, bcl_coeffs_edge_kernel (the face work, both directions): per
//     layer, the face interpolation of the (ddp', u', v') traces of both
//     sides, the edge sums Q_*_dp_edge and dH_bcl_edge (the running sum of
//     each side's ddp'); with viscosity, the traces of the (5, L) stack
//     copied into graduv_dpp_face's (5, 2, L, F, ngl) layout and their layer
//     sums btp_graduv_dpp_face.
//
// Each element and each face quad point is computed once, by one thread, so
// there is no atomic and the result is the same from run to run; a face
// shared by two blocks of a decomposition is computed by both from the same
// exchanged traces, by the same instructions, and gives the same bits.
//
// What bounds them on this card: latency. At the 25x25 main path stage 0 has
// 625 elements x 81 quad points x 2 layers and moves ~3.5 MB in f32, stage 1
// 1,300 faces x 9 quad points and ~2 MB: about a microsecond of bytes or less
// each, one wave of threads. What the design does:
//   - one thread a (element, quad point), and one a (element, node), or one
//     a (face, quad point), carries the layer loop. The layers are streamed
//     one at a time and nothing of a layer is kept after its turn but the
//     running sums, so a column of any number of layers (up to LMAX, the
//     limit of bcl_flux.cu) runs the same build with the same registers: no
//     per-layer array, in registers or in local memory;
//   - stage 0: a block takes EPB whole elements (EPB * nq^2 <=
//     TARGET_THREADS: at 25x25 209 blocks of 243 threads, one wave on 132
//     SMs) and stages each layer's nodal (ddp', u', v') in shared memory;
//     each thread interpolates them to its quad point sum-factorised within
//     the thread, and differentiates them at its node;
//   - stage 1: consecutive threads take the quad points of a face, so the
//     face's traces are read as one broadcast; the basis lives in shared
//     memory.
// No fast-math.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LMAX = 64;          // the most layers (ops/bcl_coeffs.MAX_LAYERS)
constexpr int MAX_NQ = 17;        // the most quad points an element side (ops/bcl_coeffs.MAX_NQ)
constexpr int MAX_THREADS = 320;  // one thread a quad point of an element: 17 x 17 <= 320
constexpr int TARGET_THREADS = 256;
constexpr int EDGE_THREADS = 128;  // stage 1: threads a block

// element operands, in the order of ops/bcl_coeffs.ELEMENT_OPERANDS
enum {
  kQp,      // qprime_df (3, L, E, n2): ddp', u', v'
  kDpv,     // dpprime_visc (L, E, n2)
  kDrefQ,   // P.dpp_ref_q (L, E, q2)
  kPrefQ,   // P.P_ref_q (L+1, E, q2)
  kAlpha,   // P.alpha (L)
  kKsx, kKsy, kEtx, kEty,  // g.ksi_x, ksi_y, eta_x, eta_y (E, n2)
  kPsi,     // g.psiq (ngl, nq)
  kDpsi,    // g.dpsi (ngl, ngl)
  NEL
};
// face operands of one direction, in the order of ops/bcl_coeffs.face_operands,
// those of the x-faces at NEL, those of the y-faces at NEL + NFD
enum {
  fDL, fDR, fUL, fUR, fVL, fVR,   // the (ddp', u', v') traces, L and R (L, F, ngl)
  fDrefF,                         // P.faces dpp_ref_face_q (L, F, nq)
  fPrefF,                         // P.faces P_ref_edge (L+1, F, nq)
  NFD
};
constexpr int NIN = NEL + 2 * NFD;
constexpr int NV = 5;   // the viscous stack: dpp_graduv's 4 channels, dpprime_visc

template <typename T>
struct Args {
  const T* in[NIN];
  const T* vtr[2][2];   // stage 1: the viscous stack's traces (NV, L, F, ngl) [x, y][L, R]
  T* vol;               // (4, E, q2): Q_uu_dp, Q_uv_dp, Q_vv_dp, dH_bcl
  T* nod;               // (NV, L, E, n2): dpp_graduv, dpprime_visc
  T* nsum;              // (NV, E, n2): btp_dpp_graduv, pbprime_visc
  T* edge[2];           // (4, F, nq) [x, y]: Q_uu_dp_edge, _uv_, _vv_, dH_bcl_edge
  T* gface[2];          // (NV, 2, L, F, ngl) [x, y]: graduv_dpp_face
  T* gsum[2];           // (NV, 2, F, ngl) [x, y]: btp_graduv_dpp_face
  int L, ngl, nq, ly, lx, epb, visc;
};

// stage 0's shared memory: the basis tables and one layer's nodal (ddp', u', v')
template <typename T>
size_t smem_bytes(int ngl, int nq, int epb) {
  return sizeof(T) * (size_t(ngl) * nq + size_t(ngl) * ngl + size_t(3) * epb * ngl * ngl);
}

// elements a stage-0 block takes
inline int elements_per_block(int nq) {
  const int q2 = nq * nq;
  return q2 >= TARGET_THREADS ? 1 : TARGET_THREADS / q2;
}

// the most threads a stage-0 block of the build for NQ_ quad points (0: at run time) has
constexpr int max_threads(int nq) {
  return nq && nq * nq <= TARGET_THREADS ? TARGET_THREADS : MAX_THREADS;
}

// the delta-form pressure of one layer (core/coupling.delta_pressure_H):
// pi, the running sum of ddp' over the layers above and this one, moves on
template <typename T>
__device__ __forceinline__ T delta_h(T& pi, T ddp, T alpha, T p_upper, T p_lower) {
  const T pl = pi + ddp;
  const T pu = pl - ddp;
  pi = pl;
  return alpha * ((p_lower * pl - p_upper * pu) + T(0.5) * (pl * pl - pu * pu));
}

template <typename T, int NGL_, int NQ_>
__global__ void __launch_bounds__(max_threads(NQ_))
bcl_coeffs_nodal_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ngl = NGL_ ? NGL_ : a.ngl;
  const int nq = NQ_ ? NQ_ : a.nq;
  const int n2 = ngl * ngl, q2 = nq * nq;
  const int L = a.L, epb = a.epb;
  const int E = a.ly * a.lx;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int e0 = blockIdx.x * epb;
  const int nel = min(epb, E - e0);

  T* s_psi = smem;                  // (ngl, nq)
  T* s_dpsi = s_psi + ngl * nq;     // (ngl, ngl)
  T* s_nod = s_dpsi + ngl * ngl;    // (3, epb, n2)
  for (int i = tid; i < ngl * nq; i += nthreads) s_psi[i] = a.in[kPsi][i];
  for (int i = tid; i < n2; i += nthreads) s_dpsi[i] = a.in[kDpsi][i];

  const size_t EN = size_t(E) * n2, EQ = size_t(E) * q2;
  // this thread's quad point (le, J, I) and node (ln, j, i)
  const int le = tid / q2, p = tid - le * q2;
  const int J = p / nq, I = p - J * nq;
  const bool active = le < nel;
  const size_t pt = size_t(e0 + le) * q2 + p;
  const int ln = tid / n2, n = tid - ln * n2;
  const int j = n / ngl, i = n - j * ngl;
  const bool node = a.visc && ln < nel;
  const size_t nd = size_t(e0 + ln) * n2 + n;

  T ksx = T(0), ksy = T(0), etx = T(0), ety = T(0);
  if (node) {
    ksx = a.in[kKsx][nd];
    ksy = a.in[kKsy][nd];
    etx = a.in[kEtx][nd];
    ety = a.in[kEty][nd];
  }
  T quu = T(0), quv = T(0), qvv = T(0), dh = T(0), pi = T(0);
  T gsum[4] = {T(0), T(0), T(0), T(0)};
  T psum = T(0);

  for (int k = 0; k < L; ++k) {
    __syncthreads();   // the basis is staged; the last layer's nodes are read
    for (int x = tid; x < 3 * nel * n2; x += nthreads) {
      const int f = x / (nel * n2), r = x - f * nel * n2;
      s_nod[f * epb * n2 + r] = a.in[kQp][(size_t(f) * L + k) * EN + size_t(e0) * n2 + r];
    }
    __syncthreads();

    // ---- the quad point: v[f] = sum_j psi[j,J] sum_i u_f[j,i] psi[i,I] ----------
    if (active) {
      T v[3] = {T(0), T(0), T(0)};
      const T* nb = s_nod + le * n2;
      for (int jj = 0; jj < ngl; ++jj) {
        T r[3] = {T(0), T(0), T(0)};
        for (int ii = 0; ii < ngl; ++ii) {
          const T pi_ = s_psi[ii * nq + I];
#pragma unroll
          for (int f = 0; f < 3; ++f) r[f] = r[f] + nb[f * epb * n2 + jj * ngl + ii] * pi_;
        }
        const T pj = s_psi[jj * nq + J];
#pragma unroll
        for (int f = 0; f < 3; ++f) v[f] = v[f] + pj * r[f];
      }
      const T ddpp = v[0], up = v[1], vp = v[2];
      const T dpp = a.in[kDrefQ][size_t(k) * EQ + pt] + ddpp;
      quu = quu + up * up * dpp;
      quv = quv + vp * up * dpp;
      qvv = qvv + vp * vp * dpp;
      dh = dh + delta_h(pi, ddpp, a.in[kAlpha][k], a.in[kPrefQ][size_t(k) * EQ + pt],
                        a.in[kPrefQ][size_t(k + 1) * EQ + pt]);
    }

    // ---- the node: grad(u', v') (ops/dg.grad_nodal) times dpprime_visc --------
    if (node) {
      const T* ub = s_nod + (epb + ln) * n2;
      const T* vb = ub + epb * n2;
      T uk = T(0), ue = T(0), vk = T(0), ve = T(0);   // d/dksi and d/deta of u', v'
      for (int m = 0; m < ngl; ++m) {
        const T dk = s_dpsi[m * ngl + i], de = s_dpsi[m * ngl + j];
        uk = uk + ub[j * ngl + m] * dk;
        ue = ue + ub[m * ngl + i] * de;
        vk = vk + vb[j * ngl + m] * dk;
        ve = ve + vb[m * ngl + i] * de;
      }
      const T gr[4] = {uk * ksx + ue * etx, uk * ksy + ue * ety,
                       vk * ksx + ve * etx, vk * ksy + ve * ety};
      const T dv = a.in[kDpv][size_t(k) * EN + nd];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T t = dv * gr[c];
        a.nod[(size_t(c) * L + k) * EN + nd] = t;
        gsum[c] = gsum[c] + t;
      }
      a.nod[(size_t(4) * L + k) * EN + nd] = dv;
      psum = psum + dv;
    }
  }

  if (active) {
    a.vol[pt] = quu;
    a.vol[EQ + pt] = quv;
    a.vol[2 * EQ + pt] = qvv;
    a.vol[3 * EQ + pt] = dh;
  }
  if (node) {
#pragma unroll
    for (int c = 0; c < 4; ++c) a.nsum[c * EN + nd] = gsum[c];
    a.nsum[4 * EN + nd] = psum;
  }
}

template <typename T, int NGL_, int NQ_>
__global__ void __launch_bounds__(EDGE_THREADS)
bcl_coeffs_edge_kernel(const __grid_constant__ Args<T> a) {
  __shared__ T s_psi[MAX_NQ * MAX_NQ];   // (ngl, nq)
  const int ngl = NGL_ ? NGL_ : a.ngl;
  const int nq = NQ_ ? NQ_ : a.nq;
  const int L = a.L;
  for (int x = threadIdx.x; x < ngl * nq; x += blockDim.x) s_psi[x] = a.in[kPsi][x];
  __syncthreads();

  const int fx = a.ly * (a.lx + 1), fy = (a.ly + 1) * a.lx;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (fx + fy) * nq) return;
  const int d = idx >= fx * nq;
  const int r = idx - d * fx * nq;
  const int face = r / nq, q = r - face * nq;
  const int F = d ? fy : fx;
  const T* const* op = a.in + NEL + d * NFD;
  const size_t FQ = size_t(F) * nq, fq = size_t(face) * nq + q;
  const bool copy = a.visc && q < ngl;   // this thread carries node q of the viscous traces

  T quu = T(0), quv = T(0), qvv = T(0), dh = T(0), piL = T(0), piR = T(0);
  T gs[NV][2];
#pragma unroll
  for (int c = 0; c < NV; ++c) gs[c][0] = gs[c][1] = T(0);

  for (int k = 0; k < L; ++k) {
    // v[t] = sum_m trace_t[m] psi[m,q], the traces (ddp', u', v') L and R
    const size_t tr = (size_t(k) * F + face) * ngl;
    T v[6];
#pragma unroll
    for (int t = 0; t < 6; ++t) v[t] = T(0);
    for (int m = 0; m < ngl; ++m) {
      const T ps = s_psi[m * nq + q];
#pragma unroll
      for (int t = 0; t < 6; ++t) v[t] = v[t] + op[fDL + t][tr + m] * ps;
    }
    const T dref = op[fDrefF][size_t(k) * FQ + fq];
    const T dL = dref + v[0], dR = dref + v[1];
    const T uL = v[2], uR = v[3], vL = v[4], vR = v[5];
    quu = quu + T(0.5) * (uL * uL * dL + uR * uR * dR);
    quv = quv + T(0.5) * (vL * uL * dL + vR * uR * dR);
    qvv = qvv + T(0.5) * (vL * vL * dL + vR * vR * dR);
    const T alpha = a.in[kAlpha][k];
    const T pu = op[fPrefF][size_t(k) * FQ + fq], pl = op[fPrefF][size_t(k + 1) * FQ + fq];
    const T hL = delta_h(piL, v[0], alpha, pu, pl);
    const T hR = delta_h(piR, v[1], alpha, pu, pl);
    dh = dh + T(0.5) * (hL + hR);

    if (copy) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const T val = a.vtr[d][s][((size_t(c) * L + k) * F + face) * ngl + q];
          a.gface[d][(((size_t(c) * 2 + s) * L + k) * F + face) * ngl + q] = val;
          gs[c][s] = gs[c][s] + val;
        }
      }
    }
  }

  T* e = a.edge[d];
  e[fq] = quu;
  e[FQ + fq] = quv;
  e[2 * FQ + fq] = qvv;
  e[3 * FQ + fq] = dh;
  if (copy) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
        a.gsum[d][((size_t(c) * 2 + s) * F + face) * ngl + q] = gs[c][s];
    }
  }
}

// the kernel of `stage` at compile-time sizes NGL_ x NQ_ (0: at run time)
template <typename T, int NGL_, int NQ_>
cudaError_t run(int stage, const Args<T>& a, cudaStream_t stream) {
  if (stage == 1) {
    const int faces = a.ly * (a.lx + 1) + (a.ly + 1) * a.lx;
    const int blocks = (faces * a.nq + EDGE_THREADS - 1) / EDGE_THREADS;
    if (blocks == 0) return cudaSuccess;
    bcl_coeffs_edge_kernel<T, NGL_, NQ_><<<blocks, EDGE_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const int blocks = (a.ly * a.lx + a.epb - 1) / a.epb;
  if (blocks == 0) return cudaSuccess;
  const int threads = (a.epb * a.nq * a.nq + 31) / 32 * 32;
  const size_t smem = smem_bytes<T>(a.ngl, a.nq, a.epb);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  bcl_coeffs_nodal_kernel<T, NGL_, NQ_><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the pointers after the NIN operands, in the order of ops/bcl_coeffs._buffers
enum {
  xVol, xNod, xNsum, xEdgeX, xEdgeY, xGfaceX, xGfaceY, xGsumX, xGsumY,
  xVtrXL, xVtrXR, xVtrYL, xVtrYR, NEXTRA
};

template <typename T>
cudaError_t launch(int stage, int L, int ngl, int nq, int ly, int lx, int visc,
                   const void* const* ptrs, cudaStream_t stream) {
  if (stage < 0 || stage > 1 || L < 1 || L > LMAX || nq < 2 || nq > MAX_NQ || ngl < 2 ||
      ngl > nq || ly < 0 || lx < 0)
    return cudaErrorInvalidValue;
  Args<T> a;
  for (int i = 0; i < NIN; ++i) a.in[i] = static_cast<const T*>(ptrs[i]);
  const void* const* x = ptrs + NIN;
  auto out = [&](int w) { return static_cast<T*>(const_cast<void*>(x[w])); };
  a.vol = out(xVol);
  a.nod = out(xNod);
  a.nsum = out(xNsum);
  a.edge[0] = out(xEdgeX);
  a.edge[1] = out(xEdgeY);
  a.gface[0] = out(xGfaceX);
  a.gface[1] = out(xGfaceY);
  a.gsum[0] = out(xGsumX);
  a.gsum[1] = out(xGsumY);
  a.vtr[0][0] = static_cast<const T*>(x[xVtrXL]);
  a.vtr[0][1] = static_cast<const T*>(x[xVtrXR]);
  a.vtr[1][0] = static_cast<const T*>(x[xVtrYL]);
  a.vtr[1][1] = static_cast<const T*>(x[xVtrYR]);
  a.L = L;
  a.ngl = ngl;
  a.nq = nq;
  a.ly = ly;
  a.lx = lx;
  a.epb = elements_per_block(nq);
  a.visc = visc;
  if (ngl == 5 && nq == 9)   // the main path's sizes (p=4, exact integration)
    return run<T, 5, 9>(stage, a, stream);
  return run<T, 0, 0>(stage, a, stream);
}

}  // namespace

extern "C" {

// Launch stage 0 (the element work) or stage 1 (the face work) on `stream`;
// does not synchronise. `ptrs`: the NIN operands in the order of
// ops/bcl_coeffs.OPERANDS, then the NEXTRA pointers above (stage 0 reads no
// viscous trace; without viscosity, `visc` 0, the viscous pointers are null
// and nothing of them is read or written). Returns the launch's cudaError_t.
int bcl_coeffs_launch(int stage, int is_double, int L, int ngl, int nq, int ly, int lx,
                      int visc, const void* const* ptrs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_double ? launch<double>(stage, L, ngl, nq, ly, lx, visc, ptrs, s)
                       : launch<float>(stage, L, ngl, nq, ly, lx, visc, ptrs, s));
}

const char* bcl_coeffs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bcl_coeffs_operand_count() { return NIN; }

}  // extern "C"
