// Nodal-family baroclinic viscosity, one launch a call, CUDA C++ for sm_90a
// (NVIDIA Hopper).
//
// The body of core/viscosity.bcl_nodal_laplacian (reference
// bcl_create_laplacian + bcl_compute_laplacian + bcl_create_rhs_laplacian_flux,
// src/mod_laplacian_quad.F90:227-248, 392-425, 521-611); its plain version is
// ops/bcl_visc.bcl_visc_plain, whose arithmetic this kernel repeats operation
// for operation. It replaces no TPU kernel: the JAX package leaves this
// function to XLA's fusion. In plain PyTorch it is ~100 operations a call,
// each a launch of ~1.4 us on the card; here it is one launch. Per element,
// layer and node:
//   - the LDG flux qq = dpprime_visc * graduvb_ave + dpp_graduv (4 channels)
//     and its weak-form divergence on the nodal quadrature,
//   - on an edge node, the Cockburn-Shu flip-flop flux (beta = 1/2) of the
//     face it lies on, from the two-sided face arrays, added with the LDG
//     signs (L side +, R side -, the first face of a domain wall +),
//   - times visc_mlswe * massinv.
// Every element computes the fluxes of its own four edges (a face's is
// computed by both of its elements, from the same arrays), so there is no
// second pass and no atomic: the result is the same from run to run.
//
// What bounds it on this card: latency. At the 25x25 main path a launch has
// 625 elements x 2 layers x 25 nodes (31,250 threads) and moves ~1.3 MB in
// f32. What the design does: one thread a (element, layer, node), no layer
// coupling; a block takes SPB (element, layer) slabs (SPB * ngl^2 <=
// TARGET_THREADS: 125 blocks at 25x25, one wave), stages the slabs' four
// weak-form integrands in shared memory and contracts them after one
// barrier. No fast-math.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MAX_NGL = 32;       // nodes an element side (ops/bcl_visc.MAX_NGL)
constexpr int MAX_THREADS = 1024;
constexpr int TARGET_THREADS = 256;

// operands, in the order of ops/bcl_visc.OPERANDS
enum {
  kDpv,      // coup.dpprime_visc (L, E, n2)
  kGb,       // avg.graduvb (4, E, n2)
  kDgu,      // coup.dpp_graduv (4, L, E, n2)
  kKsx, kKsy, kEtx, kEty, kWjac, kMinv,   // g.ksi_x, ksi_y, eta_x, eta_y, wjac_df, massinv (E, n2)
  kDpsi,     // g.dpsi (ngl, ngl)
  // per face direction (x, then y):
  //   coup.graduv_dpp_face (5, 2, L, F, ngl); avg.faces.gvL, gvR (4, F, ngl),
  //   each channel contiguous, at the channel strides the launch is given;
  //   P.faces nx_df, ny_df, jac_df (F, ngl)
  kGdppX, kGvLX, kGvRX, kNxX, kNyX, kJacX,
  kGdppY, kGvLY, kGvRY, kNxY, kNyY, kJacY,
  NIN
};
constexpr int NFACE = kGdppY - kGdppX;

template <typename T>
struct Args {
  const T* in[NIN];
  T* out;            // (2, L, E, n2)
  long long gvs[4];  // channel strides of gvL x, gvR x, gvL y, gvR y
  T visc;
  int L, ngl, ly, lx, spb, wall_w, wall_s;
};

template <typename T>
size_t smem_bytes(int ngl, int spb) {
  return sizeof(T) * (size_t(ngl) * ngl + size_t(4) * spb * ngl * ngl);
}

// (element, layer) slabs a block takes
__host__ __device__ inline int slabs_per_block(int ngl) {
  const int n2 = ngl * ngl;
  return n2 >= TARGET_THREADS ? 1 : TARGET_THREADS / n2;
}

// the flip-flop flux of node n of face f of one direction, layer k:
// (jac (qmean_u - fl_u . n), jac (qmean_v - fl_v . n))
template <typename T>
__device__ __forceinline__ void face_flux(const Args<T>& a, int d, int k, int F, int f, int n,
                                          T& su, T& sv) {
  const int ngl = a.ngl;
  const T* const* in = a.in + NFACE * d;
  const T* gd = in[kGdppX];
  const size_t plane = size_t(F) * ngl;          // one (F, ngl) array
  const size_t fn = size_t(f) * ngl + n;
  const size_t side = size_t(a.L) * plane;       // (L, F, ngl)
  const long long sL = a.gvs[2 * d], sR = a.gvs[2 * d + 1];
  // gdpp[c, s, k, f, n] at ((c * 2 + s) * L + k) * plane + fn
  const T wl = gd[(8 * size_t(a.L) + k) * plane + fn];        // c = 4, s = 0
  const T wr = gd[(9 * size_t(a.L) + k) * plane + fn];        // c = 4, s = 1
  T fl[4], fr[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    fl[c] = wl * in[kGvLX][c * sL + fn] + gd[2 * c * side + size_t(k) * plane + fn];
    fr[c] = wr * in[kGvRX][c * sR + fn] + gd[(2 * c + 1) * side + size_t(k) * plane + fn];
  }
  const T nx = in[kNxX][fn], ny = in[kNyX][fn], jac = in[kJacX][fn];
  T qm[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) qm[c] = T(0.5) * (fl[c] + fr[c]);
  su = jac * ((qm[0] - fl[0] * nx) + (qm[1] - fl[1] * ny));
  sv = jac * ((qm[2] - fl[2] * nx) + (qm[3] - fl[3] * ny));
}

template <typename T, int NGL_>
__global__ void __launch_bounds__(MAX_THREADS)
bcl_visc_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ngl = NGL_ ? NGL_ : a.ngl;
  const int n2 = ngl * ngl;
  const int L = a.L, ly = a.ly, lx = a.lx, spb = a.spb;
  const int E = ly * lx;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  T* s_dpsi = smem;               // (ngl, ngl)
  T* s_a = s_dpsi + n2;           // (4, spb, n2): a_ksi u, a_eta u, a_ksi v, a_eta v
  for (int i = tid; i < n2; i += nthreads) s_dpsi[i] = a.in[kDpsi][i];

  const int sp = tid / n2, n = tid - sp * n2;
  const int slab = blockIdx.x * spb + sp;      // = k * E + e
  const bool active = sp < spb && slab < L * E;
  const int k = active ? slab / E : 0, e = active ? slab - k * E : 0;
  const size_t EN = size_t(E) * n2;
  const size_t nd = size_t(e) * n2 + n;
  const size_t splane = size_t(spb) * n2;
  if (active) {
    const T dpv = a.in[kDpv][size_t(k) * EN + nd];
    T qq[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qq[c] = dpv * a.in[kGb][c * EN + nd] + a.in[kDgu][(size_t(c) * L + k) * EN + nd];
    const T wj = a.in[kWjac][nd];
    const T kx = a.in[kKsx][nd], ky = a.in[kKsy][nd], ex = a.in[kEtx][nd], ey = a.in[kEty][nd];
    T* s = s_a + sp * n2 + n;
    s[0 * splane] = wj * (qq[0] * kx + qq[1] * ky);
    s[1 * splane] = wj * (qq[0] * ex + qq[1] * ey);
    s[2 * splane] = wj * (qq[2] * kx + qq[3] * ky);
    s[3 * splane] = wj * (qq[2] * ex + qq[3] * ey);
  }
  __syncthreads();
  if (!active) return;

  // nodal weak-form divergence: sum_I a_ksi[j,I] dpsi[i,I] + sum_J a_eta[J,i] dpsi[j,J]
  const int j = n / ngl, i = n - j * ngl;
  const T* s = s_a + sp * n2;
  T ksu = T(0), etu = T(0), ksv = T(0), etv = T(0);
  for (int m = 0; m < ngl; ++m) {
    const T di = s_dpsi[i * ngl + m], dj = s_dpsi[j * ngl + m];
    ksu = ksu + s[0 * splane + j * ngl + m] * di;
    etu = etu + s[1 * splane + m * ngl + i] * dj;
    ksv = ksv + s[2 * splane + j * ngl + m] * di;
    etv = etv + s[3 * splane + m * ngl + i] * dj;
  }
  T ru = -(ksu + etu), rv = -(ksv + etv);

  // edge nodes: the faces' flip-flop fluxes with the LDG signs
  const int ey_ = e / lx, ex_ = e - ey_ * lx;
  T su, sv;
  const int Fx = ly * (lx + 1), Fy = (ly + 1) * lx;
  if (i == ngl - 1) {            // east edge: face ex+1, node j
    face_flux(a, 0, k, Fx, ey_ * (lx + 1) + ex_ + 1, j, su, sv);
    ru = ru + su;
    rv = rv + sv;
  }
  if (i == 0) {                  // west edge: face ex, node j
    face_flux(a, 0, k, Fx, ey_ * (lx + 1) + ex_, j, su, sv);
    if (ex_ == 0 && a.wall_w) {
      ru = ru + su;
      rv = rv + sv;
    } else {
      ru = ru - su;
      rv = rv - sv;
    }
  }
  if (j == ngl - 1) {            // north edge: face ey+1, node i
    face_flux(a, 1, k, Fy, (ey_ + 1) * lx + ex_, i, su, sv);
    ru = ru + su;
    rv = rv + sv;
  }
  if (j == 0) {                  // south edge: face ey, node i
    face_flux(a, 1, k, Fy, ey_ * lx + ex_, i, su, sv);
    if (ey_ == 0 && a.wall_s) {
      ru = ru + su;
      rv = rv + sv;
    } else {
      ru = ru - su;
      rv = rv - sv;
    }
  }
  const T vm = a.visc * a.in[kMinv][nd];
  a.out[size_t(k) * EN + nd] = vm * ru;
  a.out[(size_t(L) + k) * EN + nd] = vm * rv;
}

template <typename T, int NGL_>
cudaError_t run(const Args<T>& a, int blocks, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcl_visc_kernel<T, NGL_>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  bcl_visc_kernel<T, NGL_><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int L, int ngl, int ly, int lx, int wall_w, int wall_s,
                   const void* const* ptrs, const long long* gvs, void* out, double visc,
                   cudaStream_t stream) {
  if (L < 1 || ngl < 2 || ngl > MAX_NGL || ly < 0 || lx < 0) return cudaErrorInvalidValue;
  Args<T> a;
  for (int i = 0; i < NIN; ++i) a.in[i] = static_cast<const T*>(ptrs[i]);
  for (int i = 0; i < 4; ++i) a.gvs[i] = gvs[i];
  a.out = static_cast<T*>(out);
  a.visc = T(visc);
  a.L = L;
  a.ngl = ngl;
  a.ly = ly;
  a.lx = lx;
  a.spb = slabs_per_block(ngl);
  a.wall_w = wall_w;
  a.wall_s = wall_s;
  const long long slabs = (long long)L * ly * lx;
  const int blocks = int((slabs + a.spb - 1) / a.spb);
  if (blocks == 0) return cudaSuccess;
  const int threads = (a.spb * ngl * ngl + 31) / 32 * 32;
  const size_t smem = smem_bytes<T>(ngl, a.spb);
  if (ngl == 5) return run<T, 5>(a, blocks, threads, smem, stream);   // p=4, the main path
  return run<T, 0>(a, blocks, threads, smem, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; does not synchronise. `ptrs`: the NIN operands in the
// order of ops/bcl_visc.OPERANDS; `gvs`: the channel strides (in values) of
// gvL and gvR of the x-faces, then of the y-faces; `out`: (2, L, ly, lx, ngl,
// ngl). `wall_w` / `wall_s`: the block's first x- / y-face is a domain wall,
// whose interior element is its L side. Returns the launch's cudaError_t.
int bcl_visc_launch(int is_double, int L, int ngl, int ly, int lx, int wall_w, int wall_s,
                    const void* const* ptrs, const long long* gvs, void* out, double visc,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(is_double
                 ? launch<double>(L, ngl, ly, lx, wall_w, wall_s, ptrs, gvs, out, visc, s)
                 : launch<float>(L, ngl, ly, lx, wall_w, wall_s, ptrs, gvs, out, visc, s));
}

const char* bcl_visc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bcl_visc_operand_count() { return NIN; }

}  // extern "C"
