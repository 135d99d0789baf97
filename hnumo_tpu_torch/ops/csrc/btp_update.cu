// Barotropic stage update (kernel U of the fused barotropic stage), CUDA C++
// for sm_90a (NVIDIA Hopper).
//
// Replaces the TPU kernel hnumo_tpu/ops/pallas_btp_tail.py::_kernel_update
// (wrapper btp_update_pallas). Per element it computes:
//   - the placement of the signed face values [W, E, S, N] on the element's
//     edge nodes, times the inverse lumped mass (a corner node receives the
//     values of both its sides),
//   - + the massinv-folded volume RHS and the static delta-form reference
//     vector,
//   - with `visc`: the nodal LDG volume Laplacian of pbpv*gv + bdg in the
//     nodal quadrature (btp_compute_laplacian,
//     src/mod_laplacian_quad.F90:357-425) and the viscous edge values, times
//     visc*massinv, added to the two momentum rows,
//   - the 3-register SSPRK combine a0*qb0 + a1*qb1 + a2*qb2 + dt*beta*rhs on
//     rows 1..3 (src/mod_rk_mlswe.F90:99-119), pb = pb' + pbprime_df, and the
//     wall projection as 0/1 masks.
// It writes a NEW state buffer: qb0, qb1 and qb2 are all read, and the caller
// lets them alias each other.
//
// The TPU kernel multiplies the edge stack by 0/1 placement matrices scaled by
// massinv (Escat, Evisc, 20x25) and the viscous flux by Kronecker matrices Vx,
// Vy (25x25), because its matrix unit wants products. Here the placement is an
// indexed sum of at most two edge values per node, and the Laplacian is
// sum-factorised from the 1-D derivative table dpsi.
//
// What bounds it on this card: bytes. A viscous element moves 775 values in
// (of the three registers only rows 1..3 are read) and 100 out at p=4
// against ~2 kflop. At the model's sizes that is microseconds of traffic
// (4096 elements: 14 MB), so what one pays is the launch. What the design
// does about it: a block takes as many consecutive elements at a time as its
// threads cover (one thread per output value), so every operand row is read
// in one contiguous stretch per channel (coalesced); only the weighted
// viscous flux passes through shared memory; the four SSPRK weights arrive as
// kernel arguments, so the host never reads the device inside the stage loop.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Args {
  const T* rhs;     // (3, E, npts)   massinv-folded volume RHS
  const T* edges;   // (3, E, 4*ngl)  signed face values [W, E, S, N]
  const T* qb0;     // (4, E, npts)   SSPRK registers (may alias each other)
  const T* qb1;
  const T* qb2;
  const T* ref;     // (3, E, npts)   massinv * btp_rhs_ref
  const T* pbdf;    // (E, npts)      pbprime_df
  const T* mask;    // (2, E, npts)   wall projection of (pbub, pbvb)
  const T* minv;    // (npts)         inverse lumped mass of the uniform brick
  const T* vedges;  // (2, E, 4*ngl)                                     (visc)
  const T* gv;      // (4, E, npts)   grad(u, v)                          (visc)
  const T* pbpv;    // (E, npts)      pbprime_visc                        (visc)
  const T* bdg;     // (4, E, npts)   btp_dpp_graduv                      (visc)
  const T* dpsi;    // (ngl, ngl)                                         (visc)
  const T* wn2;     // (2, npts): w_df*ksi_x, w_df*eta_y                  (visc)
  T* out;           // (4, E, npts)   new state
  int E, ngl, visc;
  T a0, a1, a2, dtt, nu;
};

// Sum over the sides node (j, i) lies on of the edge values e[side*n + k],
// sides in the order west, east, south, north (corner nodes lie on two).
template <typename T>
__device__ __forceinline__ T edge_sum(const T* e, int n, int j, int i) {
  T acc = T(0);
  if (i == 0) acc += e[j];
  if (i == n - 1) acc += e[n + j];
  if (j == 0) acc += e[2 * n + i];
  if (j == n - 1) acc += e[3 * n + i];
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
btp_update_kernel(const Args<T> a, int epb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.ngl, npts = n * n;
  T* dpsi = reinterpret_cast<T*>(smem_raw);   // (n, n)
  T* wn2 = dpsi + n * n;                      // (2, npts)
  T* qq = wn2 + 2 * npts;                     // (4, epb*npts) weighted viscous flux

  const int tid = threadIdx.x;
  const long long E = a.E;
  const long long sn = E * npts;      // channel stride, nodal arrays
  const long long se = E * 4 * n;     // channel stride, edge arrays

  if (a.visc) {
    for (int t = tid; t < n * n; t += kThreads) dpsi[t] = a.dpsi[t];
    for (int t = tid; t < 2 * npts; t += kThreads) wn2[t] = a.wn2[t];
  }

  for (long long e0 = (long long)blockIdx.x * epb; e0 < E;
       e0 += (long long)gridDim.x * epb) {
    const int ne = (E - e0 < epb) ? int(E - e0) : epb;
    const long long bn = e0 * npts;   // first nodal entry of this stretch

    if (a.visc) {
      // qq = pbprime_visc * graduv + btp_dpp_graduv, weighted for the nodal
      // quadrature: x-derivative channels (0, 2) by w*ksi_x, (1, 3) by w*eta_y
      __syncthreads();   // the previous stretch's readers are done
      for (int t = tid; t < 4 * ne * npts; t += kThreads) {
        const int c = t / (ne * npts), r = t - c * ne * npts;
        const int nn = r % npts;
        qq[c * epb * npts + r] = wn2[(c & 1) * npts + nn]
            * (a.pbpv[bn + r] * a.gv[c * sn + bn + r] + a.bdg[c * sn + bn + r]);
      }
      __syncthreads();
    }

    for (int t = tid; t < 3 * ne * npts; t += kThreads) {
      const int c = t / (ne * npts), r = t - c * ne * npts;
      const int el = r / npts, nn = r - el * npts;
      const int j = nn / n, i = nn - j * n;
      const long long in = bn + r;                 // (e, node) of an (E, npts) row
      const long long ie = (e0 + el) * 4 * n;      // (e, 0) of an (E, 4*ngl) row
      const T mi = a.minv[nn];
      T rr = a.rhs[c * sn + in] + mi * edge_sum(a.edges + c * se + ie, n, j, i)
             + a.ref[c * sn + in];
      if (a.visc && c > 0) {
        const T* X = qq + (2 * (c - 1)) * epb * npts + el * npts;
        const T* Y = X + epb * npts;
        T acc = T(0);
        for (int k = 0; k < n; ++k) {
          acc += X[j * n + k] * dpsi[i * n + k];
          acc += Y[k * n + i] * dpsi[j * n + k];
        }
        rr += a.nu * mi * (edge_sum(a.vedges + (c - 1) * se + ie, n, j, i) - acc);
      }
      const long long ig = (c + 1) * sn + in;
      const T v = a.a0 * a.qb0[ig] + a.a1 * a.qb1[ig] + a.a2 * a.qb2[ig] + a.dtt * rr;
      if (c == 0) {
        a.out[in] = v + a.pbdf[in];   // pb = pb' + pbprime
        a.out[ig] = v;
      } else {
        a.out[ig] = v * a.mask[(c - 1) * sn + in];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const int npts = a.ngl * a.ngl;
  int epb = kThreads / (3 * npts);     // elements per block and pass
  if (epb < 1) epb = 1;
  const size_t smem = sizeof(T) * (size_t(a.ngl) * a.ngl + 2 * npts
                                   + size_t(4) * epb * npts);
  auto kernel = btp_update_kernel<T>;
  // asked once per shared-memory size, then reused (see btp_volume.cu)
  static size_t cached_smem = 0;
  static long long cached_blocks = 0;
  if (cached_smem != smem || cached_blocks == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    cached_blocks = (long long)sms * per_sm;
    cached_smem = smem;
  }
  long long blocks = (a.E + epb - 1) / epb;
  if (blocks > cached_blocks) blocks = cached_blocks;
  kernel<<<dim3((unsigned)blocks), dim3(kThreads), smem, stream>>>(a, epb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int E, int ngl, int visc, const void* rhs, const void* edges,
                const void* qb0, const void* qb1, const void* qb2, const void* ref,
                const void* pbdf, const void* mask, const void* minv,
                const void* vedges, const void* gv, const void* pbpv, const void* bdg,
                const void* dpsi, const void* wn2, void* out, double a0, double a1,
                double a2, double dtt, double nu, cudaStream_t stream) {
  Args<T> a;
  a.rhs = static_cast<const T*>(rhs);
  a.edges = static_cast<const T*>(edges);
  a.qb0 = static_cast<const T*>(qb0);
  a.qb1 = static_cast<const T*>(qb1);
  a.qb2 = static_cast<const T*>(qb2);
  a.ref = static_cast<const T*>(ref);
  a.pbdf = static_cast<const T*>(pbdf);
  a.mask = static_cast<const T*>(mask);
  a.minv = static_cast<const T*>(minv);
  a.vedges = static_cast<const T*>(vedges);
  a.gv = static_cast<const T*>(gv);
  a.pbpv = static_cast<const T*>(pbpv);
  a.bdg = static_cast<const T*>(bdg);
  a.dpsi = static_cast<const T*>(dpsi);
  a.wn2 = static_cast<const T*>(wn2);
  a.out = static_cast<T*>(out);
  a.E = E; a.ngl = ngl; a.visc = visc;
  a.a0 = T(a0); a.a1 = T(a1); a.a2 = T(a2); a.dtt = T(dtt); a.nu = T(nu);
  return launch<T>(a, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; does not synchronise. Returns the launch's cudaError_t.
// The six viscous operands may be null when `visc` is 0. `out` must not
// overlap any input.
int btp_update_launch(int is_double, int E, int ngl, int visc,
                      const void* rhs, const void* edges, const void* qb0,
                      const void* qb1, const void* qb2, const void* ref,
                      const void* pbdf, const void* mask, const void* minv,
                      const void* vedges, const void* gv, const void* pbpv,
                      const void* bdg, const void* dpsi, const void* wn2, void* out,
                      double a0, double a1, double a2, double dtt, double nu,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || ngl <= 0) return int(cudaErrorInvalidValue);
  if (visc && (vedges == nullptr || gv == nullptr || pbpv == nullptr ||
               bdg == nullptr || dpsi == nullptr || wn2 == nullptr))
    return int(cudaErrorInvalidValue);
  if (is_double)
    return int(run<double>(E, ngl, visc, rhs, edges, qb0, qb1, qb2, ref, pbdf, mask,
                           minv, vedges, gv, pbpv, bdg, dpsi, wn2, out, a0, a1, a2,
                           dtt, nu, s));
  return int(run<float>(E, ngl, visc, rhs, edges, qb0, qb1, qb2, ref, pbdf, mask, minv,
                        vedges, gv, pbpv, bdg, dpsi, wn2, out, a0, a1, a2, dtt, nu, s));
}

const char* btp_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
