// All-faces barotropic flux stage (kernel F of the fused barotropic stage),
// CUDA C++ for sm_90a (NVIDIA Hopper).
//
// Replaces the TPU kernel hnumo_tpu/ops/pallas_btp_tail.py::_kernel_faces
// (wrapper btp_faces_pallas). Over all x- and y-faces on one flat face axis
// it computes, per face:
//   - the interpolation of the 4 left and 4 right barotropic nodal traces and
//     of the two one-sided reference pb' traces to the face quad points,
//   - the linearised-Riemann mass flux, the averaged momentum flux with
//     Lax-Friedrichs dissipation and the delta-form face pressure (reference
//     creat_btp_fluxes_qdf, src/mod_rhs_btp.F90:211-364),
//   - the integration of the three fluxes against the edge basis with the
//     face Jacobian -> S (3, F, ngl),
//   - the in-place += of the 16 quad face averages (af),
//   - with `visc`: the nodal flip-flop LDG face flux of the gradient traces
//     (create_rhs_laplacian_flux, src/mod_laplacian_quad.F90:427-519)
//     -> Sv (2, F, ngl), and the in-place += of the 8 gradient-trace averages
//     (ag). Without it the traces have 4 channels and bgf, ag, Sv are unused.
// The direction of a face enters only through its tables.
//
// What bounds it on this card: by the count, bytes — a viscous face moves 474
// values in and 209 out (683 at p=4, half of them the accumulators' read and
// write) against ~1.5 kflop — but at the model's sizes the whole launch is a
// few microseconds of traffic (8320 faces at 64x64 elements are 23 MB), so
// what one pays is the launch and the latency of three dependent phases.
// What the design does about it: a block takes kThreads/nq consecutive faces
// at a time, so every table and accumulator row it touches is one contiguous
// stretch of each channel (coalesced), one thread per (face, quad point) does
// the pointwise work, the traces and the flux integrands pass through shared
// memory, and psiq is staged once per block.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Args {
  const T* trL;   // (8|4, F, ngl) left traces: qb 4 channels [, graduv 4]
  const T* trR;   // (8|4, F, ngl)
  const T* ftab;  // (15, F, nq): nx, ny, jac, cpL, cpR, cpub, omE, cmL, cmR, cmLR,
                  //              Hedge, Quu_e, Quv_e, Qvv_e, dHb_e
  const T* ntab;  // (5, F, ngl): pbdfL, pbdfR, nx_df, ny_df, jac_df
  const T* bgf;   // (10, F, ngl): viscosity face weights L(5), R(5)      (visc)
  const T* psiq;  // (ngl, nq)
  T* af;          // (16, F, nq)  in place
  T* ag;          // (8, F, ngl)  in place                                (visc)
  T* S;           // (3, F, ngl)  out
  T* Sv;          // (2, F, ngl)  out                                     (visc)
  int F, ngl, nq, visc;
};

// Shared memory of one block, for fpb faces: psiq (ngl*nq), the 10 nodal
// rows that are interpolated (4 left, 4 right, pbdfL, pbdfR; fpb*ngl each)
// and the 3 flux integrands (fpb*nq each).
__host__ __device__ inline size_t smem_values(int ngl, int nq, int fpb) {
  return size_t(ngl) * nq + size_t(10) * fpb * ngl + size_t(3) * fpb * nq;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
btp_faces_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.ngl, m = a.nq;
  const int fpb = kThreads / m;            // faces per block and pass
  T* psiq = reinterpret_cast<T*>(smem_raw);
  T* tr = psiq + n * m;                    // (10, fpb*n)
  T* sq = tr + 10 * fpb * n;               // (3, fpb*m)

  const int tid = threadIdx.x;
  const long long F = a.F;
  const long long sn = F * n;   // channel stride, nodal face arrays
  const long long sm = F * m;   // channel stride, quad face arrays

  for (int t = tid; t < n * m; t += kThreads) psiq[t] = a.psiq[t];

  for (long long f0 = (long long)blockIdx.x * fpb; f0 < F;
       f0 += (long long)gridDim.x * fpb) {
    const int nf = (F - f0 < fpb) ? int(F - f0) : fpb;
    const long long bn = f0 * n;   // first nodal / quad entry of this stretch
    const long long bm = f0 * m;

    // ---- phase 0: the stretch's nodal rows -> shared memory ----------------
    __syncthreads();   // the previous stretch's readers are done
    for (int t = tid; t < 10 * nf * n; t += kThreads) {
      const int c = t / (nf * n), r = t - c * nf * n;
      T v;
      if (c < 4) v = a.trL[c * sn + bn + r];
      else if (c < 8) v = a.trR[(c - 4) * sn + bn + r];
      else v = a.ntab[(c - 8) * sn + bn + r];
      tr[c * fpb * n + r] = v;
    }
    __syncthreads();

    // ---- phase 1: one thread per (face, quad point) ------------------------
    if (tid < nf * m) {
      const int fl = tid / m, q = tid - fl * m;
      T v[10];
#pragma unroll
      for (int c = 0; c < 10; ++c) v[c] = T(0);
      for (int k = 0; k < n; ++k) {
        const T p = psiq[k * m + q];
#pragma unroll
        for (int c = 0; c < 10; ++c) v[c] += tr[c * fpb * n + fl * n + k] * p;
      }
      const T l0 = v[0], l1 = v[1], l2 = v[2], l3 = v[3];
      const T r0 = v[4], r1 = v[5], r2 = v[6], r3 = v[7];
      const T pbl = v[8], pbr = v[9];

      const long long iq = bm + tid;
      const T nx = a.ftab[iq], ny = a.ftab[sm + iq], jacf = a.ftab[2 * sm + iq];
      const T cpL = a.ftab[3 * sm + iq], cpR = a.ftab[4 * sm + iq];
      const T cpub = a.ftab[5 * sm + iq], omE = a.ftab[6 * sm + iq];
      const T cmL = a.ftab[7 * sm + iq], cmR = a.ftab[8 * sm + iq];
      const T cmLR = a.ftab[9 * sm + iq], Hedge = a.ftab[10 * sm + iq];
      const T Qe_uu = a.ftab[11 * sm + iq], Qe_uv = a.ftab[12 * sm + iq];
      const T Qe_vv = a.ftab[13 * sm + iq], dHe = a.ftab[14 * sm + iq];

      const T pU_L = nx * l2 + ny * l3;
      const T pU_R = -(nx * r2 + ny * r3);
      const T mue = (cpL * l1 + cpR * r1 + cpub * (pU_L + pU_R)) * omE;
      const T mue2 = mue * (T(2) + mue);
      const T ope_e = T(1) + mue;
      const T flux_ex = cmL * l2 + cmR * r2 + cmLR * nx * (l1 - r1);
      const T flux_ey = cmL * l3 + cmR * r3 + cmLR * ny * (l1 - r1);
      const T inv_l = T(1) / l0, inv_r = T(1) / r0;
      const T ul = l2 * inv_l, ur = r2 * inv_r;
      const T vl = l3 * inv_l, vr = r3 * inv_r;
      const T quu = T(0.5) * (ul * l2 + ur * r2) + ope_e * Qe_uu;
      const T quv = T(0.5) * (vl * l2 + vr * r2) + ope_e * Qe_uv;
      const T qvu = T(0.5) * (ul * l3 + ur * r3) + ope_e * Qe_uv;
      const T qvv = T(0.5) * (vl * l3 + vr * r3) + ope_e * Qe_vv;
      const T dH_f = dHe + mue2 * (Hedge + dHe);
      const T fl_x = nx * quu + ny * quv - T(0.5) * cmLR * (r2 - l2);
      const T fl_y = nx * qvu + ny * qvv - T(0.5) * cmLR * (r3 - l3);
      const T fl_m = nx * flux_ex + ny * flux_ey;
      const T muL = l1 / pbl;
      const T muR = r1 / pbr;
      // 16 face averages, order of core/btp._FACE_ORDER
      const T inc[16] = {dH_f, quu, quv, qvu, qvv, muL, muR, muL * (T(2) + muL),
                         muR * (T(2) + muR), flux_ex, flux_ey, mue2, ul, ur, vl, vr};
#pragma unroll
      for (int c = 0; c < 16; ++c) a.af[c * sm + iq] += inc[c];
      sq[tid] = jacf * fl_m;
      sq[fpb * m + tid] = jacf * (nx * dH_f + fl_x);
      sq[2 * fpb * m + tid] = jacf * (ny * dH_f + fl_y);
    }
    if (a.visc) {
      // flip-flop LDG flux at (face, edge node); the gradient traces are read
      // once, straight from global memory
      for (int t = tid; t < nf * n; t += kThreads) {
        const long long in = bn + t;
        const T bmulL = a.bgf[4 * sn + in], bmulR = a.bgf[9 * sn + in];
        T fl[4], fr[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const T gl = a.trL[(4 + c) * sn + in], gr = a.trR[(4 + c) * sn + in];
          a.ag[c * sn + in] += gl;
          a.ag[(4 + c) * sn + in] += gr;
          fl[c] = bmulL * gl + a.bgf[c * sn + in];
          fr[c] = bmulR * gr + a.bgf[(5 + c) * sn + in];
        }
        const T nxdf = a.ntab[2 * sn + in], nydf = a.ntab[3 * sn + in];
        const T jacdf = a.ntab[4 * sn + in];
        a.Sv[in] = jacdf * ((T(0.5) * (fl[0] + fr[0]) - fl[0] * nxdf)
                            + (T(0.5) * (fl[1] + fr[1]) - fl[1] * nydf));
        a.Sv[sn + in] = jacdf * ((T(0.5) * (fl[2] + fr[2]) - fl[2] * nxdf)
                                 + (T(0.5) * (fl[3] + fr[3]) - fl[3] * nydf));
      }
    }
    __syncthreads();

    // ---- phase 2: integrate the fluxes against the edge basis --------------
    for (int t = tid; t < 3 * nf * n; t += kThreads) {
      const int c = t / (nf * n), r = t - c * nf * n;
      const int fl = r / n, k = r - fl * n;
      const T* row = sq + c * fpb * m + fl * m;
      T acc = T(0);
      for (int q = 0; q < m; ++q) acc += row[q] * psiq[k * m + q];
      a.S[c * sn + bn + r] = acc;
    }
  }
}

template <typename T>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  if (a.nq > kThreads) return cudaErrorInvalidValue;   // one face needs nq threads
  const int fpb = kThreads / a.nq;
  const size_t smem = sizeof(T) * smem_values(a.ngl, a.nq, fpb);
  auto kernel = btp_faces_kernel<T>;
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
  long long blocks = (a.F + fpb - 1) / fpb;
  if (blocks > cached_blocks) blocks = cached_blocks;
  kernel<<<dim3((unsigned)blocks), dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int F, int ngl, int nq, int visc, const void* trL, const void* trR,
                const void* ftab, const void* ntab, const void* bgf, const void* psiq,
                void* af, void* ag, void* S, void* Sv, cudaStream_t stream) {
  Args<T> a;
  a.trL = static_cast<const T*>(trL);
  a.trR = static_cast<const T*>(trR);
  a.ftab = static_cast<const T*>(ftab);
  a.ntab = static_cast<const T*>(ntab);
  a.bgf = static_cast<const T*>(bgf);
  a.psiq = static_cast<const T*>(psiq);
  a.af = static_cast<T*>(af);
  a.ag = static_cast<T*>(ag);
  a.S = static_cast<T*>(S);
  a.Sv = static_cast<T*>(Sv);
  a.F = F; a.ngl = ngl; a.nq = nq; a.visc = visc;
  return launch<T>(a, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; does not synchronise. Returns the launch's cudaError_t.
// `bgf`, `ag` and `Sv` may be null when `visc` is 0.
int btp_faces_launch(int is_double, int F, int ngl, int nq, int visc,
                     const void* trL, const void* trR, const void* ftab,
                     const void* ntab, const void* bgf, const void* psiq,
                     void* af, void* ag, void* S, void* Sv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 0 || ngl <= 0 || nq <= 0) return int(cudaErrorInvalidValue);
  if (visc && (bgf == nullptr || ag == nullptr || Sv == nullptr))
    return int(cudaErrorInvalidValue);
  if (is_double)
    return int(run<double>(F, ngl, nq, visc, trL, trR, ftab, ntab, bgf, psiq, af, ag,
                           S, Sv, s));
  return int(run<float>(F, ngl, nq, visc, trL, trR, ftab, ntab, bgf, psiq, af, ag,
                        S, Sv, s));
}

const char* btp_faces_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
