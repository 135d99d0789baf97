// Fused barotropic volume RHS + running-average accumulation, CUDA C++ for
// sm_90a (NVIDIA Hopper).
//
// Replaces the TPU kernel hnumo_tpu/ops/pallas_btp.py::_kernel (wrapper
// btp_volume_pallas). Per element it computes, from the flat element-major
// operands (C, E, npts) / (C, E, nqq):
//   - node->quad interpolation of the 4 barotropic channels (u_q = u_n @ K),
//   - 1/dp, bottom drag (botfr 0/1/2), Coriolis / wind / bathymetry sources,
//   - the delta-form pressure term dHq and the momentum flux tensors,
//   - the curvilinear weak-form scatter
//       r_n = a_ksi @ DkT + a_eta @ DeT + s @ K^T        (3 channels),
//     giving rhs (3, E, npts) WITHOUT the inverse mass,
//   - the in-place += of the 12 quad averages (accv) and of the 3 nodal
//     averages (accn), the latter from the PRE-stage qb.
//
// What bounds it on this card: bytes. Per element it must move
// 14*npts + 44*nqq values (3914 at p=4) against ~57k flops, far under the
// card's flop-per-byte ridge; 24 of the 44 quad-sized channels are the
// accumulators' read and write. What the design does about it: every global
// access is one coalesced pass (thread q reads/writes element row entries q
// of each channel), the three operator matrices are staged in shared memory
// once per block and reused for all elements the block walks over, and
// all intermediates (quad fields, weighted flux rows) stay in registers /
// shared memory. No tensor cores: 25 and 81 are not MMA tile sizes, and the
// contraction is not the limit.
//
// Layout of one block's work on element e (grid-stride loop over e):
//   phase 0: threads stage qb[:, e, :] (4*npts values) in shared memory
//   phase 1: thread q < nqq interpolates the 4 channels, does the pointwise
//            physics, the 12 accumulator read-modify-writes, and leaves the
//            8 weighted flux rows in shared memory
//   phase 2: thread (c, n), c < 3, n < npts does the three scatters;
//            threads n < npts do the 3 nodal accumulators
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFluxRows = 8;

template <typename T> __device__ __forceinline__ T t_sqrt(T x);
template <> __device__ __forceinline__ float t_sqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double t_sqrt<double>(double x) { return sqrt(x); }

template <typename T>
struct Args {
  const T* qb;    // (4, E, npts)  nodal barotropic state
  const T* qpl;   // (3, E, nqq)   bottom-layer primes at quad points
  const T* met;   // (5, E, nqq)   ksiq_x, ksiq_y, etaq_x, etaq_y, wjac
  const T* ptab;  // (8, E, nqq)   coriolis, tau_u, tau_v, gzx, gzy,
                  //               1/pbprime, dpp_ref_q[-1], H_bcl_ref
  const T* coup;  // (4, E, nqq)   Quu, Quv, Qvv, dH_bcl
  const T* K;     // (npts, nqq)
  const T* DkT;   // (nqq, npts)
  const T* DeT;   // (nqq, npts)
  const T* pbp;   // (E, npts)     1/pbprime_df
  T* accv;        // (12, E, nqq)  in place
  T* accn;        // (3, E, npts)  in place
  T* rhs;         // (3, E, npts)  out
  int E, npts, nqq;
  T grav, cd, alpha_bot;
};

template <typename T, int BOTFR>
__global__ void __launch_bounds__(kThreads)
btp_volume_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);       // npts*nqq
  T* sDk = sK + a.npts * a.nqq;                 // nqq*npts
  T* sDe = sDk + a.npts * a.nqq;                // nqq*npts
  T* sQb = sDe + a.npts * a.nqq;                // 4*npts
  T* sF = sQb + 4 * a.npts;                     // kFluxRows*nqq

  const int tid = threadIdx.x;
  const int npts = a.npts, nqq = a.nqq;
  const long long E = a.E;
  const long long sn = E * npts;   // channel stride, nodal arrays
  const long long sq = E * nqq;    // channel stride, quad arrays

  for (int i = tid; i < npts * nqq; i += kThreads) {
    sK[i] = a.K[i];
    sDk[i] = a.DkT[i];
    sDe[i] = a.DeT[i];
  }

  for (long long e = blockIdx.x; e < E; e += gridDim.x) {
    const long long en = e * npts;
    const long long eq = e * nqq;

    // ---- phase 0: this element's nodal state -> shared memory ----------
    __syncthreads();   // previous element's readers of sQb/sF are done
    for (int i = tid; i < 4 * npts; i += kThreads) {
      const int c = i / npts, n = i - c * npts;
      sQb[i] = a.qb[c * sn + en + n];
    }
    __syncthreads();

    // ---- phase 1: quad-point work ---------------------------------------
    for (int q = tid; q < nqq; q += kThreads) {
      T dp = T(0), dpp = T(0), udp = T(0), vdp = T(0);
      for (int n = 0; n < npts; ++n) {
        const T k = sK[n * nqq + q];
        dp += sQb[n] * k;
        dpp += sQb[npts + n] * k;
        udp += sQb[2 * npts + n] * k;
        vdp += sQb[3 * npts + n] * k;
      }
      const long long iq = eq + q;
      const T ppq = a.qpl[iq], up = a.qpl[sq + iq], vp = a.qpl[2 * sq + iq];
      const T cor = a.ptab[iq];
      const T tau_u = a.ptab[sq + iq], tau_v = a.ptab[2 * sq + iq];
      const T gzx = a.ptab[3 * sq + iq], gzy = a.ptab[4 * sq + iq];
      const T opbp = a.ptab[5 * sq + iq];
      const T pp = a.ptab[6 * sq + iq] + ppq;   // full bottom-layer dp'
      const T Href = a.ptab[7 * sq + iq];

      const T inv_dp = T(1) / dp;
      const T ub = udp * inv_dp;
      const T vb = vdp * inv_dp;

      T tb_u = T(0), tb_v = T(0);
      if (BOTFR == 1) {          // linear bottom drag
        const T spd = (a.cd / a.grav) * pp;
        tb_u = spd * (up + ub);
        tb_v = spd * (vp + vb);
      } else if (BOTFR == 2) {   // quadratic bottom drag
        const T ubot = up + ub, vbot = vp + vb;
        const T spd = (a.cd / a.alpha_bot) * t_sqrt<T>(ubot * ubot + vbot * vbot);
        tb_u = spd * ubot;
        tb_v = spd * vbot;
      }

      const T sc_x = cor * vdp + a.grav * (tau_u - tb_u) - a.grav * dpp * gzx;
      const T sc_y = -cor * udp + a.grav * (tau_v - tb_v) - a.grav * dpp * gzy;

      const T Quu = a.coup[iq], Quv = a.coup[sq + iq];
      const T Qvv = a.coup[2 * sq + iq], dHbcl = a.coup[3 * sq + iq];
      const T mu = dpp * opbp;
      const T mu2 = mu * (T(2) + mu);
      const T ope = T(1) + mu;
      const T dHq = dHbcl + mu2 * (Href + dHbcl);
      const T qu = ub * udp + ope * Quu;
      const T quv = ub * vdp + ope * Quv;
      const T qv = vb * vdp + ope * Qvv;

      // 12 running averages, order of core/btp._VOL_ORDER
      const T inc[12] = {dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp, tb_u, tb_v};
#pragma unroll
      for (int c = 0; c < 12; ++c) a.accv[c * sq + iq] += inc[c];

      const T kx = a.met[iq], ky = a.met[sq + iq];
      const T ex = a.met[2 * sq + iq], ey = a.met[3 * sq + iq];
      const T wj = a.met[4 * sq + iq];
      // weighted flux rows: (a_ksi, a_eta) of the 3 channels, then the 2 sources
      const T fx1 = dHq + qu, fy2 = dHq + qv;
      sF[0 * nqq + q] = wj * (udp * kx + vdp * ky);
      sF[1 * nqq + q] = wj * (udp * ex + vdp * ey);
      sF[2 * nqq + q] = wj * (fx1 * kx + quv * ky);
      sF[3 * nqq + q] = wj * (fx1 * ex + quv * ey);
      sF[4 * nqq + q] = wj * (quv * kx + fy2 * ky);
      sF[5 * nqq + q] = wj * (quv * ex + fy2 * ey);
      sF[6 * nqq + q] = wj * sc_x;
      sF[7 * nqq + q] = wj * sc_y;
    }
    __syncthreads();

    // ---- phase 2: weak-form scatter + nodal averages --------------------
    for (int i = tid; i < 3 * npts; i += kThreads) {
      const int c = i / npts, n = i - c * npts;
      const T* fk = sF + (2 * c) * nqq;
      const T* fe = fk + nqq;
      T rk = T(0), re = T(0);
      for (int q = 0; q < nqq; ++q) {
        rk += fk[q] * sDk[q * npts + n];
        re += fe[q] * sDe[q * npts + n];
      }
      T r = rk + re;
      if (c > 0) {
        const T* fs = sF + (5 + c) * nqq;
        T rs = T(0);
        for (int q = 0; q < nqq; ++q) rs += fs[q] * sK[n * nqq + q];
        r += rs;
      }
      a.rhs[c * sn + en + n] = r;
    }
    for (int n = tid; n < npts; n += kThreads) {
      // nodal averages from the PRE-stage qb
      const T t_df = sQb[npts + n] * a.pbp[en + n];
      const T inv_pb = T(1) / sQb[n];
      a.accn[en + n] += t_df * (T(2) + t_df);
      a.accn[sn + en + n] += sQb[2 * npts + n] * inv_pb;
      a.accn[2 * sn + en + n] += sQb[3 * npts + n] * inv_pb;
    }
  }
}

template <typename T>
size_t smem_bytes(int npts, int nqq) {
  return sizeof(T) * (size_t(3) * npts * nqq + 4 * npts + kFluxRows * nqq);
}

template <typename T, int BOTFR>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.npts, a.nqq);
  auto kernel = btp_volume_kernel<T, BOTFR>;
  // The attribute and the resident-block count depend only on the
  // instantiation and the shared-memory size: asked once, then reused (the
  // solver launches this 2*N_btp*kstages times per step with one size).
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
  long long blocks = cached_blocks;
  if (blocks > a.E) blocks = a.E;
  kernel<<<dim3((unsigned)blocks), dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int botfr, const Args<T>& a, cudaStream_t stream) {
  switch (botfr) {
    case 0: return launch<T, 0>(a, stream);
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
Args<T> make_args(const void* qb, const void* qpl, const void* met,
                  const void* ptab, const void* coup, const void* K,
                  const void* DkT, const void* DeT, const void* pbp,
                  void* accv, void* accn, void* rhs, int E, int npts, int nqq,
                  double grav, double cd, double alpha_bot) {
  Args<T> a;
  a.qb = static_cast<const T*>(qb);
  a.qpl = static_cast<const T*>(qpl);
  a.met = static_cast<const T*>(met);
  a.ptab = static_cast<const T*>(ptab);
  a.coup = static_cast<const T*>(coup);
  a.K = static_cast<const T*>(K);
  a.DkT = static_cast<const T*>(DkT);
  a.DeT = static_cast<const T*>(DeT);
  a.pbp = static_cast<const T*>(pbp);
  a.accv = static_cast<T*>(accv);
  a.accn = static_cast<T*>(accn);
  a.rhs = static_cast<T*>(rhs);
  a.E = E;
  a.npts = npts;
  a.nqq = nqq;
  a.grav = T(grav);
  a.cd = T(cd);
  a.alpha_bot = T(alpha_bot);
  return a;
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the caller checks it against
// the card's limit before launching).
long long btp_volume_smem_bytes(int is_double, int npts, int nqq) {
  return (long long)(is_double ? smem_bytes<double>(npts, nqq)
                               : smem_bytes<float>(npts, nqq));
}

// Launch on `stream`; does not synchronise. Returns the launch's cudaError_t.
int btp_volume_launch(int is_double, int botfr,
                      const void* qb, const void* qpl, const void* met,
                      const void* ptab, const void* coup, const void* K,
                      const void* DkT, const void* DeT, const void* pbp,
                      void* accv, void* accn, void* rhs,
                      int E, int npts, int nqq,
                      double grav, double cd, double alpha_bot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || npts <= 0 || nqq <= 0) return int(cudaErrorInvalidValue);
  if (is_double) {
    return int(dispatch<double>(botfr, make_args<double>(
        qb, qpl, met, ptab, coup, K, DkT, DeT, pbp, accv, accn, rhs,
        E, npts, nqq, grav, cd, alpha_bot), s));
  }
  return int(dispatch<float>(botfr, make_args<float>(
      qb, qpl, met, ptab, coup, K, DkT, DeT, pbp, accv, accn, rhs,
      E, npts, nqq, grav, cd, alpha_bot), s));
}

const char* btp_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
