// Uniform-geometry barotropic volume stage (kernel A of the fused barotropic
// stage), CUDA C++ for sm_90a (NVIDIA Hopper).
//
// Replaces the TPU kernel hnumo_tpu/ops/pallas_btp.py::_kernel_uni (wrappers
// btp_volume_pallas_uni and btp_volume_grad_pallas_uni). Per element it
// computes, from the flat element-major operands (C, E, npts) / (C, E, nqq):
//   - node->quad interpolation of 7 nodal channels: the 4 barotropic ones and
//     the 3 bottom-layer primes, which come in NODAL,
//   - 1/dp, bottom drag (botfr 0/1/2), Coriolis and wind sources, and the
//     bathymetry-gradient source unless the bottom is flat (ptab then has 8
//     rows instead of 6),
//   - the delta-form pressure term dHq and the momentum flux tensors,
//   - the weak-form scatter of [Fx | Fy | Fs] with the uniform brick's metric
//     constants and quadrature weights folded into three weight vectors, times
//     `minv` (the inverse lumped mass when the caller folds it, else ones),
//   - the in-place += of the 12 quad averages (accv) and of the 3 nodal
//     averages (accn), the latter from the PRE-stage qb,
//   - with `grad`: the nodal velocity gradient gv = (u_x, u_y, v_x, v_y) of
//     u = pbub/pb, v = pbvb/pb (PRE-stage), written out and added to agr.
//
// The TPU kernel multiplies by Kronecker matrices K (25x81), M2 (243x25) and
// Gx, Gy (25x25) because its matrix unit wants large products. Here the 1-D
// tables psiq, dpsiq, dpsi sit in shared memory and every product is two
// passes of short loops (sum factorisation): 9.5 k multiply-adds per element
// at p=4 instead of 35 k, and no per-element metric table at all.
//
// What bounds it on this card: bytes. With the gradient and a flat bottom an
// element moves 2157 values in and 1322 out (3479 at p=4; 24 of the 43
// quad-sized channels are the accumulators' read and write) against ~25 kflop.
// What the design does about it: every global access is one coalesced pass
// over an element's row of a channel, the operators are staged once per block
// and reused for all elements the block walks over, and all intermediates
// stay in shared memory or registers. The three flags (botfr, flat, grad) are
// kernel arguments, the same for every thread, so the branches on them do not
// diverge and the build stays at four instantiations (f32/f64, p=4 sizes at
// compile time / any order at run time).
//
// Layout of one block's work on element e (grid-stride loop over e):
//   phase 0: the element's 7 nodal channels -> shared memory
//   phase 1: interpolation pass 1 (along i); nodal averages; u, v
//   phase 2: thread q < nqq: interpolation pass 2 (along j), the pointwise
//            physics, the 12 accumulator read-modify-writes, 8 weighted flux
//            rows -> shared memory; threads (c, node): gv and agr
//   phase 3: scatter pass 1 (along I)
//   phase 4: scatter pass 2 (along J), times minv -> rhs
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T> __device__ __forceinline__ T t_sqrt(T x);
template <> __device__ __forceinline__ float t_sqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double t_sqrt<double>(double x) { return sqrt(x); }

template <typename T>
struct Args {
  const T* qb;     // (4, E, npts)  nodal barotropic state
  const T* qpl;    // (3, E, npts)  NODAL bottom-layer primes
  const T* ptab;   // (6|8, E, nqq) cor, tau_u, tau_v, 1/pbprime, dpp_ref_q[-1],
                   //               H_bcl_ref [, gzx, gzy]
  const T* coup;   // (4, E, nqq)   Quu, Quv, Qvv, dH_bcl
  const T* pbp;    // (E, npts)     1/pbprime_df
  const T* psiq;   // (ngl, nq)
  const T* dpsiq;  // (ngl, nq)
  const T* dpsi;   // (ngl, ngl)
  const T* wq3;    // (3, nqq): w*ksi_x, w*eta_y, w
  const T* minv;   // (npts)
  T* accv;         // (12, E, nqq)  in place
  T* accn;         // (3, E, npts)  in place
  T* agr;          // (4, E, npts)  in place (grad)
  T* rhs;          // (3, E, npts)  out
  T* gv;           // (4, E, npts)  out (grad)
  int E, ngl, nq, botfr, flat, grad;
  T grav, cd, alpha_bot, kx_df, ey_df;
};

template <typename T>
struct Smem {
  T *psiq, *dpsiq, *dpsi, *wq3, *minv;   // operators
  T *q;        // (7, npts)   own nodal channels
  T *uv;       // (2, npts)   u, v
  T *tmp;      // (7, ngl, nq) interpolation, first pass
  T *f;        // (8, nqq)    weighted flux rows
  T *t1, *t2;  // (3, nq, ngl) scatter, first pass
};

template <typename T>
__host__ __device__ size_t carve(Smem<T>& s, T* base, int n, int m) {
  const int npts = n * n, nqq = m * m;
  size_t o = 0;
  auto take = [&](size_t count) { T* p = base + o; o += count; return p; };
  s.psiq = take(n * m);   s.dpsiq = take(n * m);   s.dpsi = take(n * n);
  s.wq3 = take(3 * nqq);  s.minv = take(npts);
  s.q = take(7 * npts);   s.uv = take(2 * npts);
  s.tmp = take(7 * n * m);
  s.f = take(8 * nqq);
  s.t1 = take(3 * m * n); s.t2 = take(3 * m * n);
  return o;
}

// NGL, NQ > 0 fix the 1-D sizes at compile time (index arithmetic by
// constants, inner loops unrolled); 0 takes them from the arguments.
template <typename T, int NGL, int NQ>
__global__ void __launch_bounds__(kThreads)
btp_volume_uni_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = NGL > 0 ? NGL : a.ngl, m = NQ > 0 ? NQ : a.nq;
  const int npts = n * n, nqq = m * m;
  Smem<T> s;
  carve(s, reinterpret_cast<T*>(smem_raw), n, m);

  const int tid = threadIdx.x;
  const long long E = a.E;
  const long long sn = E * npts;   // channel stride, nodal arrays
  const long long sq = E * nqq;    // channel stride, quad arrays

  for (int t = tid; t < n * m; t += kThreads) {
    s.psiq[t] = a.psiq[t];
    s.dpsiq[t] = a.dpsiq[t];
  }
  for (int t = tid; t < n * n; t += kThreads) s.dpsi[t] = a.dpsi[t];
  for (int t = tid; t < 3 * nqq; t += kThreads) s.wq3[t] = a.wq3[t];
  for (int t = tid; t < npts; t += kThreads) s.minv[t] = a.minv[t];

  for (long long e = blockIdx.x; e < E; e += gridDim.x) {
    const long long en = e * npts;
    const long long eq = e * nqq;

    // ---- phase 0: this element's nodal channels -> shared memory -----------
    __syncthreads();   // the previous element's readers are done
    for (int t = tid; t < 7 * npts; t += kThreads) {
      const int c = t / npts, nn = t - c * npts;
      s.q[t] = c < 4 ? a.qb[c * sn + en + nn] : a.qpl[(c - 4) * sn + en + nn];
    }
    __syncthreads();

    // ---- phase 1: interpolation pass 1, nodal averages, u and v ------------
    for (int t = tid; t < 7 * n * m; t += kThreads) {
      // tmp[c][j][I] = sum_i q[c][j][i] psiq[i][I]
      const int c = t / (n * m), r = t - c * n * m;
      const int j = r / m, I = r - j * m;
      const T* row = s.q + c * npts + j * n;
      T acc = T(0);
      for (int i = 0; i < n; ++i) acc += row[i] * s.psiq[i * m + I];
      s.tmp[t] = acc;
    }
    for (int nn = tid; nn < npts; nn += kThreads) {
      // nodal averages from the PRE-stage qb
      const T inv_pb = T(1) / s.q[nn];
      const T t_df = s.q[npts + nn] * a.pbp[en + nn];
      const T u = s.q[2 * npts + nn] * inv_pb;
      const T v = s.q[3 * npts + nn] * inv_pb;
      a.accn[en + nn] += t_df * (T(2) + t_df);
      a.accn[sn + en + nn] += u;
      a.accn[2 * sn + en + nn] += v;
      s.uv[nn] = u;
      s.uv[npts + nn] = v;
    }
    __syncthreads();

    // ---- phase 2: quad-point work, velocity gradient -----------------------
    for (int q = tid; q < nqq; q += kThreads) {
      const int J = q / m, I = q - J * m;
      T v7[7];
#pragma unroll
      for (int c = 0; c < 7; ++c) v7[c] = T(0);
      for (int j = 0; j < n; ++j) {
        const T p = s.psiq[j * m + J];
#pragma unroll
        for (int c = 0; c < 7; ++c) v7[c] += s.tmp[(c * n + j) * m + I] * p;
      }
      const T dp = v7[0], dpp = v7[1], udp = v7[2], vdp = v7[3];
      const T ppq = v7[4], up = v7[5], vp = v7[6];
      const long long iq = eq + q;
      const T cor = a.ptab[iq];
      const T tau_u = a.ptab[sq + iq], tau_v = a.ptab[2 * sq + iq];
      const T opbp = a.ptab[3 * sq + iq];
      const T pp = a.ptab[4 * sq + iq] + ppq;   // full bottom-layer dp'
      const T Href = a.ptab[5 * sq + iq];

      const T inv_dp = T(1) / dp;
      const T ub = udp * inv_dp;
      const T vb = vdp * inv_dp;

      T tb_u = T(0), tb_v = T(0);
      if (a.botfr == 1) {          // linear bottom drag
        const T spd = (a.cd / a.grav) * pp;
        tb_u = spd * (up + ub);
        tb_v = spd * (vp + vb);
      } else if (a.botfr == 2) {   // quadratic bottom drag
        const T ubot = up + ub, vbot = vp + vb;
        const T spd = (a.cd / a.alpha_bot) * t_sqrt<T>(ubot * ubot + vbot * vbot);
        tb_u = spd * ubot;
        tb_v = spd * vbot;
      }

      T sc_x = cor * vdp + a.grav * (tau_u - tb_u);
      T sc_y = -cor * udp + a.grav * (tau_v - tb_v);
      if (!a.flat) {
        sc_x -= a.grav * dpp * a.ptab[6 * sq + iq];
        sc_y -= a.grav * dpp * a.ptab[7 * sq + iq];
      }

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

      // weighted flux rows: (x, y) of the 3 channels, then the 2 sources
      const T wkx = s.wq3[q], wey = s.wq3[nqq + q], w = s.wq3[2 * nqq + q];
      s.f[0 * nqq + q] = wkx * udp;
      s.f[1 * nqq + q] = wey * vdp;
      s.f[2 * nqq + q] = wkx * (dHq + qu);
      s.f[3 * nqq + q] = wey * quv;
      s.f[4 * nqq + q] = wkx * quv;
      s.f[5 * nqq + q] = wey * (dHq + qv);
      s.f[6 * nqq + q] = w * sc_x;
      s.f[7 * nqq + q] = w * sc_y;
    }
    if (a.grad) {
      // gv[c] at node (j, i): c = 0, 2 d/dx of u, v (along i); 1, 3 d/dy (along j)
      for (int t = tid; t < 4 * npts; t += kThreads) {
        const int c = t / npts, nn = t - c * npts;
        const int j = nn / n, i = nn - j * n;
        const T* f = s.uv + (c >> 1) * npts;
        T acc = T(0);
        if ((c & 1) == 0) {
          for (int k = 0; k < n; ++k) acc += f[j * n + k] * s.dpsi[k * n + i];
          acc *= a.kx_df;
        } else {
          for (int k = 0; k < n; ++k) acc += f[k * n + i] * s.dpsi[k * n + j];
          acc *= a.ey_df;
        }
        a.gv[c * sn + en + nn] = acc;
        a.agr[c * sn + en + nn] += acc;
      }
    }
    __syncthreads();

    // ---- phase 3: scatter pass 1 -------------------------------------------
    for (int t = tid; t < 3 * m * n; t += kThreads) {
      // t1[c][J][i] = sum_I Fx[c][J][I] dpsiq[i][I] (+ Fs[c][J][I] psiq[i][I])
      // t2[c][J][i] = sum_I Fy[c][J][I] psiq[i][I]
      const int c = t / (m * n), r = t - c * m * n;
      const int J = r / n, i = r - J * n;
      const T* fx = s.f + (2 * c) * nqq + J * m;
      const T* fy = fx + nqq;
      T a1 = T(0), a2 = T(0);
      for (int I = 0; I < m; ++I) {
        a1 += fx[I] * s.dpsiq[i * m + I];
        a2 += fy[I] * s.psiq[i * m + I];
      }
      if (c > 0) {
        const T* fs = s.f + (5 + c) * nqq + J * m;
        T a3 = T(0);
        for (int I = 0; I < m; ++I) a3 += fs[I] * s.psiq[i * m + I];
        a1 += a3;
      }
      s.t1[t] = a1;
      s.t2[t] = a2;
    }
    __syncthreads();

    // ---- phase 4: scatter pass 2, inverse mass -----------------------------
    for (int t = tid; t < 3 * npts; t += kThreads) {
      // rhs[c][j][i] = sum_J t1[c][J][i] psiq[j][J] + t2[c][J][i] dpsiq[j][J]
      const int c = t / npts, nn = t - c * npts;
      const int j = nn / n, i = nn - j * n;
      T acc = T(0);
      for (int J = 0; J < m; ++J) {
        acc += s.t1[(c * m + J) * n + i] * s.psiq[j * m + J];
        acc += s.t2[(c * m + J) * n + i] * s.dpsiq[j * m + J];
      }
      a.rhs[c * sn + en + nn] = s.minv[nn] * acc;
    }
  }
}

template <typename T>
size_t smem_bytes(int ngl, int nq) {
  Smem<T> s;
  return sizeof(T) * carve<T>(s, nullptr, ngl, nq);
}

template <typename T, int NGL, int NQ>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.ngl, a.nq);
  auto kernel = btp_volume_uni_kernel<T, NGL, NQ>;
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
cudaError_t run(int E, int ngl, int nq, int botfr, int flat, int grad,
                const void* qb, const void* qpl, const void* ptab, const void* coup,
                const void* pbp, const void* psiq, const void* dpsiq,
                const void* dpsi, const void* wq3, const void* minv, void* accv,
                void* accn, void* agr, void* rhs, void* gv, double grav, double cd,
                double alpha_bot, double kx_df, double ey_df, cudaStream_t stream) {
  Args<T> a;
  a.qb = static_cast<const T*>(qb);
  a.qpl = static_cast<const T*>(qpl);
  a.ptab = static_cast<const T*>(ptab);
  a.coup = static_cast<const T*>(coup);
  a.pbp = static_cast<const T*>(pbp);
  a.psiq = static_cast<const T*>(psiq);
  a.dpsiq = static_cast<const T*>(dpsiq);
  a.dpsi = static_cast<const T*>(dpsi);
  a.wq3 = static_cast<const T*>(wq3);
  a.minv = static_cast<const T*>(minv);
  a.accv = static_cast<T*>(accv);
  a.accn = static_cast<T*>(accn);
  a.agr = static_cast<T*>(agr);
  a.rhs = static_cast<T*>(rhs);
  a.gv = static_cast<T*>(gv);
  a.E = E; a.ngl = ngl; a.nq = nq;
  a.botfr = botfr; a.flat = flat; a.grad = grad;
  a.grav = T(grav); a.cd = T(cd); a.alpha_bot = T(alpha_bot);
  a.kx_df = T(kx_df); a.ey_df = T(ey_df);
  // p = 4 with exact integration (ngl = 5, nq = 9), the order the model is
  // run at, has its own instantiation; every other order takes the sizes at
  // run time
  if (ngl == 5 && nq == 9) return launch<T, 5, 9>(a, stream);
  return launch<T, 0, 0>(a, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the caller checks it against
// the card's limit before launching).
long long btp_volume_uni_smem_bytes(int is_double, int ngl, int nq) {
  return (long long)(is_double ? smem_bytes<double>(ngl, nq) : smem_bytes<float>(ngl, nq));
}

// Launch on `stream`; does not synchronise. Returns the launch's cudaError_t.
// `agr` and `gv` may be null when `grad` is 0.
int btp_volume_uni_launch(int is_double, int E, int ngl, int nq, int botfr, int flat,
                          int grad, const void* qb, const void* qpl, const void* ptab,
                          const void* coup, const void* pbp, const void* psiq,
                          const void* dpsiq, const void* dpsi, const void* wq3,
                          const void* minv, void* accv, void* accn, void* agr,
                          void* rhs, void* gv, double grav, double cd,
                          double alpha_bot, double kx_df, double ey_df, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || ngl <= 0 || nq <= 0 || botfr < 0 || botfr > 2)
    return int(cudaErrorInvalidValue);
  if (grad && (agr == nullptr || gv == nullptr)) return int(cudaErrorInvalidValue);
  if (is_double) {
    return int(run<double>(E, ngl, nq, botfr, flat, grad, qb, qpl, ptab, coup, pbp, psiq,
                           dpsiq, dpsi, wq3, minv, accv, accn, agr, rhs, gv, grav, cd,
                           alpha_bot, kx_df, ey_df, s));
  }
  return int(run<float>(E, ngl, nq, botfr, flat, grad, qb, qpl, ptab, coup, pbp, psiq,
                        dpsiq, dpsi, wq3, minv, accv, accn, agr, rhs, gv, grav, cd,
                        alpha_bot, kx_df, ey_df, s));
}

const char* btp_volume_uni_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
