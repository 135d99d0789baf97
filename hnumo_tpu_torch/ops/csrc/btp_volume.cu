// Fused barotropic volume RHS + running-average accumulation, CUDA C++ for
// sm_90a (NVIDIA Hopper).
//
// Replaces the TPU kernel hnumo_tpu/ops/pallas_btp.py::_kernel (wrapper
// btp_volume_pallas). Per element it computes, from the flat element-major
// operands (C, E, npts) / (C, E, nqq):
//   - node->quad interpolation of the 4 barotropic channels,
//   - 1/dp, bottom drag (botfr 0/1/2), Coriolis / wind / bathymetry sources,
//   - the delta-form pressure term dHq and the momentum flux tensors,
//   - the curvilinear weak-form scatter
//       r_n = a_ksi @ DkT + a_eta @ DeT + s @ K^T        (3 channels),
//     giving rhs (3, E, npts) WITHOUT the inverse mass,
//   - the in-place += of the 12 quad averages (accv) and of the 3 nodal
//     averages (accn), the latter from the PRE-stage qb.
//
// The TPU kernel multiplies by the Kronecker matrices K, DkT, DeT (25x81 at
// p=4) because its matrix unit wants large products. They are pure
// reference-element tensor products (K = psiq x psiq, Dk = psiq x dpsiq,
// De = dpsiq x psiq); the general metric enters only pointwise, through
// `met`, before the scatter. So here every product is two passes over the
// 1-D tables psiq and dpsiq (sum factorisation), for any geometry: 7.6 k
// multiply-adds per element at p=4 instead of 24 k, and 90 table values in
// shared memory instead of 6075 — which is what lets p=8 (and any order
// whose single element fits the shared memory) run at all.
//
// What bounds it on this card: bytes (per element 14*npts + 44*nqq values,
// 3914 at p=4, against ~30 kflop; 24 of the 44 quad-sized channels are the
// accumulators' read and write). The first version of this kernel sat at
// 3.2x that bound at 256x256 (0.979 ms) for two reasons that were measured
// apart: with its global reads replaced by computed values it still took
// 0.537 ms — one shared-memory load per multiply-add of the full Kronecker
// products, on 75-81 of 128 threads — and with the contractions compiled
// out 0.843 ms — one element per block, and the 12 accumulator updates as
// 12 dependent round trips to device memory. What the design does about
// both (btp_volume_common.cuh has the shared parts, the same as in
// btp_volume_uni.cu):
//   - sum-factorised passes in which a thread owns a line, holds it in
//     registers and produces all of its outputs;
//   - a block works a tile of 4 consecutive elements: the pointwise phase is
//     one flat, coalesced run of 324 quad points for 352 threads;
//   - every global input of tile t+1, the accumulators' old values included,
//     is on its way into the other stage of a two-stage shared-memory ring
//     (cp.async, 16 bytes a copy where aligned) while tile t is computed; the
//     accumulators are written once, from registers.
// Two blocks of 352 threads are resident per SM (106 KB of shared memory
// each at p=4 in f32): the ring, not the number of warps, keeps the loads in
// flight — each block has a whole tile (45 KB) under way at any time.
// No tensor cores: f32 products stay full f32, and wgmma has no f32 input.
//
// One tile's phases (block-wide barrier between them):
//   top:     start the copies of the next tile; wait for this tile's
//   phase 1: interpolation pass 1 (along i); nodal averages
//   phase 2: interpolation pass 2 (along j)
//   phase 3: thread = quad point of the tile: pointwise physics and metric,
//            the 12 accumulator rows written, 8 weighted flux rows
//   phase 4: scatter pass 1 (along I)
//   phase 5: scatter pass 2 (along J) -> rhs
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include "btp_volume_common.cuh"

namespace {

using namespace btpvol;

// channels of a stage: nodal qb 4, pbp 1, accn 3; quad qpl 3, met 5, ptab 8,
// coup 4, accv 12
constexpr int kNodalIn = 8;
constexpr int kQuadIn = 32;
constexpr int kPbp = 4, kAccn = 5;
constexpr int kMet = 3, kPtab = 8, kCoup = 16, kAccv = 20;

template <typename T>
struct Args {
  const T* qb;    // (4, E, npts)  nodal barotropic state
  const T* qpl;   // (3, E, nqq)   bottom-layer primes at quad points
  const T* met;   // (5, E, nqq)   ksiq_x, ksiq_y, etaq_x, etaq_y, wjac
  const T* ptab;  // (8, E, nqq)   coriolis, tau_u, tau_v, gzx, gzy,
                  //               1/pbprime, dpp_ref_q[-1], H_bcl_ref
  const T* coup;  // (4, E, nqq)   Quu, Quv, Qvv, dH_bcl
  const T* psiq;  // (ngl, nq)     1-D interpolation
  const T* dpsiq; // (ngl, nq)     1-D derivative at the quad points
  const T* pbp;   // (E, npts)     1/pbprime_df
  T* accv;        // (12, E, nqq)  in place
  T* accn;        // (3, E, npts)  in place
  T* rhs;         // (3, E, npts)  out
  int E, ngl, nq, botfr;
  int G;          // elements per tile
  T grav, cd, alpha_bot;
};

template <typename T>
struct Smem {
  T *psiq, *dpsiq;     // operators
  T *stage[kStages];   // nodal channels (kNodalIn slots), then quad (kQuadIn)
  T *vf;       // (8, slot_q)       interpolated channels, then flux rows
  T *tt;       // (8, G*ngl*nq)     first pass of interpolation and of scatter
  int slot_n, slot_q;
};

template <typename T>
__host__ __device__ size_t carve(Smem<T>& s, T* base, int n, int m, int G) {
  s.slot_n = slot_values<T>(G * n * n);
  s.slot_q = slot_values<T>(G * m * m);
  size_t o = 0;
  auto take = [&](size_t count) {
    T* p = base + o;
    o += slot_values<T>(int(count));
    return p;
  };
  for (int k = 0; k < kStages; ++k)
    s.stage[k] = take(size_t(kNodalIn) * s.slot_n + size_t(kQuadIn) * s.slot_q);
  s.vf = take(size_t(kFluxRows) * s.slot_q);
  s.tt = take(size_t(kFluxRows) * G * n * m);
  s.psiq = take(n * m);
  s.dpsiq = take(n * m);
  return o;
}

// NGL, NQ > 0 fix the 1-D sizes at compile time (index arithmetic by
// constants, lines in registers, inner loops unrolled); 0 takes them from
// the arguments. f32 is held to the registers of 2 blocks per SM. `botfr`
// is a kernel argument, the same for every thread: its branches do not
// diverge.
template <typename T, int NGL, int NQ>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 4 && NGL > 0) ? 2 : 1)
btp_volume_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = NGL > 0 ? NGL : a.ngl, m = NQ > 0 ? NQ : a.nq;
  const int npts = n * n, nqq = m * m;
  const int G = a.G;
  Smem<T> s;
  carve(s, reinterpret_cast<T*>(smem_raw), n, m, G);
  const int slot_n = s.slot_n, slot_q = s.slot_q;
  const int tt_chan = G * n * m;

  const int tid = threadIdx.x;
  const long long E = a.E;
  const long long sn = E * npts;   // channel stride, nodal arrays
  const long long sq = E * nqq;    // channel stride, quad arrays
  const long long ntiles = (E + G - 1) / G;

  for (int t = tid; t < n * m; t += kThreads) {
    s.psiq[t] = a.psiq[t];
    s.dpsiq[t] = a.dpsiq[t];
  }

  // start the copies of one tile's inputs into a stage (one group per tile)
  auto start_copies = [&](long long tile, T* st) {
    if (tile < ntiles) {
      const long long e0 = tile * G;
      const int g = int(E - e0 < G ? E - e0 : G);
      const long long on = e0 * npts, oq = e0 * nqq;
      T* qst = st + kNodalIn * slot_n;
      // (first slot, array, channels): the slot index also rotates the warps
      auto nodal = [&](int slot0, const T* src, long long stride, int nchan) {
        stage_channels(st + slot0 * slot_n, slot_n, src, stride, on, g * npts, nchan, slot0,
                       tid);
      };
      auto quad = [&](int slot0, const T* src, int nchan) {
        stage_channels(qst + slot0 * slot_q, slot_q, src, sq, oq, g * nqq, nchan,
                       kNodalIn + slot0, tid);
      };
      nodal(0, a.qb, sn, 4);
      nodal(kPbp, a.pbp, 0, 1);
      nodal(kAccn, a.accn, sn, 3);
      quad(0, a.qpl, 3);
      quad(kMet, a.met, 5);
      quad(kPtab, a.ptab, 8);
      quad(kCoup, a.coup, 4);
      quad(kAccv, a.accv, 12);
    }
    cp_async_commit();
  };

  fill_stages(s.stage[0], kStages * (kNodalIn * slot_n + kQuadIn * slot_q), tid);
  start_copies(blockIdx.x, s.stage[0]);
  int k = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, k ^= 1) {
    const long long e0 = tile * G;
    const int g = int(E - e0 < G ? E - e0 : G);
    const long long on = e0 * npts, oq = e0 * nqq;
    const T* sN = s.stage[k];
    const T* sQ = sN + kNodalIn * slot_n;

    // ---- top: next tile's copies start, this tile's have landed ------------
    // (every thread is past the previous tile's barrier after phase 4, so the
    // other stage, read up to phase 3, and vf/tt are free)
    start_copies(tile + gridDim.x, s.stage[k ^ 1]);
    cp_async_wait<1>();
    __syncthreads();

    // ---- phase 1: interpolation pass 1, nodal averages ---------------------
    interp_pass1<T, NGL, NQ>(sN, slot_n, 4, g, s.tt, tt_chan, s.psiq, n, m, tid);
    for (int P = kThreads - 1 - tid; P < g * npts; P += kThreads) {
      // nodal averages from the PRE-stage qb (the threads pass 1 leaves idle)
      const T t_df = sN[slot_n + P] * sN[kPbp * slot_n + P];
      const T inv_pb = T(1) / sN[P];
      a.accn[on + P] = sN[kAccn * slot_n + P] + t_df * (T(2) + t_df);
      a.accn[sn + on + P] = sN[(kAccn + 1) * slot_n + P] + sN[2 * slot_n + P] * inv_pb;
      a.accn[2 * sn + on + P] = sN[(kAccn + 2) * slot_n + P] + sN[3 * slot_n + P] * inv_pb;
    }
    __syncthreads();

    // ---- phase 2: interpolation pass 2 -------------------------------------
    interp_pass2<T, NGL, NQ>(s.tt, tt_chan, 4, g, s.vf, slot_q, s.psiq, n, m, tid);
    __syncthreads();

    // ---- phase 3: quad-point work over the tile as one flat run ------------
    for (int P = tid; P < g * nqq; P += kThreads) {
      const T dp = s.vf[P], dpp = s.vf[slot_q + P];
      const T udp = s.vf[2 * slot_q + P], vdp = s.vf[3 * slot_q + P];
      const T ppq = sQ[P], up = sQ[slot_q + P], vp = sQ[2 * slot_q + P];
      const T* sP = sQ + kPtab * slot_q;
      const T cor = sP[P];
      const T tau_u = sP[slot_q + P], tau_v = sP[2 * slot_q + P];
      const T gzx = sP[3 * slot_q + P], gzy = sP[4 * slot_q + P];
      const T opbp = sP[5 * slot_q + P];
      const T pp = sP[6 * slot_q + P] + ppq;   // full bottom-layer dp'
      const T Href = sP[7 * slot_q + P];

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

      const T sc_x = cor * vdp + a.grav * (tau_u - tb_u) - a.grav * dpp * gzx;
      const T sc_y = -cor * udp + a.grav * (tau_v - tb_v) - a.grav * dpp * gzy;

      const T* sC = sQ + kCoup * slot_q;
      const T Quu = sC[P], Quv = sC[slot_q + P];
      const T Qvv = sC[2 * slot_q + P], dHbcl = sC[3 * slot_q + P];
      const T mu = dpp * opbp;
      const T mu2 = mu * (T(2) + mu);
      const T ope = T(1) + mu;
      const T dHq = dHbcl + mu2 * (Href + dHbcl);
      const T qu = ub * udp + ope * Quu;
      const T quv = ub * vdp + ope * Quv;
      const T qv = vb * vdp + ope * Qvv;

      // 12 running averages, order of core/btp._VOL_ORDER: old value from the
      // stage, new value written once
      const T inc[12] = {dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp, tb_u, tb_v};
      const T* sA = sQ + kAccv * slot_q;
      // (plain stores: streaming stores, __stcs, gained nothing at 256x256)
#pragma unroll
      for (int c = 0; c < 12; ++c) a.accv[c * sq + oq + P] = sA[c * slot_q + P] + inc[c];

      const T* sM = sQ + kMet * slot_q;
      const T kx = sM[P], ky = sM[slot_q + P];
      const T ex = sM[2 * slot_q + P], ey = sM[3 * slot_q + P];
      const T wj = sM[4 * slot_q + P];
      // weighted flux rows: (a_ksi, a_eta) of the 3 channels, then the 2
      // sources; they take the place of this point's interpolated values
      const T fx1 = dHq + qu, fy2 = dHq + qv;
      s.vf[0 * slot_q + P] = wj * (udp * kx + vdp * ky);
      s.vf[1 * slot_q + P] = wj * (udp * ex + vdp * ey);
      s.vf[2 * slot_q + P] = wj * (fx1 * kx + quv * ky);
      s.vf[3 * slot_q + P] = wj * (fx1 * ex + quv * ey);
      s.vf[4 * slot_q + P] = wj * (quv * kx + fy2 * ky);
      s.vf[5 * slot_q + P] = wj * (quv * ex + fy2 * ey);
      s.vf[6 * slot_q + P] = wj * sc_x;
      s.vf[7 * slot_q + P] = wj * sc_y;
    }
    __syncthreads();

    // ---- phase 4: scatter pass 1 -------------------------------------------
    scatter_pass1<T, NGL, NQ>(s.vf, slot_q, g, s.tt, tt_chan, s.psiq, s.dpsiq, n, m, tid);
    __syncthreads();

    // ---- phase 5: scatter pass 2 -------------------------------------------
    scatter_pass2<T, NGL, NQ>(s.tt, tt_chan, g, s.psiq, s.dpsiq, static_cast<const T*>(nullptr),
                              a.rhs, sn, e0, n, m, tid);
  }
  cp_async_wait<0>();
}

template <typename T>
size_t smem_bytes(int ngl, int nq, int G) {
  Smem<T> s;
  return sizeof(T) * carve<T>(s, nullptr, ngl, nq, G);
}

template <typename T>
int tile_elements(int ngl, int nq) {
  return pick_tile([&](int G) { return smem_bytes<T>(ngl, nq, G); }, kSmemLimit);
}

template <typename T, int NGL, int NQ>
cudaError_t launch(Args<T>& a, cudaStream_t stream, LaunchPlan* describe) {
  a.G = tile_elements<T>(a.ngl, a.nq);
  if (a.G < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(a.ngl, a.nq, a.G);
  auto kernel = btp_volume_kernel<T, NGL, NQ>;
  LaunchPlan plan;
  cudaError_t err = plan_launch(kernel, kThreads, smem, plan);
  if (err != cudaSuccess) return err;
  if (describe) {
    *describe = plan;
    return cudaSuccess;
  }
  const long long ntiles = ((long long)a.E + a.G - 1) / a.G;
  const long long blocks = plan.resident_blocks < ntiles ? plan.resident_blocks : ntiles;
  kernel<<<dim3((unsigned)blocks), dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int botfr, const void* qb, const void* qpl, const void* met,
                const void* ptab, const void* coup, const void* psiq,
                const void* dpsiq, const void* pbp, void* accv, void* accn, void* rhs,
                int E, int ngl, int nq, double grav, double cd, double alpha_bot,
                cudaStream_t stream, LaunchPlan* describe) {
  Args<T> a;
  a.qb = static_cast<const T*>(qb);
  a.qpl = static_cast<const T*>(qpl);
  a.met = static_cast<const T*>(met);
  a.ptab = static_cast<const T*>(ptab);
  a.coup = static_cast<const T*>(coup);
  a.psiq = static_cast<const T*>(psiq);
  a.dpsiq = static_cast<const T*>(dpsiq);
  a.pbp = static_cast<const T*>(pbp);
  a.accv = static_cast<T*>(accv);
  a.accn = static_cast<T*>(accn);
  a.rhs = static_cast<T*>(rhs);
  a.E = E;
  a.ngl = ngl;
  a.nq = nq;
  a.botfr = botfr;
  a.G = 0;
  a.grav = T(grav);
  a.cd = T(cd);
  a.alpha_bot = T(alpha_bot);
  // p = 4 with exact integration (ngl = 5, nq = 9), the order the model is
  // run at, has its own instantiation; every other order takes the sizes at
  // run time
  if (ngl == 5 && nq == 9) return launch<T, 5, 9>(a, stream, describe);
  return launch<T, 0, 0>(a, stream, describe);
}

}  // namespace

extern "C" {

// The card's limit of shared memory for one block, in bytes.
long long btp_volume_smem_limit() { return (long long)kSmemLimit; }

// Shared memory one block needs at least (a tile of one element), in bytes:
// the caller checks it against the limit before launching.
long long btp_volume_smem_bytes(int is_double, int ngl, int nq) {
  return (long long)(is_double ? smem_bytes<double>(ngl, nq, 1)
                               : smem_bytes<float>(ngl, nq, 1));
}

// How a launch at these sizes is laid out on the current device: elements
// per tile, shared memory per block (bytes), resident blocks per SM.
// Returns a cudaError_t.
int btp_volume_describe(int is_double, int ngl, int nq, int* tile, long long* smem,
                        int* blocks_per_sm) {
  LaunchPlan plan;
  const cudaError_t err =
      is_double ? run<double>(0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, 1, ngl, nq, 0, 0, 0, nullptr,
                              &plan)
                : run<float>(0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, 1, ngl, nq, 0, 0, 0, nullptr,
                             &plan);
  if (err != cudaSuccess) return int(err);
  *tile = is_double ? tile_elements<double>(ngl, nq) : tile_elements<float>(ngl, nq);
  *smem = (long long)plan.smem;
  *blocks_per_sm = plan.blocks_per_sm;
  return 0;
}

// Launch on `stream`; does not synchronise. Returns the launch's cudaError_t.
int btp_volume_launch(int is_double, int botfr,
                      const void* qb, const void* qpl, const void* met,
                      const void* ptab, const void* coup, const void* psiq,
                      const void* dpsiq, const void* pbp,
                      void* accv, void* accn, void* rhs,
                      int E, int ngl, int nq,
                      double grav, double cd, double alpha_bot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || ngl <= 0 || nq <= 0 || botfr < 0 || botfr > 2)
    return int(cudaErrorInvalidValue);
  if (is_double) {
    return int(run<double>(botfr, qb, qpl, met, ptab, coup, psiq, dpsiq, pbp, accv, accn,
                           rhs, E, ngl, nq, grav, cd, alpha_bot, s, nullptr));
  }
  return int(run<float>(botfr, qb, qpl, met, ptab, coup, psiq, dpsiq, pbp, accv, accn, rhs,
                        E, ngl, nq, grav, cd, alpha_bot, s, nullptr));
}

const char* btp_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
