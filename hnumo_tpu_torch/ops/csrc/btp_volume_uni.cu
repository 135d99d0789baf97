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
// Gx, Gy (25x25) because its matrix unit wants large products. Here every
// product is two passes over the 1-D tables psiq, dpsiq, dpsi (sum
// factorisation): 9.5 k multiply-adds per element at p=4 instead of 35 k.
//
// What bounds it on this card: bytes (with the gradient and a flat bottom an
// element moves 2157 values in and 1322 out, 3479 at p=4, against ~25 kflop),
// and what held the first version of this kernel at 2.7x that bound was the
// latency of its loads, not their number: built with its global reads
// replaced by computed values it took 0.264 ms at 256x256 where the whole
// kernel took 0.745 and the loads alone (contractions compiled out) 0.838 —
// one element per block, five block-wide barriers per element, and the 12
// accumulator updates as 12 dependent round trips to device memory (a load
// behind each store through the same pointer). What the design does about
// it (btp_volume_common.cuh has the shared parts):
//   - a block works a tile of 4 consecutive elements, so the pointwise phase
//     is one flat, coalesced run of 324 quad points for 352 threads, and the
//     five barriers are paid once per 4 elements;
//   - every global input of tile t+1, the accumulators' old values included,
//     is on its way into the other stage of a two-stage shared-memory ring
//     (cp.async, 16 bytes a copy where aligned) while tile t is computed; the
//     accumulators are then written once, from registers, with no read in
//     front of them;
//   - in the four 1-D passes a thread owns a line, holds it in registers and
//     produces all of its outputs.
// Two blocks of 352 threads are resident per SM (93 KB of shared memory
// each at p=4 in f32): fewer threads than the SM could keep, which is enough
// because the ring, not the number of warps, keeps the loads in flight —
// each block has a whole tile (37 KB) under way at any time.
// The three flags (botfr, flat, grad) are kernel arguments, the same for
// every thread, so the branches on them do not diverge and the build stays
// at four instantiations (f32/f64, p=4 sizes at compile time / any order at
// run time).
//
// One tile's phases (block-wide barrier between them):
//   top:     start the copies of the next tile; wait for this tile's
//   phase 1: interpolation pass 1 (along i); nodal averages; u, v
//   phase 2: interpolation pass 2 (along j); velocity gradient gv and agr
//   phase 3: thread = quad point of the tile: pointwise physics, the 12
//            accumulator rows written, 8 weighted flux rows -> shared memory
//   phase 4: scatter pass 1 (along I)
//   phase 5: scatter pass 2 (along J), times minv -> rhs
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include "btp_volume_common.cuh"

namespace {

using namespace btpvol;

// channels of a stage: nodal qb 4, qpl 3, pbp 1, accn 3, agr 4; quad ptab
// 6|8, coup 4, accv 12 (room for 8 rows of ptab either way)
constexpr int kNodalIn = 15;
constexpr int kQuadIn = 24;
constexpr int kPbp = 7, kAccn = 8, kAgr = 11;

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
  int G;           // elements per tile
  T grav, cd, alpha_bot, kx_df, ey_df;
};

template <typename T>
struct Smem {
  T *psiq, *dpsiq, *dpsi, *wq3, *minv;   // operators
  T *stage[kStages];   // nodal channels (kNodalIn slots), then quad (kQuadIn)
  T *vf;       // (8, slot_q)       interpolated channels, then flux rows
  T *tt;       // (8, G*ngl*nq)     first pass of interpolation and of scatter
  T *uv;       // (2, G*npts)       u, v
  int slot_n, slot_q;
};

template <typename T>
__host__ __device__ size_t carve(Smem<T>& s, T* base, int n, int m, int G) {
  const int npts = n * n, nqq = m * m;
  s.slot_n = slot_values<T>(G * npts);
  s.slot_q = slot_values<T>(G * nqq);
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
  s.uv = take(2 * G * npts);
  s.psiq = take(n * m);   s.dpsiq = take(n * m);   s.dpsi = take(n * n);
  s.wq3 = take(3 * nqq);  s.minv = take(npts);
  return o;
}

// NGL, NQ > 0 fix the 1-D sizes at compile time (index arithmetic by
// constants, lines in registers, inner loops unrolled); 0 takes them from
// the arguments. f32 is held to the registers of 2 blocks per SM.
template <typename T, int NGL, int NQ>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 4 && NGL > 0) ? 2 : 1)
btp_volume_uni_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = NGL > 0 ? NGL : a.ngl, m = NQ > 0 ? NQ : a.nq;
  const int npts = n * n, nqq = m * m;
  const int G = a.G;
  Smem<T> s;
  carve(s, reinterpret_cast<T*>(smem_raw), n, m, G);
  const int slot_n = s.slot_n, slot_q = s.slot_q;
  const int tt_chan = G * n * m;
  const int uv_chan = G * npts;
  const int rows = a.flat ? 6 : 8;   // of ptab; coup and accv follow it in a stage

  const int tid = threadIdx.x;
  const long long E = a.E;
  const long long sn = E * npts;   // channel stride, nodal arrays
  const long long sq = E * nqq;    // channel stride, quad arrays
  const long long ntiles = (E + G - 1) / G;

  for (int t = tid; t < n * m; t += kThreads) {
    s.psiq[t] = a.psiq[t];
    s.dpsiq[t] = a.dpsiq[t];
  }
  for (int t = tid; t < n * n; t += kThreads) s.dpsi[t] = a.dpsi[t];
  for (int t = tid; t < 3 * nqq; t += kThreads) s.wq3[t] = a.wq3[t];
  for (int t = tid; t < npts; t += kThreads) s.minv[t] = a.minv[t];

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
      nodal(4, a.qpl, sn, 3);
      nodal(kPbp, a.pbp, 0, 1);
      nodal(kAccn, a.accn, sn, 3);
      if (a.grad) nodal(kAgr, a.agr, sn, 4);
      quad(0, a.ptab, rows);
      quad(rows, a.coup, 4);
      quad(rows + 4, a.accv, 12);
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
    // other stage, read up to phase 3, and vf/tt/uv are free)
    start_copies(tile + gridDim.x, s.stage[k ^ 1]);
    cp_async_wait<1>();
    __syncthreads();

    // ---- phase 1: interpolation pass 1, nodal averages, u and v ------------
    interp_pass1<T, NGL, NQ>(sN, slot_n, 7, g, s.tt, tt_chan, s.psiq, n, m, tid);
    for (int P = kThreads - 1 - tid; P < g * npts; P += kThreads) {
      // nodal averages from the PRE-stage qb (the threads pass 1 leaves idle)
      const T inv_pb = T(1) / sN[P];
      const T t_df = sN[slot_n + P] * sN[kPbp * slot_n + P];
      const T u = sN[2 * slot_n + P] * inv_pb;
      const T v = sN[3 * slot_n + P] * inv_pb;
      a.accn[on + P] = sN[kAccn * slot_n + P] + t_df * (T(2) + t_df);
      a.accn[sn + on + P] = sN[(kAccn + 1) * slot_n + P] + u;
      a.accn[2 * sn + on + P] = sN[(kAccn + 2) * slot_n + P] + v;
      s.uv[P] = u;
      s.uv[uv_chan + P] = v;
    }
    __syncthreads();

    // ---- phase 2: interpolation pass 2, velocity gradient ------------------
    interp_pass2<T, NGL, NQ>(s.tt, tt_chan, 7, g, s.vf, slot_q, s.psiq, n, m, tid);
    if (a.grad) {
      // gv[c]: c = 0, 2 d/dx of u, v (along i, a thread owns row j);
      //        c = 1, 3 d/dy (along j, a thread owns column i)
      const int lines = g * n;
      for (int t = kThreads - 1 - tid; t < 4 * lines; t += kThreads) {
        const int c = t / lines, r = t - c * lines;
        const int gg = r / n, l = r - gg * n;
        const bool along_i = (c & 1) == 0;
        const T* f = s.uv + (c >> 1) * uv_chan + gg * npts + (along_i ? l * n : l);
        const T scale = along_i ? a.kx_df : a.ey_df;
        const int first = gg * npts + (along_i ? l * n : l), step = along_i ? 1 : n;
        const T* old = sN + (kAgr + c) * slot_n + first;
        T* gv = a.gv + c * sn + on + first;
        T* agr = a.agr + c * sn + on + first;
        contract_line<T, NGL, NGL>(f, step, n, n, s.dpsi, n, 1, [&](int o, T acc) {
          acc *= scale;
          gv[o * step] = acc;
          agr[o * step] = old[o * step] + acc;
        });
      }
    }
    __syncthreads();

    // ---- phase 3: quad-point work over the tile as one flat run ------------
    for (int P = tid; P < g * nqq; P += kThreads) {
      const int q = P % nqq;
      const T dp = s.vf[P], dpp = s.vf[slot_q + P];
      const T udp = s.vf[2 * slot_q + P], vdp = s.vf[3 * slot_q + P];
      const T ppq = s.vf[4 * slot_q + P];
      const T up = s.vf[5 * slot_q + P], vp = s.vf[6 * slot_q + P];
      const T cor = sQ[P];
      const T tau_u = sQ[slot_q + P], tau_v = sQ[2 * slot_q + P];
      const T opbp = sQ[3 * slot_q + P];
      const T pp = sQ[4 * slot_q + P] + ppq;   // full bottom-layer dp'
      const T Href = sQ[5 * slot_q + P];

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
        sc_x -= a.grav * dpp * sQ[6 * slot_q + P];
        sc_y -= a.grav * dpp * sQ[7 * slot_q + P];
      }

      const T* sC = sQ + rows * slot_q;
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
      const T* sA = sC + 4 * slot_q;
      // (plain stores: streaming stores, __stcs, gained nothing at 256x256)
#pragma unroll
      for (int c = 0; c < 12; ++c) a.accv[c * sq + oq + P] = sA[c * slot_q + P] + inc[c];

      // weighted flux rows: (x, y) of the 3 channels, then the 2 sources; they
      // take the place of this point's interpolated values
      const T wkx = s.wq3[q], wey = s.wq3[nqq + q], w = s.wq3[2 * nqq + q];
      s.vf[0 * slot_q + P] = wkx * udp;
      s.vf[1 * slot_q + P] = wey * vdp;
      s.vf[2 * slot_q + P] = wkx * (dHq + qu);
      s.vf[3 * slot_q + P] = wey * quv;
      s.vf[4 * slot_q + P] = wkx * quv;
      s.vf[5 * slot_q + P] = wey * (dHq + qv);
      s.vf[6 * slot_q + P] = w * sc_x;
      s.vf[7 * slot_q + P] = w * sc_y;
    }
    __syncthreads();

    // ---- phase 4: scatter pass 1 -------------------------------------------
    scatter_pass1<T, NGL, NQ>(s.vf, slot_q, g, s.tt, tt_chan, s.psiq, s.dpsiq, n, m, tid);
    __syncthreads();

    // ---- phase 5: scatter pass 2, inverse mass -----------------------------
    scatter_pass2<T, NGL, NQ>(s.tt, tt_chan, g, s.psiq, s.dpsiq, s.minv, a.rhs, sn, e0, n, m,
                              tid);
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
  auto kernel = btp_volume_uni_kernel<T, NGL, NQ>;
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
cudaError_t run(int E, int ngl, int nq, int botfr, int flat, int grad,
                const void* qb, const void* qpl, const void* ptab, const void* coup,
                const void* pbp, const void* psiq, const void* dpsiq,
                const void* dpsi, const void* wq3, const void* minv, void* accv,
                void* accn, void* agr, void* rhs, void* gv, double grav, double cd,
                double alpha_bot, double kx_df, double ey_df, cudaStream_t stream,
                LaunchPlan* describe) {
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
  a.G = 0;
  a.grav = T(grav); a.cd = T(cd); a.alpha_bot = T(alpha_bot);
  a.kx_df = T(kx_df); a.ey_df = T(ey_df);
  // p = 4 with exact integration (ngl = 5, nq = 9), the order the model is
  // run at, has its own instantiation; every other order takes the sizes at
  // run time
  if (ngl == 5 && nq == 9) return launch<T, 5, 9>(a, stream, describe);
  return launch<T, 0, 0>(a, stream, describe);
}

}  // namespace

extern "C" {

// The card's limit of shared memory for one block, in bytes.
long long btp_volume_uni_smem_limit() { return (long long)kSmemLimit; }

// Shared memory one block needs at least (a tile of one element), in bytes:
// the caller checks it against the limit before launching.
long long btp_volume_uni_smem_bytes(int is_double, int ngl, int nq) {
  return (long long)(is_double ? smem_bytes<double>(ngl, nq, 1)
                               : smem_bytes<float>(ngl, nq, 1));
}

// How a launch at these sizes is laid out on the current device: elements
// per tile, shared memory per block (bytes), resident blocks per SM.
// Returns a cudaError_t.
int btp_volume_uni_describe(int is_double, int ngl, int nq, int* tile,
                            long long* smem, int* blocks_per_sm) {
  LaunchPlan plan;
  const cudaError_t err =
      is_double ? run<double>(1, ngl, nq, 0, 1, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, nullptr, &plan)
                : run<float>(1, ngl, nq, 0, 1, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, nullptr, &plan);
  if (err != cudaSuccess) return int(err);
  *tile = is_double ? tile_elements<double>(ngl, nq) : tile_elements<float>(ngl, nq);
  *smem = (long long)plan.smem;
  *blocks_per_sm = plan.blocks_per_sm;
  return 0;
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
                           alpha_bot, kx_df, ey_df, s, nullptr));
  }
  return int(run<float>(E, ngl, nq, botfr, flat, grad, qb, qpl, ptab, coup, pbp, psiq,
                        dpsiq, dpsi, wq3, minv, accv, accn, agr, rhs, gv, grav, cd,
                        alpha_bot, kx_df, ey_df, s, nullptr));
}

const char* btp_volume_uni_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
