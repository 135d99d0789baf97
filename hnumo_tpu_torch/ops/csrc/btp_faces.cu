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
// What bounds it on this card: bytes. A viscous face moves 474 values in and
// 209 out at p=4 (683, of them 344 the accumulators' read and write) against
// ~1.5 kflop. What held the first version of this kernel at 2.4x that bound
// was the latency of its loads: 14 faces per block in three phases behind
// barriers, every load issued only when its phase began, and the 24
// accumulator updates read-modify-written through plain pointers, so that
// each load waited behind the store before it. What the design does about it
// (btp_tail_common.cuh has the shared parts):
//   - a block of 224 threads works a tile of 24 consecutive faces (12 in f64
//     and at p=8), so the pointwise phase is one flat run of 216 quad points
//     at p=4, and every channel of a tile is one run of 480 or 864 bytes;
//   - every global input of tile t+1 (traces, tables, and the old values of
//     af and ag) is on its way into the other stage of a two-stage ring
//     (cp.async, 16 bytes a copy where aligned) while tile t is computed, 45
//     KB a stage in f32; two blocks share an SM (tiles of 16 faces for three
//     blocks of 160 threads took 9% longer at 256x256: the longer runs win);
//   - the accumulators' new values are formed in registers from the staged
//     old ones and each is stored once; no global memory is read while a
//     tile is computed.
//
// One tile's phases (block-wide barrier between them):
//   top:     start the copies of the next tile; wait for this tile's
//   phase 1: thread = (face, quad point): interpolation of the 10 nodal rows
//            from the stage, pointwise physics, af written, the 3 flux
//            integrands -> shared memory; thread = (face, edge node), counted
//            from the top of the block: the LDG flux, ag and Sv written
//   phase 2: thread = (channel, face, node): integration against the edge
//            basis -> S, one coalesced run per channel
// The stage is read in phase 1 only, so the copies that the next tile starts
// into the other stage never meet a reader.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include "btp_tail_common.cuh"

namespace {

using namespace btptail;

// 7 warps: one round of the pointwise phase over 24 faces at p=4 (216 quad
// points), and two blocks per SM.
constexpr int kThreads = 224;
constexpr int kMostFaces = 24;
constexpr int kBlocksPerSM = 2;

// slots of a stage: nodal trL 8, trR 8, ntab 5, bgf 10, ag 8 (each G*ngl
// values); quad ftab 15, af 16 (each G*nq values). Inviscid tiles leave the
// gradient traces, bgf and ag out.
constexpr int kTrL = 0, kTrR = 8, kNtab = 16, kBgf = 21, kAg = 31, kNodalSlots = 39;
constexpr int kFtab = 0, kAf = 15, kQuadSlots = 31;

template <typename T>
struct Args {
  const T* __restrict__ trL;   // (8|4, F, ngl) left traces: qb 4 channels [, graduv 4]
  const T* __restrict__ trR;   // (8|4, F, ngl)
  const T* __restrict__ ftab;  // (15, F, nq): nx, ny, jac, cpL, cpR, cpub, omE, cmL, cmR,
                               //              cmLR, Hedge, Quu_e, Quv_e, Qvv_e, dHb_e
  const T* __restrict__ ntab;  // (5, F, ngl): pbdfL, pbdfR, nx_df, ny_df, jac_df
  const T* __restrict__ bgf;   // (10, F, ngl): viscosity face weights L(5), R(5)   (visc)
  const T* __restrict__ psiq;  // (ngl, nq)
  T* __restrict__ af;          // (16, F, nq)  in place
  T* __restrict__ ag;          // (8, F, ngl)  in place                             (visc)
  T* __restrict__ S;           // (3, F, ngl)  out
  T* __restrict__ Sv;          // (2, F, ngl)  out                                  (visc)
  int F, ngl, nq, visc;
  int G;                       // faces per tile
};

template <typename T>
struct Smem {
  T* stage[kStages];   // nodal slots (kNodalSlots), then quad slots (kQuadSlots)
  T* sq;               // (3, slot_q) the tile's flux integrands
  T* psiq;             // (ngl, nq)
  int slot_n, slot_q;
};

template <typename T>
__host__ __device__ size_t carve(Smem<T>& s, T* base, int n, int m, int G) {
  s.slot_n = slot_values<T>(G * n);
  s.slot_q = slot_values<T>(G * m);
  size_t o = 0;
  auto take = [&](size_t count) {
    T* p = base + o;
    o += slot_values<T>(int(count));
    return p;
  };
  for (int k = 0; k < kStages; ++k)
    s.stage[k] = take(size_t(kNodalSlots) * s.slot_n + size_t(kQuadSlots) * s.slot_q);
  s.sq = take(size_t(3) * s.slot_q);
  s.psiq = take(size_t(n) * m);
  return o;
}

// NGL, NQ > 0 fix the 1-D sizes at compile time (index arithmetic by
// constants, inner loops unrolled); 0 takes them from the arguments. f32 is
// held to the registers of kBlocksPerSM blocks per SM.
template <typename T, int NGL, int NQ>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 4 && NGL > 0) ? kBlocksPerSM : 1)
btp_faces_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = NGL > 0 ? NGL : a.ngl, m = NQ > 0 ? NQ : a.nq;
  const int G = a.G;
  Smem<T> s;
  carve(s, reinterpret_cast<T*>(smem_raw), n, m, G);
  const int slot_n = s.slot_n, slot_q = s.slot_q;

  const int tid = threadIdx.x;
  const long long F = a.F;
  const long long sn = F * n;   // channel stride, nodal face arrays
  const long long sm = F * m;   // channel stride, quad face arrays
  const long long ntiles = (F + G - 1) / G;

  for (int t = tid; t < n * m; t += kThreads) s.psiq[t] = a.psiq[t];

  // start the copies of one tile's inputs into a stage (one group per tile)
  auto start_copies = [&](long long tile, T* st) {
    if (tile < ntiles) {
      const long long f0 = tile * G;
      const int g = int(F - f0 < G ? F - f0 : G);
      const long long on = f0 * n, oq = f0 * m;
      const int C = a.visc ? 8 : 4;
      T* qst = st + kNodalSlots * slot_n;
      int rot = 0;
      auto nodal = [&](int slot0, const T* src, int nchan) {
        stage_runs<kThreads>(st + slot0 * slot_n, slot_n, src, sn, on, g * n, nchan, tid, rot);
      };
      auto quad = [&](int slot0, const T* src, int nchan) {
        stage_runs<kThreads>(qst + slot0 * slot_q, slot_q, src, sm, oq, g * m, nchan, tid,
                             rot);
      };
      nodal(kTrL, a.trL, C);
      nodal(kTrR, a.trR, C);
      nodal(kNtab, a.ntab, 5);
      if (a.visc) {
        nodal(kBgf, a.bgf, 10);
        nodal(kAg, a.ag, 8);
      }
      quad(kFtab, a.ftab, 15);
      quad(kAf, a.af, 16);
    }
    cp_async_commit();
  };

  fill_stages<kThreads>(s.stage[0],
                        kStages * (kNodalSlots * slot_n + kQuadSlots * slot_q), tid);
  start_copies(blockIdx.x, s.stage[0]);
  int k = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, k ^= 1) {
    const long long f0 = tile * G;
    const int g = int(F - f0 < G ? F - f0 : G);
    const long long on = f0 * n, oq = f0 * m;
    const T* sN = s.stage[k];
    const T* sQ = sN + kNodalSlots * slot_n;

    // ---- top: next tile's copies start, this tile's have landed ------------
    // (every thread is past the previous tile's phase-1 barrier, so the other
    // stage, read in phase 1 only, is free; sq is written after the barrier
    // below, when the previous tile's phase 2 is done with it)
    start_copies(tile + gridDim.x, s.stage[k ^ 1]);
    cp_async_wait<1>();
    __syncthreads();

    // ---- phase 1a: thread = (face, quad point) of the tile -----------------
    for (int P = tid; P < g * m; P += kThreads) {
      const int fl = P / m, q = P - fl * m;
      // the 10 interpolated rows: trL 0-3, trR 0-3, pbdfL, pbdfR
      const T* row = sN + fl * n;
      T v[10];
#pragma unroll
      for (int c = 0; c < 10; ++c) v[c] = T(0);
      const int nn = NGL > 0 ? NGL : n;
#pragma unroll
      for (int kk = 0; kk < nn; ++kk) {
#if BTP_ABLATE == 1
        // the interpolation compiled out: one staged value per row
        if (kk == q % n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            v[c] = row[(kTrL + c) * slot_n + kk];
            v[4 + c] = row[(kTrR + c) * slot_n + kk];
          }
          v[8] = row[kNtab * slot_n + kk];
          v[9] = row[(kNtab + 1) * slot_n + kk];
        }
#else
        const T p = s.psiq[kk * m + q];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] += row[(kTrL + c) * slot_n + kk] * p;
          v[4 + c] += row[(kTrR + c) * slot_n + kk] * p;
        }
        v[8] += row[kNtab * slot_n + kk] * p;
        v[9] += row[(kNtab + 1) * slot_n + kk] * p;
#endif
      }
      const T l0 = v[0], l1 = v[1], l2 = v[2], l3 = v[3];
      const T r0 = v[4], r1 = v[5], r2 = v[6], r3 = v[7];
      const T pbl = v[8], pbr = v[9];

      const T* ft = sQ + kFtab * slot_q + P;
      const T nx = ft[0], ny = ft[slot_q], jacf = ft[2 * slot_q];
      const T cpL = ft[3 * slot_q], cpR = ft[4 * slot_q];
      const T cpub = ft[5 * slot_q], omE = ft[6 * slot_q];
      const T cmL = ft[7 * slot_q], cmR = ft[8 * slot_q];
      const T cmLR = ft[9 * slot_q], Hedge = ft[10 * slot_q];
      const T Qe_uu = ft[11 * slot_q], Qe_uv = ft[12 * slot_q];
      const T Qe_vv = ft[13 * slot_q], dHe = ft[14 * slot_q];

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
      // 16 face averages, order of core/btp._FACE_ORDER: old value from the
      // stage, new value stored once
      const T inc[16] = {dH_f, quu, quv, qvu, qvv, muL, muR, muL * (T(2) + muL),
                         muR * (T(2) + muR), flux_ex, flux_ey, mue2, ul, ur, vl, vr};
      const T* old = sQ + kAf * slot_q + P;
#pragma unroll
      for (int c = 0; c < 16; ++c) a.af[c * sm + oq + P] = old[c * slot_q] + inc[c];
      s.sq[P] = jacf * fl_m;
      s.sq[slot_q + P] = jacf * (nx * dH_f + fl_x);
      s.sq[2 * slot_q + P] = jacf * (ny * dH_f + fl_y);
    }

    // ---- phase 1b: thread = (face, edge node), counted from the top --------
    // (at p=4 the threads phase 1a leaves idle take the first of these)
    if (a.visc) {
      for (int t = kThreads - 1 - tid; t < g * n; t += kThreads) {
        const T* b = sN + kBgf * slot_n + t;
        const T bmulL = b[4 * slot_n], bmulR = b[9 * slot_n];
        T fl[4], fr[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const T gl = sN[(kTrL + 4 + c) * slot_n + t];
          const T gr = sN[(kTrR + 4 + c) * slot_n + t];
          a.ag[c * sn + on + t] = sN[(kAg + c) * slot_n + t] + gl;
          a.ag[(4 + c) * sn + on + t] = sN[(kAg + 4 + c) * slot_n + t] + gr;
          fl[c] = bmulL * gl + b[c * slot_n];
          fr[c] = bmulR * gr + b[(5 + c) * slot_n];
        }
        const T* nt = sN + kNtab * slot_n + t;
        const T nxdf = nt[2 * slot_n], nydf = nt[3 * slot_n], jacdf = nt[4 * slot_n];
        a.Sv[on + t] = jacdf * ((T(0.5) * (fl[0] + fr[0]) - fl[0] * nxdf)
                                + (T(0.5) * (fl[1] + fr[1]) - fl[1] * nydf));
        a.Sv[sn + on + t] = jacdf * ((T(0.5) * (fl[2] + fr[2]) - fl[2] * nxdf)
                                     + (T(0.5) * (fl[3] + fr[3]) - fl[3] * nydf));
      }
    }
    __syncthreads();

    // ---- phase 2: integrate the fluxes against the edge basis --------------
    const int outs = g * n;
    for (int t = tid; t < 3 * outs; t += kThreads) {
      const int c = t / outs, r = t - c * outs;
      const int fl = r / n, kk = r - fl * n;
      const T* row = s.sq + c * slot_q + fl * m;
#if BTP_ABLATE == 1
      const T acc = row[kk];   // the integration compiled out
#else
      const T* p = s.psiq + kk * m;
      T acc = T(0);
      const int mm = NQ > 0 ? NQ : m;
#pragma unroll
      for (int q = 0; q < mm; ++q) acc += row[q] * p[q];
#endif
      a.S[c * sn + on + r] = acc;
    }
  }
  cp_async_wait<0>();
}

template <typename T>
size_t smem_bytes(int ngl, int nq, int G) {
  Smem<T> s;
  return sizeof(T) * carve<T>(s, nullptr, ngl, nq, G);
}

template <typename T>
int tile_faces(int ngl, int nq) {
  return pick_tile([&](int G) { return smem_bytes<T>(ngl, nq, G); }, kMostFaces,
                   kBlocksPerSM);
}

template <typename T, int NGL, int NQ>
cudaError_t launch(Args<T>& a, cudaStream_t stream, LaunchPlan* describe) {
  a.G = tile_faces<T>(a.ngl, a.nq);
  if (a.G < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(a.ngl, a.nq, a.G);
  auto kernel = btp_faces_kernel<T, NGL, NQ>;
  LaunchPlan plan;
  cudaError_t err = plan_launch(kernel, kThreads, smem, plan);
  if (err != cudaSuccess) return err;
  if (describe) {
    *describe = plan;
    return cudaSuccess;
  }
  const long long ntiles = ((long long)a.F + a.G - 1) / a.G;
  const long long blocks = plan.resident_blocks < ntiles ? plan.resident_blocks : ntiles;
  kernel<<<dim3((unsigned)blocks), dim3(kThreads), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int F, int ngl, int nq, int visc, const void* trL, const void* trR,
                const void* ftab, const void* ntab, const void* bgf, const void* psiq,
                void* af, void* ag, void* S, void* Sv, cudaStream_t stream,
                LaunchPlan* describe) {
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
  a.G = 0;
  // p = 4 with exact integration (ngl = 5, nq = 9), the order the model is
  // run at, has its own instantiation; every other order takes the sizes at
  // run time
  if (ngl == 5 && nq == 9) return launch<T, 5, 9>(a, stream, describe);
  return launch<T, 0, 0>(a, stream, describe);
}

}  // namespace

extern "C" {

// The card's limit of shared memory for one block, in bytes.
long long btp_faces_smem_limit() { return (long long)kSmemLimit; }

// Shared memory one block needs at least (a tile of one face), in bytes: the
// caller checks it against the limit before launching.
long long btp_faces_smem_bytes(int is_double, int ngl, int nq) {
  return (long long)(is_double ? smem_bytes<double>(ngl, nq, 1)
                               : smem_bytes<float>(ngl, nq, 1));
}

// How a launch at these sizes is laid out on the current device: faces per
// tile, shared memory per block (bytes), resident blocks per SM. Returns a
// cudaError_t.
int btp_faces_describe(int is_double, int ngl, int nq, int* tile, long long* smem,
                       int* blocks_per_sm) {
  LaunchPlan plan;
  const cudaError_t err =
      is_double ? run<double>(1, ngl, nq, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, &plan)
                : run<float>(1, ngl, nq, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, &plan);
  if (err != cudaSuccess) return int(err);
  *tile = is_double ? tile_faces<double>(ngl, nq) : tile_faces<float>(ngl, nq);
  *smem = (long long)plan.smem;
  *blocks_per_sm = plan.blocks_per_sm;
  return 0;
}

// Launch on `stream`; does not synchronise. Returns the launch's cudaError_t.
// `bgf`, `ag` and `Sv` may be null when `visc` is 0. S and Sv must not
// overlap any operand; af and ag are read and written in place.
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
                           S, Sv, s, nullptr));
  return int(run<float>(F, ngl, nq, visc, trL, trR, ftab, ntab, bgf, psiq, af, ag,
                        S, Sv, s, nullptr));
}

const char* btp_faces_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
