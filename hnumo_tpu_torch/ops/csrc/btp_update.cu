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
// lets them alias each other (no input is written, so every input pointer is
// read-only and may be `__restrict__` against the output).
//
// The TPU kernel multiplies the edge stack by 0/1 placement matrices scaled by
// massinv (Escat, Evisc, 20x25) and the viscous flux by Kronecker matrices Vx,
// Vy (25x25), because its matrix unit wants products. Here the placement is an
// indexed sum of at most two edge values per node, and the Laplacian is
// sum-factorised from the 1-D derivative table dpsi.
//
// What bounds it on this card: bytes. A viscous element moves 775 values in
// (of the three registers only rows 1..3 are read) and 100 out at p=4
// against ~2 kflop. What held the first version of this kernel at 2.6x that
// bound was the latency of its loads: one thread per (channel, element,
// node) in passes of 3 elements, each load issued when its pass began, the
// viscous flux formed behind a barrier from loads of that phase. What the
// design does about it (btp_tail_common.cuh has the shared parts):
//   - a block of 416 threads works a tile of 16 consecutive elements (8 in
//     f64, 4 at p=8), one thread per (element, node) for all three rows: the
//     edge placement and minv are looked up once, not per row;
//   - every global input of tile t+1 is on its way into the other stage of a
//     two-stage ring (cp.async, 16 bytes a copy where aligned) while tile t is
//     computed, 50 KB a stage in f32; two blocks share an SM (tiles of 8 for
//     four blocks of 224 threads took 4% longer at 256x256: longer runs);
//   - dpsi, wn2 and minv are staged once per block; the weighted viscous flux
//     wn2 * (pbpv*gv + bdg) is formed in shared memory from the landed stage;
//     the four SSPRK weights are kernel arguments (no device read).
//
// One tile's phases (block-wide barrier between them):
//   top:     wait for this tile's copies; then start the next tile's
//   phase 1: (visc) thread = (element, node): the 4 weighted flux channels
//   phase 2: thread = (element, node): the three rows, the SSPRK combine, the
//            4 output channels as coalesced runs
// The stage is read up to the last phase, so the copies into the other stage
// start only after the top barrier, when every thread is done with the
// previous tile: wait_group 0, barrier, then the next tile's copies.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cuda_runtime.h>

#include "btp_tail_common.cuh"

namespace {

using namespace btptail;

// 13 warps: one round over 16 elements at p=4 (400 nodes), two blocks per SM.
constexpr int kThreads = 416;
constexpr int kMostElements = 16;
constexpr int kBlocksPerSM = 2;

// slots of a stage: nodal rhs 3, qb0/qb1/qb2 rows 1..3 (3 each), ref 3,
// pbdf 1, mask 2, gv 4, pbpv 1, bdg 4 (each G*npts values); edge slots
// edges 3, vedges 2 (each G*4*ngl values). Inviscid tiles leave gv, pbpv,
// bdg and vedges out.
constexpr int kRhs = 0, kQb0 = 3, kQb1 = 6, kQb2 = 9, kRef = 12, kPbdf = 15, kMask = 16;
constexpr int kGv = 18, kPbpv = 22, kBdg = 23, kNodalSlots = 27;
constexpr int kEdges = 0, kVedges = 3, kEdgeSlots = 5;

template <typename T>
struct Args {
  const T* __restrict__ rhs;     // (3, E, npts)   massinv-folded volume RHS
  const T* __restrict__ edges;   // (3, E, 4*ngl)  signed face values [W, E, S, N]
  const T* __restrict__ qb0;     // (4, E, npts)   SSPRK registers (may alias each
  const T* __restrict__ qb1;     //                other: all three are only read)
  const T* __restrict__ qb2;
  const T* __restrict__ ref;     // (3, E, npts)   massinv * btp_rhs_ref
  const T* __restrict__ pbdf;    // (E, npts)      pbprime_df
  const T* __restrict__ mask;    // (2, E, npts)   wall projection of (pbub, pbvb)
  const T* __restrict__ minv;    // (npts)         inverse lumped mass of the brick
  const T* __restrict__ vedges;  // (2, E, 4*ngl)                                 (visc)
  const T* __restrict__ gv;      // (4, E, npts)   grad(u, v)                      (visc)
  const T* __restrict__ pbpv;    // (E, npts)      pbprime_visc                    (visc)
  const T* __restrict__ bdg;     // (4, E, npts)   btp_dpp_graduv                  (visc)
  const T* __restrict__ dpsi;    // (ngl, ngl)                                     (visc)
  const T* __restrict__ wn2;     // (2, npts): w_df*ksi_x, w_df*eta_y              (visc)
  T* __restrict__ out;           // (4, E, npts)   new state
  int E, ngl, visc;
  int G;                         // elements per tile
  T a0, a1, a2, dtt, nu;
};

template <typename T>
struct Smem {
  T* stage[kStages];   // nodal slots (kNodalSlots), then edge slots (kEdgeSlots)
  T* qq;               // (4, slot_n) the tile's weighted viscous flux
  T *dpsi, *wn2, *minv;
  int slot_n, slot_e;
};

template <typename T>
__host__ __device__ size_t carve(Smem<T>& s, T* base, int n, int G) {
  const int npts = n * n;
  s.slot_n = slot_values<T>(G * npts);
  s.slot_e = slot_values<T>(G * 4 * n);
  size_t o = 0;
  auto take = [&](size_t count) {
    T* p = base + o;
    o += slot_values<T>(int(count));
    return p;
  };
  for (int k = 0; k < kStages; ++k)
    s.stage[k] = take(size_t(kNodalSlots) * s.slot_n + size_t(kEdgeSlots) * s.slot_e);
  s.qq = take(size_t(4) * s.slot_n);
  s.dpsi = take(size_t(n) * n);
  s.wn2 = take(size_t(2) * npts);
  s.minv = take(npts);
  return o;
}

// NGL > 0 fixes the 1-D size at compile time (index arithmetic by constants,
// the Laplacian's loop unrolled); 0 takes it from the arguments. f32 is held
// to the registers of kBlocksPerSM blocks per SM (72 a thread: phase 2 is
// written to keep few values live; with the Laplacian of each row on its own
// ptxas spilled 24 B there, and 3 blocks of 80 registers took 8% longer).
template <typename T, int NGL>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 4 && NGL > 0) ? kBlocksPerSM : 1)
btp_update_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = NGL > 0 ? NGL : a.ngl, npts = n * n;
  const int G = a.G;
  Smem<T> s;
  carve(s, reinterpret_cast<T*>(smem_raw), n, G);
  const int slot_n = s.slot_n, slot_e = s.slot_e;

  const int tid = threadIdx.x;
  const long long E = a.E;
  const long long sn = E * npts;      // channel stride, nodal arrays
  const long long se = E * 4 * n;     // channel stride, edge arrays
  const long long ntiles = (E + G - 1) / G;

  for (int t = tid; t < npts; t += kThreads) s.minv[t] = a.minv[t];
  if (a.visc) {
    for (int t = tid; t < n * n; t += kThreads) s.dpsi[t] = a.dpsi[t];
    for (int t = tid; t < 2 * npts; t += kThreads) s.wn2[t] = a.wn2[t];
  }

  // start the copies of one tile's inputs into a stage (one group per tile)
  auto start_copies = [&](long long tile, T* st) {
    if (tile < ntiles) {
      const long long e0 = tile * G;
      const int g = int(E - e0 < G ? E - e0 : G);
      const long long on = e0 * npts, oe = e0 * 4 * n;
      T* est = st + kNodalSlots * slot_n;
      int rot = 0;
      auto nodal = [&](int slot0, const T* src, long long stride, int nchan) {
        stage_runs<kThreads>(st + slot0 * slot_n, slot_n, src, stride, on, g * npts, nchan, tid,
                             rot);
      };
      auto edge = [&](int slot0, const T* src, int nchan) {
        stage_runs<kThreads>(est + slot0 * slot_e, slot_e, src, se, oe, g * 4 * n, nchan, tid,
                             rot);
      };
      nodal(kRhs, a.rhs, sn, 3);
      nodal(kQb0, a.qb0 + sn, sn, 3);   // rows 1..3 of each register
      nodal(kQb1, a.qb1 + sn, sn, 3);
      nodal(kQb2, a.qb2 + sn, sn, 3);
      nodal(kRef, a.ref, sn, 3);
      nodal(kPbdf, a.pbdf, 0, 1);
      nodal(kMask, a.mask, sn, 2);
      edge(kEdges, a.edges, 3);
      if (a.visc) {
        nodal(kGv, a.gv, sn, 4);
        nodal(kPbpv, a.pbpv, 0, 1);
        nodal(kBdg, a.bdg, sn, 4);
        edge(kVedges, a.vedges, 2);
      }
    }
    cp_async_commit();
  };

  fill_stages<kThreads>(s.stage[0],
                        kStages * (kNodalSlots * slot_n + kEdgeSlots * slot_e), tid);
  start_copies(blockIdx.x, s.stage[0]);
  int k = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, k ^= 1) {
    const long long e0 = tile * G;
    const int g = int(E - e0 < G ? E - e0 : G);
    const long long on = e0 * npts;
    const T* sN = s.stage[k];
    const T* sE = sN + kNodalSlots * slot_n;

    // ---- top: this tile's copies have landed, the next tile's start --------
    // (past this barrier every thread is done with the previous tile: its
    // stage, the other one, and qq are free)
    cp_async_wait<0>();
    __syncthreads();
    start_copies(tile + gridDim.x, s.stage[k ^ 1]);

    // ---- phase 1 (visc): qq = pbprime_visc * graduv + btp_dpp_graduv,
    // weighted for the nodal quadrature: x-derivative channels (0, 2) by
    // w*ksi_x, (1, 3) by w*eta_y
    if (a.visc) {
      for (int P = tid; P < g * npts; P += kThreads) {
        const int nn = P % npts;
        const T pv = sN[kPbpv * slot_n + P];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s.qq[c * slot_n + P] = s.wn2[(c & 1) * npts + nn]
              * (pv * sN[(kGv + c) * slot_n + P] + sN[(kBdg + c) * slot_n + P]);
      }
      __syncthreads();
    }

    // ---- phase 2: thread = (element, node), the three rows -----------------
    // (each row is stored as soon as it is formed, and the two momentum rows
    // share their dpsi loads: few values live at once)
    for (int P = tid; P < g * npts; P += kThreads) {
      const int el = P / npts, nn = P - el * npts;
      const int j = nn / n, i = nn - j * n;
      // the edge slots node (j, i) lies on: west/east, then south/north
      const int sx = i == 0 ? j : (i == n - 1 ? n + j : -1);
      const int sy = j == 0 ? 2 * n + i : (j == n - 1 ? 3 * n + i : -1);
      const T* eb = sE + el * 4 * n;
      auto place = [&](int slot) {
        const T* e = eb + slot * slot_e;
        T acc = T(0);
        if (sx >= 0) acc += e[sx];
        if (sy >= 0) acc += e[sy];
        return acc;
      };
      const T mi = s.minv[nn];
      // row c: the SSPRK combine of rhs + placed edges + ref (+ lap)
      auto row = [&](int c, T lap) {
        const T rr = sN[(kRhs + c) * slot_n + P] + mi * place(kEdges + c)
                     + sN[(kRef + c) * slot_n + P] + lap;
        return a.a0 * sN[(kQb0 + c) * slot_n + P] + a.a1 * sN[(kQb1 + c) * slot_n + P]
               + a.a2 * sN[(kQb2 + c) * slot_n + P] + a.dtt * rr;
      };
      const T v0 = row(0, T(0));
      a.out[on + P] = v0 + sN[kPbdf * slot_n + P];   // pb = pb' + pbprime
      a.out[sn + on + P] = v0;
      T lap1 = T(0), lap2 = T(0);
      if (a.visc) {
        const T* X = s.qq + el * npts;   // channels 0-3: d/dx u, d/dy u, d/dx v, d/dy v
        T acc1 = T(0), acc2 = T(0);
#if BTP_ABLATE == 1
        acc1 = X[nn] + X[slot_n + nn];   // the Laplacian's contraction compiled out
        acc2 = X[2 * slot_n + nn] + X[3 * slot_n + nn];
#else
        const int nk = NGL > 0 ? NGL : n;
#pragma unroll
        for (int kk = 0; kk < nk; ++kk) {
          const T dx = s.dpsi[i * n + kk], dy = s.dpsi[j * n + kk];
          acc1 += X[j * n + kk] * dx;
          acc1 += X[slot_n + kk * n + i] * dy;
          acc2 += X[2 * slot_n + j * n + kk] * dx;
          acc2 += X[3 * slot_n + kk * n + i] * dy;
        }
#endif
        lap1 = a.nu * mi * (place(kVedges) - acc1);
        lap2 = a.nu * mi * (place(kVedges + 1) - acc2);
      }
      a.out[2 * sn + on + P] = row(1, lap1) * sN[kMask * slot_n + P];
      a.out[3 * sn + on + P] = row(2, lap2) * sN[(kMask + 1) * slot_n + P];
    }
  }
  cp_async_wait<0>();
}

template <typename T>
size_t smem_bytes(int ngl, int G) {
  Smem<T> s;
  return sizeof(T) * carve<T>(s, nullptr, ngl, G);
}

template <typename T>
int tile_elements(int ngl) {
  return pick_tile([&](int G) { return smem_bytes<T>(ngl, G); }, kMostElements,
                   kBlocksPerSM);
}

template <typename T, int NGL>
cudaError_t launch(Args<T>& a, cudaStream_t stream, LaunchPlan* describe) {
  a.G = tile_elements<T>(a.ngl);
  if (a.G < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(a.ngl, a.G);
  auto kernel = btp_update_kernel<T, NGL>;
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
cudaError_t run(int E, int ngl, int visc, const void* rhs, const void* edges,
                const void* qb0, const void* qb1, const void* qb2, const void* ref,
                const void* pbdf, const void* mask, const void* minv,
                const void* vedges, const void* gv, const void* pbpv, const void* bdg,
                const void* dpsi, const void* wn2, void* out, double a0, double a1,
                double a2, double dtt, double nu, cudaStream_t stream,
                LaunchPlan* describe) {
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
  a.G = 0;
  a.a0 = T(a0); a.a1 = T(a1); a.a2 = T(a2); a.dtt = T(dtt); a.nu = T(nu);
  // p = 4 (ngl = 5), the order the model is run at, has its own
  // instantiation; every other order takes the size at run time
  if (ngl == 5) return launch<T, 5>(a, stream, describe);
  return launch<T, 0>(a, stream, describe);
}

}  // namespace

extern "C" {

// The card's limit of shared memory for one block, in bytes.
long long btp_update_smem_limit() { return (long long)kSmemLimit; }

// Shared memory one block needs at least (a tile of one element), in bytes:
// the caller checks it against the limit before launching.
long long btp_update_smem_bytes(int is_double, int ngl) {
  return (long long)(is_double ? smem_bytes<double>(ngl, 1) : smem_bytes<float>(ngl, 1));
}

// How a launch at this size is laid out on the current device: elements per
// tile, shared memory per block (bytes), resident blocks per SM. Returns a
// cudaError_t.
int btp_update_describe(int is_double, int ngl, int* tile, long long* smem,
                        int* blocks_per_sm) {
  LaunchPlan plan;
  const cudaError_t err =
      is_double ? run<double>(1, ngl, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, nullptr, &plan)
                : run<float>(1, ngl, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, nullptr, &plan);
  if (err != cudaSuccess) return int(err);
  *tile = is_double ? tile_elements<double>(ngl) : tile_elements<float>(ngl);
  *smem = (long long)plan.smem;
  *blocks_per_sm = plan.blocks_per_sm;
  return 0;
}

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
                           dtt, nu, s, nullptr));
  return int(run<float>(E, ngl, visc, rhs, edges, qb0, qb1, qb2, ref, pbdf, mask, minv,
                        vedges, gv, pbpv, bdg, dpsi, wn2, out, a0, a1, a2, dtt, nu, s,
                        nullptr));
}

const char* btp_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
