// Whole-solve barotropic megakernel, CUDA C++ for sm_90a (NVIDIA Hopper).
//
// Replaces the TPU kernel hnumo_tpu/ops/pallas_mega.py::_mega_kernel (wrapper
// barotropic_solve_mega). ONE launch runs all nsub = N_btp*kstages SSPRK
// stages of one barotropic solve. Per stage and element it computes, in the
// order of the reference (src/mod_rk_mlswe.F90:19-151):
//   - the 3 nodal averages from the PRE-stage state,
//   - the volume RHS and the 12 quad averages (the function of btp_volume.cu,
//     with the uniform brick's metric constants folded into the weights),
//   - the edge traces of the element and of its four neighbours (wall mirror
//     on a domain boundary), interpolated to the face quad points,
//   - the linearized-Riemann face flux with Lax-Friedrichs dissipation and the
//     delta-form pressure at all four sides, the 16 face averages per side,
//     and the scatter of the integrated flux back to the edge nodes,
//   - with viscosity: the nodal gradient of (u, v), its average, its traces on
//     both sides of each face, the 8 trace averages, the flip-flop LDG flux
//     and the volume Laplacian in the nodal quadrature,
//   - massinv * (rhs + static reference vector), the 3-register SSPRK
//     combine, pb = pb' + pbprime, the wall projection masks, and the
//     SSP(5,3) snapshot of the stage-2 state.
//
// Design. Stage s+1 of an element needs the stage-s state of its four
// neighbours, so this is one persistent cooperative kernel (all blocks
// resident), with the stages of neighbouring elements ordered by flags
// (resident route) or by one grid barrier per stage (streamed route).
// Neighbour values are recomputed, not exchanged: a block loads its
// neighbours' state and evaluates their edge values and gradients with the
// same arithmetic the owner uses, so both elements of an interior face get
// the same left/right values. Each element computes its own four sides: every
// output location has one writer, there are no atomics on data. The
// tensor-product operators are applied sum-factorised from the 1-D tables.
//
// What bounds it on this card: neither bytes nor flops (about 33 kflop per
// element and stage at p=4, 0.05 ms for a 32x32 solve at the f32 peak) but
// the latency of nsub dependent stages, each a chain of block-wide phases and
// a synchronisation with the neighbours. The kernel before this design
// re-read every per-element table and did every running-average update
// through global memory in every stage (30-40 dependent L2 round trips a
// stage: the channel strides are run-time values, so no update could start
// before the previous store), spilled at 64 registers, and took 19
// microseconds a stage at 32x32, 2.4 of them in the grid barrier.
//
// What this design does about it. Two routes, one compute path:
//   - RESIDENT (one block per element fits the card at once; 32x32 and below
//     at f32 p=4). Everything an element touches lives in its block's shared
//     memory for all nsub stages: the per-element tables (read from global
//     memory once), the five running averages (read once, each value added to
//     by one fixed thread in every stage, in stage order, stored once at the
//     end) and the element's own three SSPRK registers. Only the stage output
//     goes to global memory, because the neighbours read it: two exchange
//     buffers suffice, since a block keeps its own registers. They hold each
//     channel padded to 16 bytes, so a block copies its neighbours' state with
//     16-byte cp.async (around the L1) at the top of a stage, in flight
//     during phase A. A stage waits only for its four neighbours' "done"
//     counters (a release/acquire pair of fences), not for the grid: 100 grid
//     barriers take 0.23 ms alone, and a 32x32 solve with them in place of
//     the counters (BTP_ABLATE=4) 0.97 ms against 0.80.
//   - STREAMED (more elements than resident blocks: mega="on" above 1024
//     elements, f64 above 528): blocks walk the elements grid-stride and a
//     grid barrier ends each stage; per element and stage the tables are
//     copied into the same shared-memory slots with cp.async (all in flight
//     at once), the element's registers come from four rotating global
//     buffers whose roles follow from the stage index alone, and the running
//     averages stay in global memory, updated four channels at a time (four
//     loads in flight, then four stores).
// Both routes run the same five block-wide phases per stage (four block
// barriers), items spread over a block's threads without branches on their
// side or channel (a warp's items lie on different ones). The layout is one
// array per block: operators, tables, accumulators, own registers, then the
// stage's scratch, aliased by liveness (see `layout`).
// At f32 p=4 it is 27,624 bytes, so 8 blocks share an SM (1,056 resident
// blocks on 132 SMs). Threads per block (kThreads): 128 on the resident
// route, whose register bound for 8 blocks is then 64, enough once the
// index arithmetic is kept out of the stage loop (thread_index); 64 on the
// streamed one (128 registers). A spill costs more here than usual: with
// shared memory taking all but ~29 KB of an SM, spill reloads miss the L1.
//
// BTP_ABLATE builds a variant that is only timed (chip_smoke.py,
// hnumo_tpu_torch/tools/kernel_ablation.py): 1 compiles the contractions out
// (memory-only time), 2 makes no global read after the first (the neighbours'
// state is not loaded, and computed on with what shared memory holds, so a
// division may take its slow path; compute-only time), 3 leaves the nsub
// stages empty but for their grid barriers (the floor of any design with one
// grid barrier per stage). All three compute wrong numbers on purpose. 4
// orders the resident route's stages by one grid barrier each instead of the
// neighbours' counters (right numbers; the design the counters replace). The
// package's wrappers never build them.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// takes three arrays (pointers, ints, doubles) indexed by the enums below and
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "btp_volume_common.cuh"

namespace cg = cooperative_groups;

// Order of the launcher's argument arrays; ops/mega.py fills them in this order.
enum PtrIdx {
  P_QB_IN, P_WS, P_QB_OUT, P_QPLQ, P_COUP, P_QE, P_BGF, P_PVISC, P_BDG,
  P_PTAB, P_REF3, P_MASSINV, P_PBP, P_OPBP, P_MASKU, P_MASKV, P_FTAB, P_NTAB,
  P_NBR, P_MIRQ, P_MIRG, P_PSIQ, P_DPSIQ, P_DPSI, P_WQ3, P_WN2,
  P_ACCV, P_ACCN, P_AGR, P_AFF, P_AGT, P_COUNT
};
enum IntIdx {
  I_IS_DOUBLE, I_E, I_NGL, I_NQ, I_NSUB, I_KSTAGES, I_BOTFR, I_USE_VISC, I_COUNT
};
constexpr int kMaxStages = 5;
enum RealIdx {
  R_DT, R_GRAV, R_CD, R_ALPHA_BOT, R_VISC, R_KX_DF, R_EY_DF,
  R_A,                              // kMaxStages x 3
  R_B = R_A + 3 * kMaxStages,       // kMaxStages
  R_COUNT = R_B + kMaxStages
};

namespace {

using btpvol::cp_async_16;
using btpvol::cp_async_commit;
using btpvol::cp_async_value;
using btpvol::cp_async_wait;
using btpvol::kSmemLimit;
using btpvol::LaunchPlan;
using btpvol::plan_launch;
using btpvol::slot_values;
using btpvol::t_sqrt;

constexpr int kStreamed = 0, kResident = 1;
// Threads of a block (a power of two, rot), per route: 128 on the resident
// route (62 registers at f<5,9>); 64 on the streamed one, whose element loads
// and accumulator updates in global memory take 96 registers (at 128 threads
// its 64-register bound spilled 92 B).
template <int ROUTE> constexpr int kThreads = ROUTE == kResident ? 128 : 64;
constexpr int kMaxNgl = 8;         // nop <= 7, the megakernel's envelope

// Blocks per SM the register bound is set for: 8 in f32 (the layout at p=4
// lets 8 share an SM: 64 registers a thread on the resident route, 128 on the
// streamed one), 4 in f64 (its layout lets 4).
template <typename T> constexpr int kMinBlocks = sizeof(T) == 4 ? 8 : 4;

template <typename T>
struct Args {
  const T* qb_in;   // (4, E, npts)  state at t, read only
  T* ws;            // (4, 4, E, npts), zeroed: streamed route, four rotating
                    // state buffers; resident route, two exchange buffers
                    // and the "done" counters
  T* qb_out;        // (4, E, npts)  state at t+dt
  const T* qplq;    // (3, E, nqq)   bottom-layer primes at quad points
  const T* coup;    // (4, E, nqq)   Quu, Quv, Qvv, dH_bcl
  const T* qe;      // (4, E, 4, nq) their edge values per side
  const T* bgf;     // (10, E, 4, ngl) viscosity face weights L(5), R(5)
  const T* pvisc;   // (E, npts)
  const T* bdg;     // (4, E, npts)
  const T* ptab;    // (8, E, nqq)   cor, tau_u, tau_v, gzx, gzy, 1/pbprime,
                    //               dpp_ref_q[-1], H_bcl_ref
  const T* ref3;    // (3, E, npts)
  const T* massinv; // (E, npts)
  const T* pbp;     // (E, npts)     pbprime_df
  const T* opbp;    // (E, npts)     1/pbprime_df
  const T* masku;   // (E, npts)
  const T* maskv;   // (E, npts)
  const T* ftab;    // (13, E, 4, nq)
  const T* ntab;    // (3, E, 4, ngl)
  const int* nbr;   // (E, 4) neighbour per side (east, west, north, south), -1 = wall
  const T* mirq;    // (4 sides, 4 channels)
  const T* mirg;    // (4 sides, 4 channels)
  const T* psiq;    // (ngl, nq)
  const T* dpsiq;   // (ngl, nq)
  const T* dpsi;    // (ngl, ngl)
  const T* wq3;     // (3, nqq): w*ksi_x, w*eta_y, w
  const T* wn2;     // (2, npts): w_df*ksi_x, w_df*eta_y
  T* accv;          // (12, E, nqq)
  T* accn;          // (3, E, npts)
  T* agr;           // (4, E, npts)
  T* aff;           // (16, E, 4, nq)
  T* agt;           // (8, E, 4, ngl)
  int E, ngl, nq, nsub, kstages, botfr, use_visc;
  T dt, grav, cd, alpha_bot, visc, kx_df, ey_df;
  T a[kMaxStages][3];
  T b[kMaxStages];
};

// Rows of the per-element tables in shared memory, channel-major: row r of a
// table with `len` values per row starts at r * len.
enum QuadRow { Q_COR, Q_TAU_U, Q_TAU_V, Q_GZX, Q_GZY, Q_OPBP, Q_PPREF, Q_HREF,
               Q_PPQ, Q_UP, Q_VP, Q_QUU, Q_QUV, Q_QVV, Q_DHBCL, Q_ROWS };     // x nqq
enum SideQuadRow { F_FTAB = 0, F_QE = 13, F_ROWS = 17 };                      // x 4 nq
enum SideNodeRow { N_NTAB = 0, N_BGF = 3, N_ROWS = 13 };                      // x 4 ngl
enum NodeRow { D_REF3 = 0, D_MASSINV = 3, D_PBP, D_OPBP, D_MASKU, D_MASKV, D_PVISC,
               D_BDG, D_ROWS = D_BDG + 4 };                                   // x npts

// One block's shared memory: offsets in values of T from the start of one
// array, then the element's four neighbour indices (ints). The stage's
// scratch is aliased by liveness (phases A-E of element_stage; a buffer
// written in phase X and last read in phase Y is live in [X, Y]):
//   slab 1: nb, uv, tmp [A, B]     then t1, t2, sq, qq [C, D] and sv [C, E]
//   slab 2: f, lq, rq, nbuv, g [B, C]   then rhs, se, lap [D, E]
// No two buffers of one slab are live in one phase, and every phase boundary
// is a block barrier, so each slab's last reader is behind a barrier before
// its next writer starts (phase E of one stage and phase A of the next too:
// the block barrier before the "done" release, or the grid barrier).
struct Lay {
  int psiq, dpsiq, dpsi, wq3, wn2, mirq, mirg;   // operators
  int tq, tf, tn, td;                            // per-element tables
  int accv, aff, agt, accn, agr;                 // running averages
  int q1, q0, q2;                                // own SSPRK registers
  int nb, uv, tmp, t1, t2, sq, qq, sv;           // slab 1
  int f, lq, rq, nbuv, g, rhs, se, lap;          // slab 2
  int total;                                     // values of T
};

__host__ __device__ constexpr int max2(int x, int y) { return x > y ? x : y; }

// Values of one channel of an element in the resident route's exchange
// buffers and in `nb`: npts rounded up to 16 bytes, so that a block copies
// its neighbours' state 16 bytes at a time.
template <typename T>
__host__ __device__ constexpr int padded(int npts) { return slot_values<T>(npts); }

template <typename T>
__host__ __device__ constexpr Lay layout(int n, int m) {
  const int npts = n * n, nqq = m * m, pn = padded<T>(npts);
  Lay L{};
  int o = 0;
  L.psiq = o;  o += n * m;
  L.dpsiq = o; o += n * m;
  L.dpsi = o;  o += n * n;
  L.wq3 = o;   o += 3 * nqq;
  L.wn2 = o;   o += 2 * npts;
  L.mirq = o;  o += 16;
  L.mirg = o;  o += 16;
  L.tq = o;    o += Q_ROWS * nqq;
  L.tf = o;    o += F_ROWS * 4 * m;
  L.tn = o;    o += N_ROWS * 4 * n;
  L.td = o;    o += D_ROWS * npts;
  L.accv = o;  o += 12 * nqq;
  L.aff = o;   o += 16 * 4 * m;
  L.agt = o;   o += 8 * 4 * n;
  L.accn = o;  o += 3 * npts;
  L.agr = o;   o += 4 * npts;
  L.q1 = o;    o += 4 * npts;
  L.q0 = o;    o += 3 * npts;
  L.q2 = o;    o += 3 * npts;
  // slab 1, 16-byte aligned for nb
  const int s1 = padded<T>(o);
  L.nb = s1;                       // (4 sides, 4, padded npts)
  L.uv = L.nb + 16 * pn;           // (2, npts)
  L.tmp = L.uv + 2 * npts;         // (4, ngl, nq)
  const int end1a = L.tmp + 4 * n * m;
  L.t1 = s1;                       // (3, nq, ngl)
  L.t2 = L.t1 + 3 * m * n;         // (3, nq, ngl)
  L.sq = L.t2 + 3 * m * n;         // (3, 4 sides, nq)
  L.qq = L.sq + 12 * m;            // (4, npts)
  L.sv = L.qq + 4 * npts;          // (2, 4 sides, ngl)
  const int end1b = L.sv + 8 * n;
  // slab 2
  const int s2 = max2(end1a, end1b);
  L.f = s2;                        // (8, nqq)
  L.lq = L.f + 8 * nqq;            // (4, 4 sides, nq)
  L.rq = L.lq + 16 * m;            // (4, 4 sides, nq)
  L.nbuv = L.rq + 16 * m;          // (4 sides, 2, npts)
  L.g = L.nbuv + 8 * npts;         // (4, npts)
  const int end2a = L.g + 4 * npts;
  L.rhs = s2;                      // (3, npts)
  L.se = L.rhs + 3 * npts;         // (3, 4 sides, ngl)
  L.lap = L.se + 12 * n;           // (2, npts)
  const int end2b = L.lap + 2 * npts;
  L.total = max2(end2a, end2b);
  return L;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int n, int m) {
  return sizeof(T) * size_t(layout<T>(n, m).total) + 4 * sizeof(int);
}

// Node k of side s (east, west, north, south) of an n x n element, nodes
// numbered j*n + i, is edge_base(s, n) + k * edge_step(s, n): selects, not
// branches, since the items of one warp lie on different sides.
__device__ __forceinline__ int edge_base(int s, int n) {
  return s == 0 ? n - 1 : (s == 2 ? (n - 1) * n : 0);
}
__device__ __forceinline__ int edge_step(int s, int n) { return s < 2 ? n : 1; }

// Component c of grad(u, v) = (du/dx, du/dy, dv/dx, dv/dy) at node (j, i) of
// the element whose nodal (u, v) are uv[0..npts), uv[npts..2 npts). Owner and
// neighbour evaluate a trace with this one function: same values, same order.
// d/dx runs along row j, d/dy along column i; both are one loop with the
// strides selected, not two branches (a warp's items hold both kinds).
template <typename T>
__device__ __forceinline__ T grad_uv(const T* uv, const T* dpsi, int n, int c,
                                     int j, int i, T kx, T ey) {
  const bool dy = (c & 1) != 0;
  const T* f = uv + (c >> 1) * n * n + (dy ? i : j * n);
  const int fs = dy ? n : 1;
  const T* d = dpsi + (dy ? j : i);
  T a = T(0);
#if BTP_ABLATE == 1
  a = f[(dy ? j : i) * fs];
#else
  for (int k = 0; k < n; ++k) a += f[k * fs] * d[k * n];
#endif
  return (dy ? ey : kx) * a;
}

// Sum over the sides node (j, i) lies on of the per-side edge values
// e[(side * n) + k] (corner nodes lie on two sides).
template <typename T>
__device__ __forceinline__ T edge_sum(const T* e, int n, int j, int i) {
  T a = T(0);
  if (i == n - 1) a += e[0 * n + j];
  if (i == 0) a += e[1 * n + j];
  if (j == n - 1) a += e[2 * n + i];
  if (j == 0) a += e[3 * n + i];
  return a;
}

// Thread id rotated by `off`: loops of one phase that start at different
// offsets hand their items to different warps instead of all to the first.
// The offsets are constants, so every item (and every accumulator value) has
// the same thread in every stage.
__device__ __forceinline__ int thread_index();
template <int NT>
__device__ __forceinline__ int rot(int off) {
  return (thread_index() - off) & (NT - 1);
}

// threadIdx.x, read anew at each use: index arithmetic that depends on it is
// then not hoisted out of the stage (and element) loop, where it held some
// 30 more registers for all nsub stages and spilled (resident route at
// f<5,9>: 204 B at 64 registers, and the solve took 1.12 ms against 0.80).
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// acc[c * stride] += inc[c] for c < 4: the four loads first, then the four
// stores, so that four read-modify-writes are in flight at once wherever the
// accumulators live. The compute-only build of the streamed route stores
// without reading.
template <int ROUTE, typename T>
__device__ __forceinline__ void add4(T* acc, long long stride, T i0, T i1, T i2, T i3) {
#if BTP_ABLATE == 2
  if (ROUTE == kStreamed) {
    acc[0] = i0; acc[stride] = i1; acc[2 * stride] = i2; acc[3 * stride] = i3;
    return;
  }
#endif
  const T o0 = acc[0], o1 = acc[stride], o2 = acc[2 * stride], o3 = acc[3 * stride];
  acc[0] = o0 + i0;
  acc[stride] = o1 + i1;
  acc[2 * stride] = o2 + i2;
  acc[3 * stride] = o3 + i3;
}

// dst[c * count + i] = src[c * stride + i] for c < nchan, i < count, loads
// four to a thread in flight before their stores. `CG`: read around the L1
// (data another block may have written since this SM last read it).
template <int NT, bool CG, typename T>
__device__ void gather(T* dst, const T* src, long long stride, int count, int nchan) {
  constexpr int kBatch = 4;
  const int total = nchan * count;
  for (int t0 = thread_index(); t0 < total; t0 += kBatch * NT) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * NT;
      if (t < total) {
        const int c = t / count;
        const T* p = src + c * stride + (t - c * count);
        v[u] = CG ? __ldcg(p) : *p;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * NT;
      if (t < total) dst[t] = v[u];
    }
  }
}

// src -> dst for data no kernel writes: value by value with cp.async, all in
// flight; the caller commits and waits.
template <int NT, typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, long long stride, int count,
                                           int nchan) {
  const int total = nchan * count;
  for (int t = thread_index(); t < total; t += NT) {
    const int c = t / count;
    cp_async_value<int(sizeof(T))>(dst + t, src + c * stride + (t - c * count));
  }
}

// The per-element tables of element e into their shared-memory rows (streamed
// route: by cp.async, committed, not waited for; resident route: loaded).
template <int NT, bool ASYNC, typename T>
__device__ void load_tables(const Args<T>& a, T* S, const Lay& L, long long e, int n, int m) {
  const int npts = n * n, nqq = m * m;
  const long long E = a.E;
  auto put = [&](int row0, int len, const T* src, int nchan) {
    if (ASYNC) copy_async<NT>(S + row0, src + e * len, E * len, len, nchan);
    else gather<NT, false>(S + row0, src + e * len, E * len, len, nchan);
  };
  put(L.tq + Q_COR * nqq, nqq, a.ptab, 8);
  put(L.tq + Q_PPQ * nqq, nqq, a.qplq, 3);
  put(L.tq + Q_QUU * nqq, nqq, a.coup, 4);
  put(L.tf + F_FTAB * 4 * m, 4 * m, a.ftab, 13);
  put(L.tf + F_QE * 4 * m, 4 * m, a.qe, 4);
  put(L.td + D_REF3 * npts, npts, a.ref3, 3);
  put(L.td + D_MASSINV * npts, npts, a.massinv, 1);
  put(L.td + D_PBP * npts, npts, a.pbp, 1);
  put(L.td + D_OPBP * npts, npts, a.opbp, 1);
  put(L.td + D_MASKU * npts, npts, a.masku, 1);
  put(L.td + D_MASKV * npts, npts, a.maskv, 1);
  if (a.use_visc) {
    put(L.tn + N_NTAB * 4 * n, 4 * n, a.ntab, 3);
    put(L.tn + N_BGF * 4 * n, 4 * n, a.bgf, 10);
    put(L.td + D_PVISC * npts, npts, a.pvisc, 1);
    put(L.td + D_BDG * npts, npts, a.bdg, 4);
  }
  if (ASYNC) cp_async_commit();
}

// Where the five running averages of one element live: in shared memory
// (resident route) or in the global arrays (streamed route). Channel c of
// item i is at ptr[c * stride + i].
template <typename T>
struct Acc {
  T *v, *f, *g, *n, *r;         // accv, aff, agt, accn, agr
  long long sv, sf, sg, sn;     // channel strides: quad, side-quad, side-nodal, nodal
};

template <int ROUTE, typename T>
__device__ __forceinline__ Acc<T> acc_views(const Args<T>& a, T* S, const Lay& L, long long e,
                                            int n, int m) {
  const int npts = n * n, nqq = m * m;
  if (ROUTE == kResident)
    return {S + L.accv, S + L.aff, S + L.agt, S + L.accn, S + L.agr, nqq, 4 * m, 4 * n, npts};
  const long long E = a.E;
  return {a.accv + e * nqq, a.aff + e * 4 * m, a.agt + e * 4 * n, a.accn + e * npts,
          a.agr + e * npts, E * nqq, E * 4 * m, E * 4 * n, E * npts};
}

// Where a stage's output goes: channel c of node nn at p[c * cstride + nn].
template <typename T>
struct Out {
  T* p;
  long long cstride;
};

// One stage of element e. Its tables and own registers q1 (4 channels), q0
// and q2 (rows 1..3) are in shared memory, and its neighbours' pre-stage
// state is on its way into `nb` (cp.async, resident route; waited for at
// the end of phase A) or there already (streamed route). The stage output
// goes to `dst` (global) and, on the resident route, to q1 (and to q2 at the
// SSP(5,3) snapshot). NGL, NQ > 0 fix the 1-D sizes at compile time (index
// arithmetic by constants, inner loops unrolled); 0 takes them from the
// arguments.
template <typename T, int NGL, int NQ, int ROUTE>
__device__ __forceinline__ void element_stage(const Args<T>& a, T* S, const int* nbe,
                                              long long e, int ik, Out<T> dst) {
  constexpr int NT = kThreads<ROUTE>;
  const int tid = thread_index();
  const int n = NGL > 0 ? NGL : a.ngl, m = NQ > 0 ? NQ : a.nq;
  const int npts = n * n, nqq = m * m, pn = padded<T>(npts);
  const Lay L = layout<T>(n, m);
  const bool visc = a.use_visc != 0;
  const T* psiq = S + L.psiq;
  const T* dpsiq = S + L.dpsiq;
  const T* dpsi = S + L.dpsi;
  const T* q1 = S + L.q1;
  const Acc<T> acc = acc_views<ROUTE>(a, S, L, e, n, m);

  // ---- phase A: nodal averages, u and v, interpolation pass 1 (the
  //      neighbours' state arrives meanwhile) ---------------------------------
  if (ROUTE == kResident && ik == 0) {
    // register 0 of this sub-step is the pre-stage state
    for (int t = rot<NT>(13); t < 3 * npts; t += NT) S[L.q0 + t] = q1[npts + t];
  }
  for (int nn = rot<NT>(52); nn < npts; nn += NT) {
    // nodal averages from the PRE-stage state
    const T inv_pb = T(1) / q1[nn];
    const T t_df = q1[npts + nn] * S[L.td + D_OPBP * npts + nn];
    const T u = q1[2 * npts + nn] * inv_pb;
    const T v = q1[3 * npts + nn] * inv_pb;
    T* an = acc.n + nn;
    const T o0 = an[0], o1 = an[acc.sn], o2 = an[2 * acc.sn];
    an[0] = o0 + t_df * (T(2) + t_df);
    an[acc.sn] = o1 + u;
    an[2 * acc.sn] = o2 + v;
    S[L.uv + nn] = u;
    S[L.uv + npts + nn] = v;
  }
  for (int t = tid; t < 4 * n * m; t += NT) {
    // tmp[c][j][I] = sum_i q[c][j][i] psiq[i][I]
    const int c = t / (n * m), r = t - c * n * m;
    const int j = r / m, I = r - j * m;
    const T* row = q1 + c * npts + j * n;
    T s = T(0);
#if BTP_ABLATE == 1
    s = row[I % n];
#else
    for (int i = 0; i < n; ++i) s += row[i] * psiq[i * m + I];
#endif
    S[L.tmp + t] = s;
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- phase B: quad-point physics, face traces at the quad points, the
  //      neighbours' u and v, grad(u, v) ----------------------------------------
  for (int q = tid; q < nqq; q += NT) {
    const int J = q / m, I = q - J * m;
    const T* tmp = S + L.tmp;
    T dp = T(0), dpp = T(0), udp = T(0), vdp = T(0);
#if BTP_ABLATE == 1
    dp = tmp[(0 * n + J % n) * m + I];
    dpp = tmp[(1 * n + J % n) * m + I];
    udp = tmp[(2 * n + J % n) * m + I];
    vdp = tmp[(3 * n + J % n) * m + I];
#else
    for (int j = 0; j < n; ++j) {
      const T p = psiq[j * m + J];
      dp += tmp[(0 * n + j) * m + I] * p;
      dpp += tmp[(1 * n + j) * m + I] * p;
      udp += tmp[(2 * n + j) * m + I] * p;
      vdp += tmp[(3 * n + j) * m + I] * p;
    }
#endif
    const T* tq = S + L.tq + q;
    const T ppq = tq[Q_PPQ * nqq], up = tq[Q_UP * nqq], vp = tq[Q_VP * nqq];
    const T cor = tq[Q_COR * nqq];
    const T tau_u = tq[Q_TAU_U * nqq], tau_v = tq[Q_TAU_V * nqq];
    const T gzx = tq[Q_GZX * nqq], gzy = tq[Q_GZY * nqq];
    const T opbp = tq[Q_OPBP * nqq];
    const T pp = tq[Q_PPREF * nqq] + ppq;   // full bottom-layer dp'
    const T Href = tq[Q_HREF * nqq];

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

    const T Quu = tq[Q_QUU * nqq], Quv = tq[Q_QUV * nqq];
    const T Qvv = tq[Q_QVV * nqq], dHbcl = tq[Q_DHBCL * nqq];
    const T mu = dpp * opbp;
    const T mu2 = mu * (T(2) + mu);
    const T ope = T(1) + mu;
    const T dHq = dHbcl + mu2 * (Href + dHbcl);
    const T qu = ub * udp + ope * Quu;
    const T quv = ub * vdp + ope * Quv;
    const T qv = vb * vdp + ope * Qvv;

    // 12 running averages, order of core/btp._VOL_ORDER
    T* av = acc.v + q;
    add4<ROUTE>(av, acc.sv, dHq, qu, qv, quv);
    add4<ROUTE>(av + 4 * acc.sv, acc.sv, mu, mu2, ub, vb);
    add4<ROUTE>(av + 8 * acc.sv, acc.sv, udp, vdp, tb_u, tb_v);

    // weighted flux rows: (x, y) of the 3 channels, then the 2 sources
    const T* wq3 = S + L.wq3;
    const T wkx = wq3[q], wey = wq3[nqq + q], w = wq3[2 * nqq + q];
    T* f = S + L.f;
    f[0 * nqq + q] = wkx * udp;
    f[1 * nqq + q] = wey * vdp;
    f[2 * nqq + q] = wkx * (dHq + qu);
    f[3 * nqq + q] = wey * quv;
    f[4 * nqq + q] = wkx * quv;
    f[5 * nqq + q] = wey * (dHq + qv);
    f[6 * nqq + q] = w * sc_x;
    f[7 * nqq + q] = w * sc_y;
  }
  for (int t = rot<NT>(17); t < 16 * m; t += NT) {
    // (channel, side, face quad point): left/right nodal traces of qb at the
    // side, interpolated. The element is the left side of its east/north
    // faces and of a boundary face (the wall mirror on the right), else the
    // right side: left = own or the neighbour's facing edge, right = the
    // other one, or the mirror times own at a wall.
    const int cs = t / m, qq = t - cs * m;
    const int c = cs >> 2, sd = cs & 3;
    const bool wall = nbe[sd] < 0, second = (sd & 1) != 0 && !wall;
    const T* own = q1 + c * npts + edge_base(sd, n);
    const T* other = S + L.nb + sd * 4 * pn + c * pn + edge_base(sd ^ 1, n);
    const int step = edge_step(sd, n);     // the same along both sides of a face
    const T* lp = second ? other : own;
    const T* rp = wall || second ? own : other;
    const T rs = wall ? S[L.mirq + sd * 4 + c] : T(1);
    T al = T(0), ar = T(0);
#if BTP_ABLATE == 1
    for (int k = qq % n; k <= qq % n; ++k) {
#else
    for (int k = 0; k < n; ++k) {
#endif
      const T p = psiq[k * m + qq];
      al += lp[k * step] * p;
      ar += (rs * rp[k * step]) * p;
    }
    S[L.lq + t] = al;
    S[L.rq + t] = ar;
  }
  if (visc) {
    for (int t = rot<NT>(33); t < 4 * npts; t += NT) {
      const int sd = t / npts, nn = t - sd * npts;
      if (nbe[sd] >= 0) {
        const T* qn = S + L.nb + sd * 4 * pn;
        const T inv_pb = T(1) / qn[nn];
        S[L.nbuv + sd * 2 * npts + nn] = qn[2 * pn + nn] * inv_pb;
        S[L.nbuv + sd * 2 * npts + npts + nn] = qn[3 * pn + nn] * inv_pb;
      }
    }
    for (int t = rot<NT>(5); t < 4 * npts; t += NT) {
      const int c = t / npts, nn = t - c * npts;
      const int j = nn / n, i = nn - j * n;
      const T gv = grad_uv(S + L.uv, dpsi, n, c, j, i, a.kx_df, a.ey_df);
      S[L.g + t] = gv;
      acc.r[c * acc.sn + nn] += gv;
    }
  }
  __syncthreads();

  // ---- phase C: scatter pass 1, face flux, viscous traces and fluxes -------
  for (int t = rot<NT>(56); t < 3 * m * n; t += NT) {
    // t1[c][J][i] = sum_I Fx[c][J][I] dpsiq[i][I] (+ Fs[c][J][I] psiq[i][I])
    // t2[c][J][i] = sum_I Fy[c][J][I] psiq[i][I]
    const int c = t / (m * n), r = t - c * m * n;
    const int J = r / n, i = r - J * n;
    const T* fx = S + L.f + (2 * c) * nqq + J * m;
    const T* fy = fx + nqq;
    T a1 = T(0), a2 = T(0);
#if BTP_ABLATE == 1
    a1 = fx[i];
    a2 = fy[i];
    if (c > 0) a1 += S[L.f + (5 + c) * nqq + J * m + i];
#else
    for (int I = 0; I < m; ++I) {
      a1 += fx[I] * dpsiq[i * m + I];
      a2 += fy[I] * psiq[i * m + I];
    }
    if (c > 0) {
      const T* fs = S + L.f + (5 + c) * nqq + J * m;
      T a3 = T(0);
      for (int I = 0; I < m; ++I) a3 += fs[I] * psiq[i * m + I];
      a1 += a3;
    }
#endif
    S[L.t1 + t] = a1;
    S[L.t2 + t] = a2;
  }
  for (int t = tid; t < 4 * m; t += NT) {
    // face flux at (side, quad point): reference creat_btp_fluxes_qdf
    const T* ft = S + L.tf + t;
    const int sf = 4 * m;
    const T nx = ft[0 * sf], ny = ft[1 * sf], jacf = ft[2 * sf];
    const T cpL = ft[3 * sf], cpR = ft[4 * sf];
    const T cpub = ft[5 * sf];
    const T cmL = ft[6 * sf], cmR = ft[7 * sf];
    const T cmLR = ft[8 * sf];
    const T opbe = ft[9 * sf], Hedge = ft[10 * sf];
    const T pbl = ft[11 * sf], pbr = ft[12 * sf];
    const T* lq = S + L.lq + t;
    const T* rq = S + L.rq + t;
    const T l0 = lq[0], l1 = lq[4 * m], l2 = lq[8 * m], l3 = lq[12 * m];
    const T r0 = rq[0], r1 = rq[4 * m], r2 = rq[8 * m], r3 = rq[12 * m];

    const T pU_L = nx * l2 + ny * l3;
    const T pU_R = -(nx * r2 + ny * r3);
    const T mue = (cpL * l1 + cpR * r1 + cpub * (pU_L + pU_R)) * opbe;
    const T mue2 = mue * (T(2) + mue);
    const T ope_e = T(1) + mue;
    const T flux_ex = cmL * l2 + cmR * r2 + cmLR * nx * (l1 - r1);
    const T flux_ey = cmL * l3 + cmR * r3 + cmLR * ny * (l1 - r1);
    const T ul = l2 / l0, ur = r2 / r0;
    const T vl = l3 / l0, vr = r3 / r0;
    const T Qe_uu = ft[(F_QE + 0) * sf], Qe_uv = ft[(F_QE + 1) * sf];
    const T Qe_vv = ft[(F_QE + 2) * sf], dHe = ft[(F_QE + 3) * sf];
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
    T* af = acc.f + t;
    add4<ROUTE>(af, acc.sf, dH_f, quu, quv, qvu);
    add4<ROUTE>(af + 4 * acc.sf, acc.sf, qvv, muL, muR, muL * (T(2) + muL));
    add4<ROUTE>(af + 8 * acc.sf, acc.sf, muR * (T(2) + muR), flux_ex, flux_ey, mue2);
    add4<ROUTE>(af + 12 * acc.sf, acc.sf, ul, ur, vl, vr);
    S[L.sq + t] = jacf * fl_m;
    S[L.sq + 4 * m + t] = jacf * (nx * dH_f + fl_x);
    S[L.sq + 8 * m + t] = jacf * (ny * dH_f + fl_y);
  }
  if (visc) {
    for (int t = rot<NT>(36); t < 4 * n; t += NT) {
      // flip-flop LDG flux at (side, edge node): reference
      // create_rhs_laplacian_flux (src/mod_laplacian_quad.F90:427-519)
      const int sd = t / n, k = t - sd * n;
      const T* tn = S + L.tn + t;
      const int sg = 4 * n;
      const int own_node = edge_base(sd, n) + k * edge_step(sd, n);
      const int nb_node = edge_base(sd ^ 1, n) + k * edge_step(sd, n);
      const T* g = S + L.g;
      const T bmulL = tn[(N_BGF + 4) * sg], bmulR = tn[(N_BGF + 9) * sg];
      T lft[4], rgt[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T own = g[c * npts + own_node];
        T left = own, right;
        if (nbe[sd] < 0) {
          right = S[L.mirg + sd * 4 + c] * own;
        } else {
          const T other = grad_uv(S + L.nbuv + sd * 2 * npts, dpsi, n, c,
                                  nb_node / n, nb_node % n, a.kx_df, a.ey_df);
          if ((sd & 1) == 0) { right = other; } else { left = other; right = own; }
        }
        lft[c] = left;
        rgt[c] = right;
      }
      T* ag = acc.g + t;
      add4<ROUTE>(ag, acc.sg, lft[0], lft[1], lft[2], lft[3]);
      add4<ROUTE>(ag + 4 * acc.sg, acc.sg, rgt[0], rgt[1], rgt[2], rgt[3]);
      T fl[4], fr[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        fl[c] = bmulL * lft[c] + tn[(N_BGF + c) * sg];
        fr[c] = bmulR * rgt[c] + tn[(N_BGF + 5 + c) * sg];
      }
      const T nxdf = tn[(N_NTAB + 0) * sg], nydf = tn[(N_NTAB + 1) * sg];
      const T jacdf = tn[(N_NTAB + 2) * sg];
      const T flux_qu = (T(0.5) * (fl[0] + fr[0]) - fl[0] * nxdf)
                        + (T(0.5) * (fl[1] + fr[1]) - fl[1] * nydf);
      const T flux_qv = (T(0.5) * (fl[2] + fr[2]) - fl[2] * nxdf)
                        + (T(0.5) * (fl[3] + fr[3]) - fl[3] * nydf);
      // the Laplacian receives MINUS the flux with the face scatter's sign
      const T sign = (nbe[sd] < 0 || (sd & 1) == 0) ? T(1) : T(-1);
      S[L.sv + t] = sign * (jacdf * flux_qu);
      S[L.sv + 4 * n + t] = sign * (jacdf * flux_qv);
    }
    for (int t = rot<NT>(63); t < 4 * npts; t += NT) {
      // qq = pbprime_visc * graduv + btp_dpp_graduv, weighted for the nodal
      // quadrature: x-derivative channels (0, 2) by w*ksi_x, (1, 3) by w*eta_y
      const int c = t / npts, nn = t - c * npts;
      S[L.qq + t] = S[L.wn2 + (c & 1) * npts + nn]
                    * (S[L.td + D_PVISC * npts + nn] * S[L.g + t]
                       + S[L.td + (D_BDG + c) * npts + nn]);
    }
  }
  __syncthreads();

  // ---- phase D: scatter pass 2, face scatter, volume Laplacian -------------
  for (int t = tid; t < 3 * npts; t += NT) {
    // rhs[c][j][i] = sum_J t1[c][J][i] psiq[j][J] + t2[c][J][i] dpsiq[j][J]
    const int c = t / npts, nn = t - c * npts;
    const int j = nn / n, i = nn - j * n;
    const T* t1 = S + L.t1 + c * m * n + i;
    const T* t2 = S + L.t2 + c * m * n + i;
    T s = T(0);
#if BTP_ABLATE == 1
    s = t1[j * n] + t2[j * n];
#else
    for (int J = 0; J < m; ++J) {
      s += t1[J * n] * psiq[j * m + J];
      s += t2[J * n] * dpsiq[j * m + J];
    }
#endif
    S[L.rhs + t] = s;
  }
  for (int t = rot<NT>(11); t < 12 * n; t += NT) {
    // (channel, side, edge node): integrate the face flux against the edge
    // basis; the left element of a face receives it with a minus sign
    const int cs = t / n, k = t - cs * n;
    const int sd = cs & 3;
    const T* sq = S + L.sq + cs * m;
    T s = T(0);
#if BTP_ABLATE == 1
    s = sq[k];
#else
    for (int qq = 0; qq < m; ++qq) s += sq[qq] * psiq[k * m + qq];
#endif
    const T sign = (nbe[sd] < 0 || (sd & 1) == 0) ? T(-1) : T(1);
    S[L.se + t] = sign * s;
  }
  if (visc) {
    for (int t = rot<NT>(7); t < 2 * npts; t += NT) {
      const int cc = t / npts, nn = t - cc * npts;
      const int j = nn / n, i = nn - j * n;
      const T* X = S + L.qq + (2 * cc) * npts;
      const T* Y = X + npts;
      T s = T(0);
#if BTP_ABLATE == 1
      s = X[nn] + Y[nn];
#else
      for (int k = 0; k < n; ++k) {
        s += X[j * n + k] * dpsi[i * n + k];
        s += Y[k * n + i] * dpsi[j * n + k];
      }
#endif
      S[L.lap + t] = -s;
    }
  }
  __syncthreads();

  // ---- phase E: massinv, SSPRK combine, wall projection --------------------
  const T a0 = a.a[ik][0], a1 = a.a[ik][1], a2 = a.a[ik][2];
  const T dtb = a.dt * a.b[ik];
  const bool snapshot = ROUTE == kResident && a.kstages == 5 && ik == 1;
  const T* td = S + L.td;
  for (int t = tid; t < 3 * npts; t += NT) {
    const int c = t / npts, nn = t - c * npts;
    const int j = nn / n, i = nn - j * n;
    T r = S[L.rhs + t] + edge_sum(S + L.se + c * 4 * n, n, j, i);
    if (visc && c > 0) {
      const T lap = S[L.lap + (c - 1) * npts + nn] + edge_sum(S + L.sv + (c - 1) * 4 * n, n, j, i);
      r += a.visc * lap;
    }
    r = td[D_MASSINV * npts + nn] * (r + td[(D_REF3 + c) * npts + nn]);
    const T v = a0 * S[L.q0 + t] + a1 * q1[(c + 1) * npts + nn] + a2 * S[L.q2 + t] + dtb * r;
    T out = v;
    if (c == 0) {
      const T pb = v + td[D_PBP * npts + nn];   // pb = pb' + pbprime
      dst.p[nn] = pb;
      if (ROUTE == kResident) S[L.q1 + nn] = pb;
    } else {
      out = td[(c == 1 ? D_MASKU : D_MASKV) * npts + nn] * v;
    }
    dst.p[(c + 1) * dst.cstride + nn] = out;
    if (ROUTE == kResident) {
      S[L.q1 + (c + 1) * npts + nn] = out;
      // SSP(5,3) snapshots the stage-2 state into the third register
      if (snapshot) S[L.q2 + t] = out;
    }
  }
}

template <typename T, int NGL, int NQ, int ROUTE>
__global__ void __launch_bounds__(kThreads<ROUTE>, kMinBlocks<T>)
btp_mega_kernel(const Args<T> a) {
  constexpr int NT = kThreads<ROUTE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = NGL > 0 ? NGL : a.ngl, m = NQ > 0 ? NQ : a.nq;
  const int npts = n * n, pn = padded<T>(npts);
  const Lay L = layout<T>(n, m);
  T* S = reinterpret_cast<T*>(smem_raw);
  int* nbe = reinterpret_cast<int*>(S + L.total);
  cg::grid_group grid = cg::this_grid();
  const long long E = a.E;
  const long long buf = 4 * E * npts;    // one state buffer

#if BTP_ABLATE == 3
  for (int st = 0; st < a.nsub; ++st) grid.sync();
  return;
#endif

  gather<NT, false>(S + L.psiq, a.psiq, 0, n * m, 1);
  gather<NT, false>(S + L.dpsiq, a.dpsiq, 0, n * m, 1);
  gather<NT, false>(S + L.dpsi, a.dpsi, 0, n * n, 1);
  gather<NT, false>(S + L.wq3, a.wq3, 0, 3 * m * m, 1);
  gather<NT, false>(S + L.wn2, a.wn2, 0, 2 * npts, 1);
  gather<NT, false>(S + L.mirq, a.mirq, 0, 16, 1);
  gather<NT, false>(S + L.mirg, a.mirg, 0, 16, 1);

  if constexpr (ROUTE == kResident) {
    // one block per element (the grid is E blocks, all resident)
    const long long e = blockIdx.x;
    const int nqq = m * m;
    load_tables<NT, false>(a, S, L, e, n, m);
    gather<NT, false>(S + L.accv, a.accv + e * nqq, E * nqq, nqq, 12);
    gather<NT, false>(S + L.aff, a.aff + e * 4 * m, E * 4 * m, 4 * m, 16);
    gather<NT, false>(S + L.accn, a.accn + e * npts, E * npts, npts, 3);
    if (a.use_visc) {
      gather<NT, false>(S + L.agt, a.agt + e * 4 * n, E * 4 * n, 4 * n, 8);
      gather<NT, false>(S + L.agr, a.agr + e * npts, E * npts, npts, 4);
    }
    gather<NT, false>(S + L.q1, a.qb_in + e * npts, E * npts, npts, 4);
    for (int t = threadIdx.x; t < 3 * npts; t += NT) S[L.q2 + t] = T(0);
    if (threadIdx.x < 4) nbe[threadIdx.x] = a.nbr[e * 4 + threadIdx.x];
    __syncthreads();
    // Two exchange buffers in a.ws: element e's four channels at x + e*4*pn,
    // each padded to 16 bytes. Stage st writes buffer st & 1 and its
    // neighbours read the other; buffer 1 starts with the state at t.
    const long long xsize = E * 4 * pn;
    for (int t = threadIdx.x; t < 4 * npts; t += NT) {
      const int c = t / npts;
      a.ws[xsize + e * 4 * pn + c * pn + (t - c * npts)] = S[L.q1 + t];
    }
    // done[e], after the exchange buffers: the stages element e has finished.
    // A stage waits for its four neighbours only, not for the grid: at the
    // start of stage st they have finished stage st-1, so its outputs are
    // there, and they have read this element's output of stage st-2 (their
    // stage st-1 input), the buffer this stage overwrites. No neighbour can
    // be further ahead: it would wait for this element.
    int* done = reinterpret_cast<int*>(a.ws + 2 * xsize);
    if (threadIdx.x == 0) done[e] = 0;
    grid.sync();
    constexpr int per = 16 / int(sizeof(T));
    const int pieces = pn / per;           // 16-byte pieces of one channel
    for (int st = 0; st < a.nsub; ++st) {
      if (st > 0) {
#if BTP_ABLATE == 4
        grid.sync();
#else
        if (threadIdx.x < 4 && nbe[threadIdx.x] >= 0) {
          const volatile int* d = done + nbe[threadIdx.x];
          while (*d < st) {
          }
          __threadfence();   // acquire: the neighbour's output, then the flag
        }
        __syncthreads();
#endif
      }
#if BTP_ABLATE != 2
      // the neighbours' pre-stage state, 16 bytes a copy around the L1, in
      // flight during phase A
      const T* x = a.ws + ((st + 1) & 1) * xsize;
      for (int p = thread_index(); p < 16 * pieces; p += NT) {
        const int sd = p / (4 * pieces), r = p - sd * 4 * pieces;
        if (nbe[sd] >= 0)
          cp_async_16(S + L.nb + sd * 4 * pn + r * per, x + nbe[sd] * 4 * pn + r * per);
      }
      cp_async_commit();
#endif
      const Out<T> dst = st == a.nsub - 1 ? Out<T>{a.qb_out + e * npts, E * npts}
                                          : Out<T>{a.ws + (st & 1) * xsize + e * 4 * pn, pn};
      element_stage<T, NGL, NQ, ROUTE>(a, S, nbe, e, st % a.kstages, dst);
      __syncthreads();   // the block's output is stored
#if BTP_ABLATE != 4
      if (threadIdx.x == 0) {
        __threadfence();   // release: the output, then the flag
        atomicExch(done + e, st + 1);
      }
#endif
    }
    __syncthreads();
    auto put = [&](T* dst, int off, int len, int nchan) {
      for (int t = threadIdx.x; t < nchan * len; t += NT) {
        const int c = t / len;
        dst[c * E * len + e * len + (t - c * len)] = S[off + t];
      }
    };
    put(a.accv, L.accv, nqq, 12);
    put(a.aff, L.aff, 4 * m, 16);
    put(a.accn, L.accn, npts, 3);
    if (a.use_visc) {
      put(a.agt, L.agt, 4 * n, 8);
      put(a.agr, L.agr, npts, 4);
    }
  } else {
    // state buffers 0..3 are a.ws, 4 is the caller's state (read only). The
    // roles follow from the stage index alone, the same in every block.
    // Within a stage every block reads buffer i1 (its own element and its
    // neighbours') and i0, i2 (its own element) and writes only its own
    // elements of a buffer that nobody reads in that stage.
    auto buffer = [&](int idx) -> const T* { return idx == 4 ? a.qb_in : a.ws + idx * buf; };
    int i0 = 4, i1 = 4, i2 = 0;   // buffer 0 starts as the zero third register
    bool first = true;
    for (int st = 0; st < a.nsub; ++st) {
      const int ik = st % a.kstages;
      if (ik == 0) i0 = i1;       // register 0 of this sub-step
      int io = 0;
      while (io == i0 || io == i1 || io == i2) ++io;
      T* out = (st == a.nsub - 1) ? a.qb_out : a.ws + io * buf;
      const T* src = buffer(i1);
      for (long long e = blockIdx.x; e < E; e += gridDim.x) {
        __syncthreads();   // the previous element's readers are done
#if BTP_ABLATE == 2
        if (first)
#endif
        {
          load_tables<NT, true>(a, S, L, e, n, m);
          gather<NT, true>(S + L.q1, src + e * npts, E * npts, npts, 4);
          gather<NT, true>(S + L.q0, buffer(i0) + E * npts + e * npts, E * npts, npts, 3);
          gather<NT, true>(S + L.q2, buffer(i2) + E * npts + e * npts, E * npts, npts, 3);
          if (threadIdx.x < 4) nbe[threadIdx.x] = a.nbr[e * 4 + threadIdx.x];
          // the neighbours' state (side, channel, node), four loads in
          // flight before their stores
          for (int t0 = thread_index(); t0 < 16 * npts; t0 += 4 * NT) {
            T v[4];
            int at[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int t = t0 + u * NT;
              at[u] = -1;
              if (t < 16 * npts) {
                const int sd = t / (4 * npts), r = t - sd * 4 * npts;
                const int c = r / npts, nn = r - c * npts;
                const int nb = a.nbr[e * 4 + sd];
                if (nb >= 0) {
                  v[u] = __ldcg(src + c * E * npts + (long long)nb * npts + nn);
                  at[u] = sd * 4 * pn + c * pn + nn;
                }
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (at[u] >= 0) S[L.nb + at[u]] = v[u];
          }
          cp_async_wait<0>();
        }
        first = false;
        __syncthreads();
        element_stage<T, NGL, NQ, ROUTE>(a, S, nbe, e, ik, Out<T>{out + e * npts, E * npts});
      }
      if (st + 1 < a.nsub) grid.sync();
      // SSP(5,3) snapshots the stage-2 state into the third register
      if (a.kstages == 5 && ik == 1) i2 = io;
      i1 = io;
    }
    (void)first;
  }
}

// How a launch of this size is laid out: the route, the plan of its kernel
// (cached per kernel, device and size by plan_launch) and the grid.
struct MegaLayout {
  int route = kStreamed;
  LaunchPlan plan;
  long long grid = 0;
};

template <typename T, int NGL, int NQ, int ROUTE>
cudaError_t launch_route(Args<T>& a, const MegaLayout& lay, cudaStream_t stream) {
  auto kernel = btp_mega_kernel<T, NGL, NQ, ROUTE>;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3((unsigned)lay.grid), dim3(kThreads<ROUTE>), params,
                                     lay.plan.smem, stream);
}

// The layout of a launch of E elements; with `a`, also the launch. `route`
// kAuto takes the resident route exactly when one block per element fits the
// card at once, else the streamed one; a route asked for by name is taken or
// refused (the resident route with more elements than resident blocks).
// Nothing falls back from one route to the other.
constexpr int kAuto = -1;

template <typename T, int NGL, int NQ>
cudaError_t plan(int route, long long E, int ngl, int nq, MegaLayout& out, Args<T>* a,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(ngl, nq);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = plan_launch(btp_mega_kernel<T, NGL, NQ, kResident>,
                                kThreads<kResident>, smem, out.plan);
  if (err != cudaSuccess) return err;
  if (route == kResident || (route == kAuto && E <= out.plan.resident_blocks)) {
    if (E > out.plan.resident_blocks) return cudaErrorCooperativeLaunchTooLarge;
    out.route = kResident;
    out.grid = E;
    return a ? launch_route<T, NGL, NQ, kResident>(*a, out, stream) : cudaSuccess;
  }
  err = plan_launch(btp_mega_kernel<T, NGL, NQ, kStreamed>, kThreads<kStreamed>, smem,
                    out.plan);
  if (err != cudaSuccess) return err;
  out.route = kStreamed;
  out.grid = E < out.plan.resident_blocks ? E : out.plan.resident_blocks;
  return a ? launch_route<T, NGL, NQ, kStreamed>(*a, out, stream) : cudaSuccess;
}

template <typename T>
cudaError_t plan_any(int route, long long E, int ngl, int nq, MegaLayout& out, Args<T>* a,
                     cudaStream_t stream) {
  // p = 4 with exact integration (ngl = 5, nq = 9), the order the model is
  // run at, has its own instantiations; every other order takes the sizes at
  // run time
  if (ngl == 5 && nq == 9) return plan<T, 5, 9>(route, E, ngl, nq, out, a, stream);
  if (ngl > kMaxNgl) return cudaErrorInvalidValue;
  return plan<T, 0, 0>(route, E, ngl, nq, out, a, stream);
}

template <typename T>
cudaError_t run(int route, void* const* p, const int* iv, const double* rv,
                cudaStream_t stream, int* taken) {
  Args<T> a;
  a.qb_in = static_cast<const T*>(p[P_QB_IN]);
  a.ws = static_cast<T*>(p[P_WS]);
  a.qb_out = static_cast<T*>(p[P_QB_OUT]);
  a.qplq = static_cast<const T*>(p[P_QPLQ]);
  a.coup = static_cast<const T*>(p[P_COUP]);
  a.qe = static_cast<const T*>(p[P_QE]);
  a.bgf = static_cast<const T*>(p[P_BGF]);
  a.pvisc = static_cast<const T*>(p[P_PVISC]);
  a.bdg = static_cast<const T*>(p[P_BDG]);
  a.ptab = static_cast<const T*>(p[P_PTAB]);
  a.ref3 = static_cast<const T*>(p[P_REF3]);
  a.massinv = static_cast<const T*>(p[P_MASSINV]);
  a.pbp = static_cast<const T*>(p[P_PBP]);
  a.opbp = static_cast<const T*>(p[P_OPBP]);
  a.masku = static_cast<const T*>(p[P_MASKU]);
  a.maskv = static_cast<const T*>(p[P_MASKV]);
  a.ftab = static_cast<const T*>(p[P_FTAB]);
  a.ntab = static_cast<const T*>(p[P_NTAB]);
  a.nbr = static_cast<const int*>(p[P_NBR]);
  a.mirq = static_cast<const T*>(p[P_MIRQ]);
  a.mirg = static_cast<const T*>(p[P_MIRG]);
  a.psiq = static_cast<const T*>(p[P_PSIQ]);
  a.dpsiq = static_cast<const T*>(p[P_DPSIQ]);
  a.dpsi = static_cast<const T*>(p[P_DPSI]);
  a.wq3 = static_cast<const T*>(p[P_WQ3]);
  a.wn2 = static_cast<const T*>(p[P_WN2]);
  a.accv = static_cast<T*>(p[P_ACCV]);
  a.accn = static_cast<T*>(p[P_ACCN]);
  a.agr = static_cast<T*>(p[P_AGR]);
  a.aff = static_cast<T*>(p[P_AFF]);
  a.agt = static_cast<T*>(p[P_AGT]);
  a.E = iv[I_E];
  a.ngl = iv[I_NGL];
  a.nq = iv[I_NQ];
  a.nsub = iv[I_NSUB];
  a.kstages = iv[I_KSTAGES];
  a.botfr = iv[I_BOTFR];
  a.use_visc = iv[I_USE_VISC];
  a.dt = T(rv[R_DT]);
  a.grav = T(rv[R_GRAV]);
  a.cd = T(rv[R_CD]);
  a.alpha_bot = T(rv[R_ALPHA_BOT]);
  a.visc = T(rv[R_VISC]);
  a.kx_df = T(rv[R_KX_DF]);
  a.ey_df = T(rv[R_EY_DF]);
  for (int k = 0; k < kMaxStages; ++k) {
    for (int c = 0; c < 3; ++c) a.a[k][c] = T(rv[R_A + 3 * k + c]);
    a.b[k] = T(rv[R_B + k]);
  }
  MegaLayout lay;
  const cudaError_t err = plan_any<T>(route, a.E, a.ngl, a.nq, lay, &a, stream);
  *taken = lay.route;
  return err;
}

}  // namespace

extern "C" {

// The card's limit of shared memory for one block, in bytes.
long long btp_mega_smem_limit() { return (long long)kSmemLimit; }

// Shared memory one block needs, in bytes, on either route (the caller checks
// it against the limit before launching).
long long btp_mega_smem_bytes(int is_double, int ngl, int nq) {
  return (long long)(is_double ? smem_bytes<double>(ngl, nq) : smem_bytes<float>(ngl, nq));
}

// How a launch of E elements at these sizes is laid out on the current
// device: route (in: -1 as btp_mega_launch chooses, 0 streamed, 1 resident;
// out: 0 or 1), elements per block (at most), threads per block, shared
// memory per block (bytes), resident blocks per SM and the grid. Returns a
// cudaError_t.
int btp_mega_layout(int is_double, int E, int ngl, int nq, int* route, int* elements_per_block,
                    int* threads, long long* smem, int* blocks_per_sm, long long* grid) {
  if (E <= 0 || ngl <= 0 || nq <= 0 || *route < kAuto || *route > kResident)
    return int(cudaErrorInvalidValue);
  MegaLayout lay;
  const cudaError_t err =
      is_double ? plan_any<double>(*route, E, ngl, nq, lay, nullptr, nullptr)
                : plan_any<float>(*route, E, ngl, nq, lay, nullptr, nullptr);
  if (err != cudaSuccess) return int(err);
  *route = lay.route;
  *elements_per_block = int((E + lay.grid - 1) / lay.grid);
  *threads = lay.route == kResident ? kThreads<kResident> : kThreads<kStreamed>;
  *smem = (long long)lay.plan.smem;
  *blocks_per_sm = lay.plan.blocks_per_sm;
  *grid = lay.grid;
  return 0;
}

// Launch on `stream` on the route btp_mega_layout gives (in `route`, as
// there); does not synchronise. Sets `taken` to the route launched (0
// streamed, 1 resident). Returns the launch's cudaError_t.
int btp_mega_launch_route(int route, void* const* ptrs, int n_ptrs, const int* ints, int n_ints,
                          const double* reals, int n_reals, void* stream, int* taken) {
  if (n_ptrs != P_COUNT || n_ints != I_COUNT || n_reals != R_COUNT || route < kAuto ||
      route > kResident)
    return int(cudaErrorInvalidValue);
  const int E = ints[I_E], ngl = ints[I_NGL], nq = ints[I_NQ];
  const int nsub = ints[I_NSUB], kstages = ints[I_KSTAGES];
  if (E <= 0 || ngl <= 0 || nq <= 0 || nsub <= 0 || kstages <= 0 ||
      kstages > kMaxStages || ints[I_BOTFR] < 0 || ints[I_BOTFR] > 2)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[I_IS_DOUBLE]) return int(run<double>(route, ptrs, ints, reals, s, taken));
  return int(run<float>(route, ptrs, ints, reals, s, taken));
}

// The same on the route the layout chooses.
int btp_mega_launch(void* const* ptrs, int n_ptrs, const int* ints, int n_ints,
                    const double* reals, int n_reals, void* stream) {
  int taken;
  return btp_mega_launch_route(kAuto, ptrs, n_ptrs, ints, n_ints, reals, n_reals, stream,
                               &taken);
}

const char* btp_mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
