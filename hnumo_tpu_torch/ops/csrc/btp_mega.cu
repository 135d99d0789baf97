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
// neighbours, and a block's shared memory holds one element, not the grid.
// So this is one persistent cooperative kernel: blocks walk the elements
// grid-stride, the state lives in global memory (a few MB, resident in L2)
// and one grid-wide barrier separates the stages. The SSPRK registers
// qb0/qb1/qb2 and the stage's output are four rotating buffers whose roles
// every block derives from the stage index alone: "qb0 <- qb1" and
// "qb2 <- new" are index assignments, never copies. Within a stage every
// block reads buffer i1 (its own element and its neighbours') and i0, i2 (its
// own element) and writes only its own elements of a buffer that nobody
// reads in that stage, so one barrier per stage is enough. The caller's
// state (buffer index 4) is only ever read.
// Neighbour values are recomputed, not exchanged: a block loads its
// neighbours' nodal state and evaluates their edge gradients itself with the
// same device functions the owner uses, so both elements of an interior face
// get the same left/right values. Each element computes its own four sides
// and accumulates their averages per side: every output location has one
// writer, there are no atomics. The tensor-product operators are applied
// sum-factorised from the 1-D tables (psiq, dpsiq, dpsi) held in shared
// memory; nothing is padded.
//
// What bounds it on this card: by the count of bytes moved once and of
// flops, operations (about 33 kflop per element and stage at p=4); in fact
// neither. The accumulators and the per-element tables are re-read from
// global memory (L2 at <= 1024 elements) in every stage, and the time is the
// latency of nsub dependent stages: six block-wide phases, each waiting on
// its own global loads, plus one grid barrier. What the design does about
// it: one block per element when the grid fits the card at once (1024
// elements do, at 8 blocks of 128 threads per SM), compile-time sizes for
// the order the model is run at (p=4), the loops of one phase spread over
// different warps, and the neighbours' indices read once per block.
//
// Plain C interface (loaded with ctypes; no PyTorch headers): the launcher
// takes three arrays (pointers, ints, doubles) indexed by the enums below and
// returns the cudaError_t of the launch as an int, 0 on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

constexpr int kThreads = 128;     // a power of two (rot)
constexpr int kBlocksPerSm = 8;   // register cap: 65536 / (8 * 128) = 64

template <typename T> __device__ __forceinline__ T t_sqrt(T x);
template <> __device__ __forceinline__ float t_sqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double t_sqrt<double>(double x) { return sqrt(x); }

template <typename T>
struct Args {
  const T* qb_in;   // (4, E, npts)  state at t, read only
  T* ws;            // (4, 4, E, npts) rotating state buffers, zeroed
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

// One block's shared memory, carved from one dynamic array.
template <typename T>
struct Smem {
  T *psiq, *dpsiq, *dpsi, *wq3, *wn2;   // operators
  T *q;      // (4, npts)      own pre-stage state
  T *nb;     // (4 sides, 4, npts) neighbours' pre-stage state
  T *uv;     // (2, npts)      own u, v
  T *nbuv;   // (4 sides, 2, npts) neighbours' u, v
  T *tmp;    // (4, ngl, nq)   interpolation, first pass
  T *f;      // (8, nqq)       weighted flux rows
  T *t1, *t2;  // (3, nq, ngl) scatter, first pass
  T *rhs;    // (3, npts)
  T *l, *r;  // (4, 4 sides, ngl) nodal traces left / right of each side
  T *lq, *rq;  // (4, 4 sides, nq) the same at the face quad points
  T *sq;     // (3, 4 sides, nq) integrand of the face scatter
  T *se;     // (3, 4 sides, ngl) signed edge values of the face scatter
  T *g;      // (4, npts)      grad(u, v)
  T *sv;     // (2, 4 sides, ngl) signed edge values of the viscous flux
  T *qq;     // (4, npts)      weighted viscous volume flux
  T *lap;    // (2, npts)
};

template <typename T>
__host__ __device__ size_t carve(Smem<T>& s, T* base, int n, int m) {
  const int npts = n * n, nqq = m * m;
  size_t o = 0;
  auto take = [&](size_t count) { T* p = base + o; o += count; return p; };
  s.psiq = take(n * m);   s.dpsiq = take(n * m);   s.dpsi = take(n * n);
  s.wq3 = take(3 * nqq);  s.wn2 = take(2 * npts);
  s.q = take(4 * npts);   s.nb = take(16 * npts);
  s.uv = take(2 * npts);  s.nbuv = take(8 * npts);
  s.tmp = take(4 * n * m);
  s.f = take(8 * nqq);
  s.t1 = take(3 * m * n); s.t2 = take(3 * m * n);
  s.rhs = take(3 * npts);
  s.l = take(16 * n);     s.r = take(16 * n);
  s.lq = take(16 * m);    s.rq = take(16 * m);
  s.sq = take(12 * m);    s.se = take(12 * n);
  s.g = take(4 * npts);   s.sv = take(8 * n);
  s.qq = take(4 * npts);  s.lap = take(2 * npts);
  return o;
}

// k-th node along side s (east, west, north, south) of an n x n element,
// nodes numbered j*n + i
__device__ __forceinline__ int edge_node(int s, int k, int n) {
  switch (s) {
    case 0: return k * n + (n - 1);
    case 1: return k * n;
    case 2: return (n - 1) * n + k;
    default: return k;
  }
}

// Component c of grad(u, v) = (du/dx, du/dy, dv/dx, dv/dy) at node (j, i) of
// the element whose nodal (u, v) are uv[0..npts), uv[npts..2 npts). Owner and
// neighbour evaluate a trace with this one function: same values, same order.
template <typename T>
__device__ __forceinline__ T grad_uv(const T* uv, const T* dpsi, int n, int c,
                                     int j, int i, T kx, T ey) {
  const T* f = uv + (c >> 1) * n * n;
  T a = T(0);
  if ((c & 1) == 0) {
    for (int k = 0; k < n; ++k) a += f[j * n + k] * dpsi[k * n + i];
    return kx * a;
  }
  for (int k = 0; k < n; ++k) a += f[k * n + i] * dpsi[k * n + j];
  return ey * a;
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
__device__ __forceinline__ int rot(int off) {
  return (int(threadIdx.x) + kThreads - off) & (kThreads - 1);
}

// One stage of element e: reads q0, q1, q2 (global), writes dst (global).
// NGL, NQ > 0 fix the 1-D sizes at compile time (index arithmetic by
// constants, inner loops unrolled); 0 takes them from the arguments.
template <typename T, int NGL, int NQ>
__device__ void element_stage(const Args<T>& a, const Smem<T>& s, int e, int ik,
                              const T* q0, const T* q1, const T* q2, T* dst) {
  const int tid = threadIdx.x;
  const int n = NGL > 0 ? NGL : a.ngl, m = NQ > 0 ? NQ : a.nq;
  const int npts = n * n, nqq = m * m;
  const long long E = a.E;
  const long long sn = E * npts;   // channel stride, nodal arrays
  const long long sq = E * nqq;    // channel stride, quad arrays
  const long long en = (long long)e * npts;
  const long long eq = (long long)e * nqq;
  const bool visc = a.use_visc != 0;
  // the element's four neighbours (-1 = wall), shared by the block: no phase
  // after the last barrier of an element reads them, so they may be replaced
  // before the first barrier of the next
  __shared__ int nbe[4];
  if (tid < 4) nbe[tid] = a.nbr[e * 4 + tid];

  // ---- phase 0: own and neighbours' pre-stage state -> shared memory ------
  __syncthreads();   // the previous element's readers are done
  for (int t = tid; t < 4 * npts; t += kThreads) {
    const int c = t / npts, nn = t - c * npts;
    s.q[t] = __ldcg(q1 + c * sn + en + nn);
  }
  for (int t = tid; t < 16 * npts; t += kThreads) {
    const int sd = t / (4 * npts), r = t - sd * 4 * npts;
    const int c = r / npts, nn = r - c * npts;
    if (nbe[sd] >= 0) s.nb[t] = __ldcg(q1 + c * sn + (long long)nbe[sd] * npts + nn);
  }
  __syncthreads();

  // ---- phase 1: nodal averages, u and v, interpolation pass 1, traces ------
  for (int nn = tid; nn < npts; nn += kThreads) {
    // nodal averages from the PRE-stage state
    const T inv_pb = T(1) / s.q[nn];
    const T t_df = s.q[npts + nn] * a.opbp[en + nn];
    const T u = s.q[2 * npts + nn] * inv_pb;
    const T v = s.q[3 * npts + nn] * inv_pb;
    a.accn[en + nn] += t_df * (T(2) + t_df);
    a.accn[sn + en + nn] += u;
    a.accn[2 * sn + en + nn] += v;
    s.uv[nn] = u;
    s.uv[npts + nn] = v;
  }
  if (visc) {
    for (int t = rot(32); t < 4 * npts; t += kThreads) {
      const int sd = t / npts, nn = t - sd * npts;
      if (nbe[sd] >= 0) {
        const T* qn = s.nb + sd * 4 * npts;
        const T inv_pb = T(1) / qn[nn];
        s.nbuv[sd * 2 * npts + nn] = qn[2 * npts + nn] * inv_pb;
        s.nbuv[sd * 2 * npts + npts + nn] = qn[3 * npts + nn] * inv_pb;
      }
    }
  }
  for (int t = tid; t < 4 * n * m; t += kThreads) {
    // tmp[c][j][I] = sum_i q[c][j][i] psiq[i][I]
    const int c = t / (n * m), r = t - c * n * m;
    const int j = r / m, I = r - j * m;
    const T* row = s.q + c * npts + j * n;
    T acc = T(0);
    for (int i = 0; i < n; ++i) acc += row[i] * s.psiq[i * m + I];
    s.tmp[t] = acc;
  }
  for (int t = rot(64); t < 16 * n; t += kThreads) {
    // left/right nodal traces of qb at side sd: the element is the left side
    // of its east/north faces and of a boundary face, else the right side
    const int c = t / (4 * n), r = t - c * 4 * n;
    const int sd = r / n, k = r - sd * n;
    const T own = s.q[c * npts + edge_node(sd, k, n)];
    T left = own, right;
    if (nbe[sd] < 0) {
      right = a.mirq[sd * 4 + c] * own;
    } else {
      const T other = s.nb[sd * 4 * npts + c * npts + edge_node(sd ^ 1, k, n)];
      if ((sd & 1) == 0) { right = other; } else { left = other; right = own; }
    }
    s.l[t] = left;
    s.r[t] = right;
  }
  __syncthreads();

  // ---- phase 2: quad-point physics, face interpolation, grad(u, v) ---------
  for (int q = tid; q < nqq; q += kThreads) {
    const int J = q / m, I = q - J * m;
    T dp = T(0), dpp = T(0), udp = T(0), vdp = T(0);
    for (int j = 0; j < n; ++j) {
      const T p = s.psiq[j * m + J];
      dp += s.tmp[(0 * n + j) * m + I] * p;
      dpp += s.tmp[(1 * n + j) * m + I] * p;
      udp += s.tmp[(2 * n + j) * m + I] * p;
      vdp += s.tmp[(3 * n + j) * m + I] * p;
    }
    const long long iq = eq + q;
    const T ppq = a.qplq[iq], up = a.qplq[sq + iq], vp = a.qplq[2 * sq + iq];
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
  for (int t = rot(96); t < 16 * m; t += kThreads) {
    // (c, side, face quad point): interpolate both traces
    const int cs = t / m, qq = t - cs * m;
    T al = T(0), ar = T(0);
    for (int k = 0; k < n; ++k) {
      const T p = s.psiq[k * m + qq];
      al += s.l[cs * n + k] * p;
      ar += s.r[cs * n + k] * p;
    }
    s.lq[t] = al;
    s.rq[t] = ar;
  }
  if (visc) {
    for (int t = rot(96); t < 4 * npts; t += kThreads) {
      const int c = t / npts, nn = t - c * npts;
      const int j = nn / n, i = nn - j * n;
      const T gv = grad_uv(s.uv, s.dpsi, n, c, j, i, a.kx_df, a.ey_df);
      s.g[t] = gv;
      a.agr[c * sn + en + nn] += gv;
    }
  }
  __syncthreads();

  // ---- phase 3: scatter pass 1, face flux, viscous traces and fluxes -------
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
  for (int t = rot(96); t < 4 * m; t += kThreads) {
    // face flux at (side, quad point): reference creat_btp_fluxes_qdf
    const long long ifq = (long long)e * 4 * m + t;   // (e, side, q) of a (.., E, 4, nq) table
    const long long sf = E * 4 * m;                   // its channel stride
    const T nx = a.ftab[ifq], ny = a.ftab[sf + ifq], jacf = a.ftab[2 * sf + ifq];
    const T cpL = a.ftab[3 * sf + ifq], cpR = a.ftab[4 * sf + ifq];
    const T cpub = a.ftab[5 * sf + ifq];
    const T cmL = a.ftab[6 * sf + ifq], cmR = a.ftab[7 * sf + ifq];
    const T cmLR = a.ftab[8 * sf + ifq];
    const T opbe = a.ftab[9 * sf + ifq], Hedge = a.ftab[10 * sf + ifq];
    const T pbl = a.ftab[11 * sf + ifq], pbr = a.ftab[12 * sf + ifq];
    const T l0 = s.lq[t], l1 = s.lq[4 * m + t], l2 = s.lq[8 * m + t], l3 = s.lq[12 * m + t];
    const T r0 = s.rq[t], r1 = s.rq[4 * m + t], r2 = s.rq[8 * m + t], r3 = s.rq[12 * m + t];

    const T pU_L = nx * l2 + ny * l3;
    const T pU_R = -(nx * r2 + ny * r3);
    const T mue = (cpL * l1 + cpR * r1 + cpub * (pU_L + pU_R)) * opbe;
    const T mue2 = mue * (T(2) + mue);
    const T ope_e = T(1) + mue;
    const T flux_ex = cmL * l2 + cmR * r2 + cmLR * nx * (l1 - r1);
    const T flux_ey = cmL * l3 + cmR * r3 + cmLR * ny * (l1 - r1);
    const T ul = l2 / l0, ur = r2 / r0;
    const T vl = l3 / l0, vr = r3 / r0;
    const T Qe_uu = a.qe[ifq], Qe_uv = a.qe[sf + ifq];
    const T Qe_vv = a.qe[2 * sf + ifq], dHe = a.qe[3 * sf + ifq];
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
    for (int c = 0; c < 16; ++c) a.aff[c * sf + ifq] += inc[c];
    s.sq[t] = jacf * fl_m;
    s.sq[4 * m + t] = jacf * (nx * dH_f + fl_x);
    s.sq[8 * m + t] = jacf * (ny * dH_f + fl_y);
  }
  if (visc) {
    for (int t = rot(64); t < 4 * n; t += kThreads) {
      // flip-flop LDG flux at (side, edge node): reference
      // create_rhs_laplacian_flux (src/mod_laplacian_quad.F90:427-519)
      const int sd = t / n, k = t - sd * n;
      const long long ifn = (long long)e * 4 * n + t;   // (e, side, k) of a (.., E, 4, ngl) table
      const long long sg = E * 4 * n;
      const int own_node = edge_node(sd, k, n);
      const int nb_node = edge_node(sd ^ 1, k, n);
      const T bmulL = a.bgf[4 * sg + ifn], bmulR = a.bgf[9 * sg + ifn];
      T fl[4], fr[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T own = s.g[c * npts + own_node];
        T left = own, right;
        if (nbe[sd] < 0) {
          right = a.mirg[sd * 4 + c] * own;
        } else {
          const T other = grad_uv(s.nbuv + sd * 2 * npts, s.dpsi, n, c,
                                  nb_node / n, nb_node % n, a.kx_df, a.ey_df);
          if ((sd & 1) == 0) { right = other; } else { left = other; right = own; }
        }
        a.agt[c * sg + ifn] += left;
        a.agt[(4 + c) * sg + ifn] += right;
        fl[c] = bmulL * left + a.bgf[c * sg + ifn];
        fr[c] = bmulR * right + a.bgf[(5 + c) * sg + ifn];
      }
      const T nxdf = a.ntab[ifn], nydf = a.ntab[sg + ifn], jacdf = a.ntab[2 * sg + ifn];
      const T flux_qu = (T(0.5) * (fl[0] + fr[0]) - fl[0] * nxdf)
                        + (T(0.5) * (fl[1] + fr[1]) - fl[1] * nydf);
      const T flux_qv = (T(0.5) * (fl[2] + fr[2]) - fl[2] * nxdf)
                        + (T(0.5) * (fl[3] + fr[3]) - fl[3] * nydf);
      // the Laplacian receives MINUS the flux with the face scatter's sign
      const T sign = (nbe[sd] < 0 || (sd & 1) == 0) ? T(1) : T(-1);
      s.sv[t] = sign * (jacdf * flux_qu);
      s.sv[4 * n + t] = sign * (jacdf * flux_qv);
    }
    for (int t = rot(32); t < 4 * npts; t += kThreads) {
      // qq = pbprime_visc * graduv + btp_dpp_graduv, weighted for the nodal
      // quadrature: x-derivative channels (0, 2) by w*ksi_x, (1, 3) by w*eta_y
      const int c = t / npts, nn = t - c * npts;
      s.qq[t] = s.wn2[(c & 1) * npts + nn]
                * (a.pvisc[en + nn] * s.g[t] + a.bdg[c * sn + en + nn]);
    }
  }
  __syncthreads();

  // ---- phase 4: scatter pass 2, face scatter, volume Laplacian -------------
  for (int t = tid; t < 3 * npts; t += kThreads) {
    // rhs[c][j][i] = sum_J t1[c][J][i] psiq[j][J] + t2[c][J][i] dpsiq[j][J]
    const int c = t / npts, nn = t - c * npts;
    const int j = nn / n, i = nn - j * n;
    T acc = T(0);
    for (int J = 0; J < m; ++J) {
      acc += s.t1[(c * m + J) * n + i] * s.psiq[j * m + J];
      acc += s.t2[(c * m + J) * n + i] * s.dpsiq[j * m + J];
    }
    s.rhs[t] = acc;
  }
  for (int t = rot(80); t < 12 * n; t += kThreads) {
    // (c, side, edge node): integrate the face flux against the edge basis;
    // the left element of a face receives it with a minus sign
    const int cs = t / n, k = t - cs * n;
    const int sd = cs & 3;
    T acc = T(0);
    for (int qq = 0; qq < m; ++qq) acc += s.sq[cs * m + qq] * s.psiq[k * m + qq];
    const T sign = (nbe[sd] < 0 || (sd & 1) == 0) ? T(-1) : T(1);
    s.se[t] = sign * acc;
  }
  if (visc) {
    for (int t = rot(16); t < 2 * npts; t += kThreads) {
      const int cc = t / npts, nn = t - cc * npts;
      const int j = nn / n, i = nn - j * n;
      const T* X = s.qq + (2 * cc) * npts;
      const T* Y = X + npts;
      T acc = T(0);
      for (int k = 0; k < n; ++k) {
        acc += X[j * n + k] * s.dpsi[i * n + k];
        acc += Y[k * n + i] * s.dpsi[j * n + k];
      }
      s.lap[t] = -acc;
    }
  }
  __syncthreads();

  // ---- phase 5: massinv, SSPRK combine, wall projection --------------------
  const T a0 = a.a[ik][0], a1 = a.a[ik][1], a2 = a.a[ik][2];
  const T dtb = a.dt * a.b[ik];
  for (int t = tid; t < 3 * npts; t += kThreads) {
    const int c = t / npts, nn = t - c * npts;
    const int j = nn / n, i = nn - j * n;
    T r = s.rhs[t] + edge_sum(s.se + c * 4 * n, n, j, i);
    if (visc && c > 0) {
      const T lap = s.lap[(c - 1) * npts + nn] + edge_sum(s.sv + (c - 1) * 4 * n, n, j, i);
      r += a.visc * lap;
    }
    r = a.massinv[en + nn] * (r + a.ref3[c * sn + en + nn]);
    const long long ig = (c + 1) * sn + en + nn;
    const T v = a0 * __ldcg(q0 + ig) + a1 * s.q[(c + 1) * npts + nn]
                + a2 * __ldcg(q2 + ig) + dtb * r;
    if (c == 0) {
      dst[en + nn] = v + a.pbp[en + nn];   // pb = pb' + pbprime
      dst[ig] = v;
    } else if (c == 1) {
      dst[ig] = a.masku[en + nn] * v;
    } else {
      dst[ig] = a.maskv[en + nn] * v;
    }
  }
}

template <typename T, int NGL, int NQ>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
btp_mega_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = NGL > 0 ? NGL : a.ngl, m = NQ > 0 ? NQ : a.nq;
  Smem<T> s;
  carve(s, reinterpret_cast<T*>(smem_raw), n, m);
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  for (int t = tid; t < n * m; t += kThreads) {
    s.psiq[t] = a.psiq[t];
    s.dpsiq[t] = a.dpsiq[t];
  }
  for (int t = tid; t < n * n; t += kThreads) s.dpsi[t] = a.dpsi[t];
  for (int t = tid; t < 3 * m * m; t += kThreads) s.wq3[t] = a.wq3[t];
  for (int t = tid; t < 2 * n * n; t += kThreads) s.wn2[t] = a.wn2[t];

  // state buffers 0..3 are a.ws, 4 is the caller's state (read only). The
  // roles follow from the stage index alone, the same in every block.
  const long long buf = 4LL * a.E * n * n;
  auto buffer = [&](int idx) -> const T* { return idx == 4 ? a.qb_in : a.ws + idx * buf; };
  int i0 = 4, i1 = 4, i2 = 0;   // buffer 0 starts as the zero third register
  for (int st = 0; st < a.nsub; ++st) {
    const int ik = st % a.kstages;
    if (ik == 0) i0 = i1;       // register 0 of this sub-step
    int io = 0;
    while (io == i0 || io == i1 || io == i2) ++io;
    T* dst = (st == a.nsub - 1) ? a.qb_out : a.ws + io * buf;
    for (int e = blockIdx.x; e < a.E; e += gridDim.x)
      element_stage<T, NGL, NQ>(a, s, e, ik, buffer(i0), buffer(i1), buffer(i2), dst);
    grid.sync();
    // SSP(5,3) snapshots the stage-2 state into the third register
    if (a.kstages == 5 && ik == 1) i2 = io;
    i1 = io;
  }
}

template <typename T>
size_t smem_bytes(int ngl, int nq) {
  Smem<T> s;
  return sizeof(T) * carve<T>(s, nullptr, ngl, nq);
}

template <typename T, int NGL, int NQ>
cudaError_t launch(Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.ngl, a.nq);
  auto kernel = btp_mega_kernel<T, NGL, NQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  // all blocks of a cooperative launch must be resident at once
  long long blocks = (long long)sms * per_sm;
  if (blocks > a.E) blocks = a.E;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3((unsigned)blocks), dim3(kThreads),
                                     params, smem, stream);
}

template <typename T>
cudaError_t run(void* const* p, const int* iv, const double* rv, cudaStream_t stream) {
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
  // p = 4 with exact integration (ngl = 5, nq = 9), the order the model is
  // run at, has its own instantiation; every other order takes the sizes at
  // run time
  if (a.ngl == 5 && a.nq == 9) return launch<T, 5, 9>(a, stream);
  return launch<T, 0, 0>(a, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the caller checks it against the
// card's limit before launching).
long long btp_mega_smem_bytes(int is_double, int ngl, int nq) {
  return (long long)(is_double ? smem_bytes<double>(ngl, nq) : smem_bytes<float>(ngl, nq));
}

// Launch on `stream`; does not synchronise. Returns the launch's cudaError_t.
int btp_mega_launch(void* const* ptrs, int n_ptrs, const int* ints, int n_ints,
                    const double* reals, int n_reals, void* stream) {
  if (n_ptrs != P_COUNT || n_ints != I_COUNT || n_reals != R_COUNT)
    return int(cudaErrorInvalidValue);
  const int E = ints[I_E], ngl = ints[I_NGL], nq = ints[I_NQ];
  const int nsub = ints[I_NSUB], kstages = ints[I_KSTAGES];
  if (E <= 0 || ngl <= 0 || nq <= 0 || nsub <= 0 || kstages <= 0 ||
      kstages > kMaxStages || ints[I_BOTFR] < 0 || ints[I_BOTFR] > 2)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[I_IS_DOUBLE]) return int(run<double>(ptrs, ints, reals, s));
  return int(run<float>(ptrs, ints, reals, s));
}

const char* btp_mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
