// Device code shared by the two barotropic volume kernels (btp_volume.cu,
// btp_volume_uni.cu), CUDA C++ for sm_90a (NVIDIA Hopper): the tile and its
// ring of input stages in shared memory, and the sum-factorised 1-D passes.
// The face and update kernels take its cp.async primitives, slot rounding
// and launch plan through btp_tail_common.cuh.
//
// The tile. A block works `G` consecutive elements at a time (G = 4 where the
// shared memory allows, else 2 or 1). In the flat element-major layout
// (C, E, row) the G elements of one channel are ONE contiguous run of G*row
// values, so a tile's input is a handful of contiguous runs, and the
// pointwise phase treats the tile as one flat run of G*nqq quad points.
//
// The ring. Every global input of a tile — state, tables, coupling and the
// accumulators' old values — is copied into a stage of shared memory with
// cp.async, and the copies of tile t+1 are started before tile t is computed,
// so a block always has a whole tile of loads in flight while it computes.
// A run is copied in 16-byte pieces when its two addresses and its length
// are multiples of 16 bytes (always so for full tiles of 4 when E is a
// multiple of 4), else value by value (4 or 8 bytes): the ragged last tile
// and element counts that are no multiple of 4 take that route. Both routes
// are decided per run, at run time, from the addresses themselves.
//
// The passes. Interpolation and weak-form scatter are two 1-D passes each.
// In three of the four a thread owns one line of the contracted axis, holds
// it in registers, and produces every output of that line; the 1-D tables
// are read from shared memory as broadcasts. The last (scatter along J) has
// too few lines to fill a block and gives each thread one output instead.
// With NGL, NQ > 0 the sizes are compile-time constants (p = 4: 5 and 9) and
// every loop is unrolled; with 0 they come from the arguments and the line
// is read from shared memory in the loop.
//
// BTP_ABLATE builds a variant that is only timed (chip_smoke.py,
// hnumo_tpu_torch/tools/kernel_ablation.py): 1 compiles the contractions out (memory-only
// time), 2 replaces every global read by a value computed from the index,
// written into the stages once per block (compute-only time). Both compute
// wrong numbers on purpose; the package's wrappers never build them.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <mutex>
#include <vector>

#ifndef BTP_ABLATE
#define BTP_ABLATE 0
#endif

namespace btpvol {

// 11 warps: one round of the pointwise phase over a tile of 4 elements at
// p = 4 (324 quad points), and 2 blocks per SM inside the register file.
constexpr int kThreads = 352;
constexpr int kStages = 2;
constexpr int kFluxRows = 8;   // (a_ksi, a_eta) x 3 channels, then 2 sources

template <typename T> __device__ __forceinline__ T t_sqrt(T x);
template <> __device__ __forceinline__ float t_sqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double t_sqrt<double>(double x) { return sqrt(x); }

// values per slot of a channel in shared memory: a tile's run, rounded up to
// a multiple of 16 bytes so that every slot starts 16-byte aligned
template <typename T>
__host__ __device__ constexpr int slot_values(int count) {
  constexpr int per16 = 16 / int(sizeof(T));
  return (count + per16 - 1) / per16 * per16;
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async_value(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of `nchan` channels of one array into consecutive slots:
// channel c is the run src[c*chan_stride + off .. + count) -> dst[c*slot ..).
// A warp takes whole channels (no index division per piece); `chan0`, the
// number of channels staged before this array, rotates the warps so that the
// arrays of one stage spread over all of them.
template <typename T>
__device__ __forceinline__ void stage_channels(T* dst, int slot, const T* src,
                                               long long chan_stride, long long off,
                                               int count, int nchan, int chan0, int tid) {
#if BTP_ABLATE != 2
  constexpr int nwarps = kThreads / 32;
  const int lane = tid & 31;
  const int first = ((tid >> 5) + nwarps - chan0 % nwarps) % nwarps;
  const T* base = src + off;
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(base) |
      static_cast<unsigned long long>(chan_stride) * sizeof(T) |
      static_cast<unsigned long long>(count) * sizeof(T);
  if ((bits & 15ull) == 0) {          // the aligned route: 16 bytes a copy
    constexpr int per16 = 16 / int(sizeof(T));
    for (int c = first; c < nchan; c += nwarps)
      for (int i = lane * per16; i < count; i += 32 * per16)
        cp_async_16(dst + c * slot + i, base + c * chan_stride + i);
  } else {                            // value by value: any address, any count
    for (int c = first; c < nchan; c += nwarps)
      for (int i = lane; i < count; i += 32)
        cp_async_value<int(sizeof(T))>(dst + c * slot + i, base + c * chan_stride + i);
  }
#endif
}

// BTP_ABLATE == 2 stages nothing: the stages are filled once, here.
template <typename T>
__device__ __forceinline__ void fill_stages(T* stages, int values, int tid) {
#if BTP_ABLATE == 2
  for (int t = tid; t < values; t += kThreads) stages[t] = T(1) + T(1e-3) * T(t & 63);
#endif
}

// One line of a 1-D pass: out(o) = sum_i src[i*sstride] * tab[i*t_in + o*t_out]
// for o < nout. With NIN > 0 the line sits in registers and both loops unroll.
template <typename T, int NIN, int NOUT, typename Out>
__device__ __forceinline__ void contract_line(const T* src, int sstride, int nin, int nout,
                                              const T* tab, int t_in, int t_out, Out out) {
  if constexpr (NIN > 0) {
    T r[NIN];
#pragma unroll
    for (int i = 0; i < NIN; ++i) r[i] = src[i * sstride];
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
#if BTP_ABLATE == 1
      out(o, r[o % NIN]);
#else
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < NIN; ++i) acc += r[i] * tab[i * t_in + o * t_out];
      out(o, acc);
#endif
    }
  } else {
    for (int o = 0; o < nout; ++o) {
#if BTP_ABLATE == 1
      out(o, src[(o % nin) * sstride]);
#else
      T acc = T(0);
      for (int i = 0; i < nin; ++i) acc += src[i * sstride] * tab[i * t_in + o * t_out];
      out(o, acc);
#endif
    }
  }
}

// Interpolation, pass 1 (along i): for each of `nchan` nodal channels staged
// at in[c*slot_n ..) and each line L = (element, j) of the tile,
//   tt[c][L][I] = sum_i in[c][L*n + i] psiq[i][I].
template <typename T, int NGL, int NQ>
__device__ __forceinline__ void interp_pass1(const T* in, int slot_n, int nchan, int g,
                                             T* tt, int tt_chan, const T* psiq, int n, int m,
                                             int tid) {
  const int lines = g * n;
  for (int t = tid; t < nchan * lines; t += kThreads) {
    const int c = t / lines, L = t - c * lines;
    T* dst = tt + c * tt_chan + L * m;
    contract_line<T, NGL, NQ>(in + c * slot_n + L * n, 1, n, m, psiq, m, 1,
                              [&](int I, T v) { dst[I] = v; });
  }
}

// Interpolation, pass 2 (along j): vq[c][element][J][I] = sum_j tt[c][(element, j)][I] psiq[j][J].
template <typename T, int NGL, int NQ>
__device__ __forceinline__ void interp_pass2(const T* tt, int tt_chan, int nchan, int g,
                                             T* vq, int slot_q, const T* psiq, int n, int m,
                                             int tid) {
  const int cols = g * m;
  for (int t = tid; t < nchan * cols; t += kThreads) {
    const int c = t / cols, r = t - c * cols;
    const int gg = r / m, I = r - gg * m;
    T* dst = vq + c * slot_q + gg * m * m + I;
    contract_line<T, NGL, NQ>(tt + c * tt_chan + gg * n * m + I, m, n, m, psiq, m, 1,
                              [&](int J, T v) { dst[J * m] = v; });
  }
}

// Scatter, pass 1 (along I) of the kFluxRows weighted flux rows
// f[r][element][J][I]: rows 0, 2, 4 (the ksi parts) go through dpsiq, rows
// 1, 3, 5 (the eta parts) and 6, 7 (the sources) through psiq:
//   tt[r][(element, J)][i] = sum_I f[r][(element, J)][I] tab_r[i][I].
template <typename T, int NGL, int NQ>
__device__ __forceinline__ void scatter_pass1(const T* f, int slot_q, int g, T* tt,
                                              int tt_chan, const T* psiq, const T* dpsiq,
                                              int n, int m, int tid) {
  const int lines = g * m;
  for (int t = tid; t < kFluxRows * lines; t += kThreads) {
    const int r = t / lines, L = t - r * lines;
    const T* tab = (r < 6 && (r & 1) == 0) ? dpsiq : psiq;
    T* dst = tt + r * tt_chan + L * n;
    contract_line<T, NQ, NGL>(f + r * slot_q + L * m, 1, m, n, tab, 1, m,
                              [&](int i, T v) { dst[i] = v; });
  }
}

// Scatter, pass 2 (along J), for the 3 channels:
//   rhs[c][element][j][i] = scale[j][i] * sum_J (tt[2c] (+ tt[5+c]))[(element, J)][i] psiq[j][J]
//                                              + tt[2c+1][(element, J)][i] dpsiq[j][J]
// written to global memory as one flat, coalesced run per channel,
// rhs[c*chan_stride + e0*npts ..); `scale` (shared memory, npts values) may
// be null. Here a thread owns one OUTPUT, not a line: a tile has only
// 3*G*ngl lines of this pass (60 at p=4, two warps' worth, each 27 loads and
// 90 multiply-adds long), and owning lines made this the longest phase of
// the tile (kernel 1 at 256x256: 0.549 ms with lines, 0.421 with outputs).
template <typename T, int NGL, int NQ>
__device__ __forceinline__ void scatter_pass2(const T* tt, int tt_chan, int g, const T* psiq,
                                              const T* dpsiq, const T* scale, T* rhs,
                                              long long chan_stride, long long e0, int n,
                                              int m, int tid) {
  const int npts = n * n, outs = g * npts;
  for (int t = tid; t < 3 * outs; t += kThreads) {
    const int c = t / outs, r = t - c * outs;
    const int gg = r / npts, nn = r - gg * npts;
    const int j = nn / n, i = nn - j * n;
    const T* p1 = tt + (2 * c) * tt_chan + gg * m * n + i;
    const T* p2 = p1 + tt_chan;
    const T* p3 = tt + (5 + c) * tt_chan + gg * m * n + i;
    const T* tp = psiq + j * m;
    const T* td = dpsiq + j * m;
#if BTP_ABLATE == 1
    T acc = p1[j * n] + p2[j * n];
#else
    T acc = T(0);
    const int mm = NQ > 0 ? NQ : m;
#pragma unroll
    for (int J = 0; J < mm; ++J) {
      const T a1 = c > 0 ? p1[J * n] + p3[J * n] : p1[J * n];
      acc += a1 * tp[J] + p2[J * n] * td[J];
    }
#endif
    rhs[c * chan_stride + e0 * npts + r] = scale ? scale[nn] * acc : acc;
  }
}

// Largest tile (4, 2 or 1 elements) whose shared memory fits the card's
// limit for one block; 0 when not even one element fits. `bytes_of(G)` is
// the kernel's own layout function.
template <typename BytesOf>
inline int pick_tile(BytesOf bytes_of, size_t limit) {
  for (int G = 4; G >= 1; G /= 2)
    if (bytes_of(G) <= limit) return G;
  return 0;
}

// the card's limit of dynamic shared memory for one block (sm_90)
constexpr size_t kSmemLimit = 232448;

// What a launch needs to know of its kernel: asked once for each kernel
// instantiation, device and shared-memory size (together with the block size,
// which is the kernel's own, they decide the occupancy) and then reused, since
// the solver launches 2*N_btp*kstages times per step with one size. The list
// is kept under a lock: host threads may launch side by side. `threads` is
// the block size the kernel is launched with: each kernel passes its own.
struct LaunchPlan {
  const void* kernel = nullptr;
  int device = -1;
  size_t smem = 0;
  int blocks_per_sm = 0;
  long long resident_blocks = 0;
};

template <typename Kernel>
cudaError_t plan_launch(Kernel kernel, int threads, size_t smem, LaunchPlan& plan) {
  static std::mutex lock;
  static std::vector<LaunchPlan> known;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(lock);
  for (const LaunchPlan& p : known)
    if (p.kernel == key && p.device == dev && p.smem == smem) {
      plan = p;
      return cudaSuccess;
    }
  // the limit, not `smem`: a later, smaller size must not lower what an
  // earlier plan of this kernel relies on
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kSmemLimit));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  plan.kernel = key;
  plan.device = dev;
  plan.smem = smem;
  plan.blocks_per_sm = per_sm;
  plan.resident_blocks = (long long)sms * per_sm;
  known.push_back(plan);
  return cudaSuccess;
}

}  // namespace btpvol
