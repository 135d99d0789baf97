// Code shared by the face and update kernels of the fused barotropic stage
// (btp_faces.cu, btp_update.cu), CUDA C++ for sm_90a (NVIDIA Hopper): the
// tile, the staging of a tile's inputs into a ring of shared-memory stages,
// and the choice of the tile.
//
// The tile. A block works `G` consecutive faces (F) or elements (U) at a
// time. In the flat layouts (C, F, row) and (C, E, row) the G units of one
// channel are ONE contiguous run of G*row values, so a tile's input is a few
// dozen contiguous runs. With G a multiple of 4 every run of a tile is a
// whole number of 16-byte pieces in f32 (4 faces x 5 nodes x 4 B = 80 B,
// 4 x 9 quad points = 144 B, 4 elements x 25 nodes = 400 B, 4 x 20 edge
// slots = 320 B).
//
// The ring. Every global input of a tile, the accumulators' old values
// included, is copied into a stage of shared memory with cp.async, one
// commit group per tile (empty past the last tile), and the copies of tile
// t+1 are in flight while tile t is computed. A run is copied in 16-byte
// pieces when its two addresses and its length are multiples of 16 bytes
// (for full tiles when the face or element count is a multiple of 4), else
// value by value (4 or 8 bytes): the ragged last tile and counts that are no
// multiple of 4 take that route. Both routes are chosen per run, at run
// time, from the addresses themselves. The cp.async primitives, the slot
// rounding and the launch plan are the volume kernels'
// (btp_volume_common.cuh); the staging loop here is the kernel's own: it
// takes the kernel's block size as a template argument, and spreads the
// pieces of all runs of a tile over all threads.
//
// BTP_ABLATE builds a variant that is only timed (chip_smoke.py,
// hnumo_tpu_torch/tools/kernel_ablation.py): 1 compiles the contractions out
// (each kernel says which; memory-only time), 2 replaces every global read by
// a value computed from the index, written into the stages once per block
// (compute-only time). Both compute wrong numbers on purpose; the package's
// wrappers never build them.

#pragma once

#include "btp_volume_common.cuh"

namespace btptail {

using btpvol::cp_async_16;
using btpvol::cp_async_commit;
using btpvol::cp_async_value;
using btpvol::cp_async_wait;
using btpvol::kSmemLimit;
using btpvol::kStages;
using btpvol::LaunchPlan;
using btpvol::plan_launch;
using btpvol::slot_values;

// Shared memory of one block that still lets `blocks` blocks share an SM
// (228 KB an SM, 1 KB of it reserved for each block): the tile shrinks
// towards it.
constexpr size_t tile_budget(int blocks) { return 233472 / blocks - 1024; }

// Start the copy of `nchan` channels of one array into consecutive slots of a
// stage: channel c is the run src[c*chan_stride + off .. + count) ->
// dst[c*slot ..). The pieces of all channels are one flat range over the
// block's THREADS threads; `rot` (the pieces staged before this array, for
// this tile) turns the starting thread, so that the arrays of one tile
// spread evenly over the block.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_runs(T* dst, int slot, const T* src, long long chan_stride,
                                           long long off, int count, int nchan, int tid,
                                           int& rot) {
#if BTP_ABLATE != 2
  const T* base = src + off;
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(base) |
      static_cast<unsigned long long>(chan_stride) * sizeof(T) |
      static_cast<unsigned long long>(count) * sizeof(T);
  const int first = (tid + THREADS - rot % THREADS) % THREADS;
  if ((bits & 15ull) == 0) {          // the aligned route: 16 bytes a copy
    constexpr int per16 = 16 / int(sizeof(T));
    const int pieces = count / per16;
    for (int t = first; t < nchan * pieces; t += THREADS) {
      const int c = t / pieces, i = (t - c * pieces) * per16;
      cp_async_16(dst + c * slot + i, base + c * chan_stride + i);
    }
    rot += nchan * pieces;
  } else {                            // value by value: any address, any count
    for (int t = first; t < nchan * count; t += THREADS) {
      const int c = t / count, i = t - c * count;
      cp_async_value<int(sizeof(T))>(dst + c * slot + i, base + c * chan_stride + i);
    }
    rot += nchan * count;
  }
#endif
}

// BTP_ABLATE == 2 stages nothing: the stages are filled once, here, with
// values in [1, 1.063] (no division by zero in the pointwise physics).
template <int THREADS, typename T>
__device__ __forceinline__ void fill_stages(T* stages, int values, int tid) {
#if BTP_ABLATE == 2
  for (int t = tid; t < values; t += THREADS) stages[t] = T(1) + T(1e-3) * T(t & 63);
#endif
}

// Faces or elements per tile: `most` (a multiple of 4), halved while the
// block's shared memory exceeds tile_budget(blocks) and the half is at
// least 4, then below that only where the card's limit for one block forces
// it. 0 when not even one unit fits that limit. `bytes_of(G)` is the
// kernel's own layout.
template <typename BytesOf>
inline int pick_tile(BytesOf bytes_of, int most, int blocks) {
  int G = most;
  while (G >= 8 && bytes_of(G) > tile_budget(blocks)) G /= 2;
  while (G >= 1 && bytes_of(G) > kSmemLimit) G /= 2;
  return G;
}

}  // namespace btptail
