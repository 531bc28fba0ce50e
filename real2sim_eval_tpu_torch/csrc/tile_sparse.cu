// Dirty-tile compositor K2: K1's blend over the dirty tiles of a step only.
//
// Replaces the TPU Pallas kernel K2 (the JAX package's renderer/
// tile_kernel.py: rasterize_tiles_sparse and _kernel_sparse).
//
// Design: one CTA of 256 threads per entry of a flat list of the step's
// dirty (instance, tile) pairs, each with its range [start, end) in the
// merged pair table (static and dynamic pairs of the tile in one depth
// order, built by renderer/incremental.py). The CTA runs K1's body
// (tile_composite.cu): warp w owns the 8x16 block of columns [16 w, 16 w +
// 16) of the tile (tile_blend.cuh WarpPixels), pairs stream through two
// shared buffers in batches of 256 by cp.async, and each warp blends only
// the pairs of a landed batch that pass the exact block cull (block_keep),
// so the frames are bitwise the unculled walk's and, on the same pair
// range, K1's. It writes its tile into frames that the wrapper has filled
// with a copy of the cached static frames; clean tiles are never touched.
// The list is exact (every tile with a dynamic pair, nothing else), so the
// TPU kernel's sentinel ids and junk tile row have no counterpart here. An
// entry whose instance or tile id lies outside the frames is skipped rather
// than written out of bounds.
//
// Bound: as K1. A dirty tile holds ~3,800 merged pairs at the flagship (the
// thin table splats saturate late) of which few reach any one 8x16 block:
// the cull brings the evaluations from every pair of the tile's range to
// the pairs that reach each block, plus one block test per (warp, pair);
// what remains is the pair table's bytes.

#include <cuda_runtime.h>

#include "tile_blend.cuh"
#include "tile_composite.h"

namespace {

using namespace tile_blend;

// at most 64 registers: four CTAs an SM
__global__ void __launch_bounds__(kThreads, 4)
tile_sparse_kernel(const float* __restrict__ pairs, long long n_pairs,
                   const int* __restrict__ inst_ids,
                   const int* __restrict__ tile_ids,
                   const int* __restrict__ starts,
                   const int* __restrict__ ends, int n_inst, int n_tiles_x,
                   int n_tiles, int h_pad, int w_pad, float bg0, float bg1,
                   float bg2, float* __restrict__ rgb,
                   float* __restrict__ depth) {
  __shared__ float sh[2][kAttr][kBatch];

  const int k = blockIdx.x;                 // dirty-list entry
  const int inst = inst_ids[k];
  const int t = tile_ids[k];
  if (inst < 0 || inst >= n_inst || t < 0 || t >= n_tiles) return;
  const int ty = t / n_tiles_x;
  const int tx = t - ty * n_tiles_x;

  WarpPixels p;
  init_pixels(p, tx, ty);
  blend_range_culled(pairs, n_pairs, starts[k], ends[k], sh, p,
                     (float)(tx * kTileW + (threadIdx.x / 32) * kBlockW),
                     (float)(ty * kTileH));
  store_pixels(p, inst, tx, ty, h_pad, w_pad, bg0, bg1, bg2, rgb, depth);
}

}  // namespace

extern "C" cudaError_t tile_sparse_launch(
    const float* pairs, long long n_pairs, const int* inst_ids,
    const int* tile_ids, const int* starts, const int* ends, int n_dirty,
    int n_inst, int n_tiles_x, int n_tiles_y, float bg0, float bg1,
    float bg2, float* rgb, float* depth, cudaStream_t stream) {
  if (n_dirty == 0) return cudaSuccess;
  tile_sparse_kernel<<<(unsigned)n_dirty, kThreads, 0, stream>>>(
      pairs, n_pairs, inst_ids, tile_ids, starts, ends, n_inst, n_tiles_x,
      n_tiles_x * n_tiles_y, n_tiles_y * kTileH, n_tiles_x * kTileW, bg0,
      bg1, bg2, rgb, depth);
  return cudaGetLastError();
}
