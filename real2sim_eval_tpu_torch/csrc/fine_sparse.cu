// Fine dirty-tile compositor K5: K4's blend over the dirty fine tiles of a
// step only.
//
// Replaces the TPU Pallas kernel K5 (the JAX package's renderer/
// incremental_fine.py: rasterize_fine_sparse and _kernel_sparse_fine).
//
// Design: one CTA of 128 threads per entry of a flat list of the step's
// dirty (instance, fine tile) pairs, each with its range [start, end) in
// the merged pair table (the fine tile's static and dynamic pairs in one
// depth order, built by renderer/incremental_fine.py). The CTA runs K4's
// body (fine_composite.cu: a 4x8 quadrant a warp, each warp walking the
// range on its own through its cp.async double buffer with the exact
// per-quadrant cull, bitwise the unculled walk) and writes its fine tile
// into frames that the wrapper has filled with a copy of the cached static
// frames. CTAs take the entries longest first (``order``, from the
// wrapper). The TPU kernel visits all 8 fine tiles of a dirty 8x128
// supertile and passes the clean ones' cached pixels through; the list
// here is exact (every fine tile with a dynamic pair, nothing else), so
// clean fine tiles are never touched and there are no sentinel ids or
// junk rows. An entry whose instance or fine tile id lies
// outside the frames is skipped rather than written out of bounds.
//
// Bound: as K4, instruction throughput. A dirty fine tile holds ~1,760
// merged pairs at the flagship (the static table's splats saturate late),
// of which a quadrant keeps about a quarter as many (pixel, pair)
// evaluations as the whole fine tile's walk; what remains is the pair
// table's bytes.

#include <cuda_runtime.h>

#include "tile_blend.cuh"
#include "tile_composite.h"

namespace {

using namespace tile_blend;

__global__ void __launch_bounds__(kFineThreads)
fine_sparse_kernel(const float* __restrict__ pairs, long long n_pairs,
                   const int* __restrict__ inst_ids,
                   const int* __restrict__ tile_ids,
                   const int* __restrict__ starts,
                   const int* __restrict__ ends,
                   const int* __restrict__ order, int n_inst, int n_fine_x,
                   int n_fine, int h_pad, int w_pad, float bg0, float bg1,
                   float bg2, float* __restrict__ rgb,
                   float* __restrict__ depth) {
  // each warp's two batch buffers (walk_fine)
  __shared__ __align__(16) float sh[kFineThreads / 32][2][kWarpBatch * kSlot];

  const int k = order[blockIdx.x];          // dirty-list entry
  const int inst = inst_ids[k];
  const int t = tile_ids[k];
  if (inst < 0 || inst >= n_inst || t < 0 || t >= n_fine) return;
  const int ty = t / n_fine_x;
  const int tx = t - ty * n_fine_x;

  QuadPixel p;
  init_pixels(p, tx, ty);
  walk_fine(pairs, n_pairs, starts[k], ends[k], sh[threadIdx.x / 32], p,
            (float)quad_x0(tx), (float)quad_y0(ty));
  store_pixels(p, inst, h_pad, w_pad, bg0, bg1, bg2, rgb, depth);
}

}  // namespace

extern "C" cudaError_t fine_sparse_launch(
    const float* pairs, long long n_pairs, const int* inst_ids,
    const int* tile_ids, const int* starts, const int* ends, const int* order,
    int n_dirty, int n_inst, int n_fine_x, int n_tiles_y, float bg0,
    float bg1, float bg2, float* rgb, float* depth, cudaStream_t stream) {
  if (n_dirty == 0) return cudaSuccess;
  fine_sparse_kernel<<<(unsigned)n_dirty, kFineThreads, 0, stream>>>(
      pairs, n_pairs, inst_ids, tile_ids, starts, ends, order, n_inst,
      n_fine_x, n_fine_x * n_tiles_y, n_tiles_y * kTileH, n_fine_x * kFineW,
      bg0, bg1, bg2, rgb, depth);
  return cudaGetLastError();
}
