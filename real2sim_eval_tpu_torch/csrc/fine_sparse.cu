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
// body (tile_blend.cuh at 8x16) and writes its fine tile into frames that
// the wrapper has filled with a copy of the cached static frames. The TPU
// kernel visits all 8 fine tiles of a dirty 8x128 supertile and passes the
// clean ones' cached pixels through; the list here is exact (every fine
// tile with a dynamic pair, nothing else), so clean fine tiles are never
// touched and there are no sentinel ids or junk rows. An entry whose
// instance or fine tile id lies outside the frames is skipped rather than
// written out of bounds.
//
// Bound: as K4, operations; on the same pair range K5 is bitwise K4.

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
                   const int* __restrict__ ends, int n_inst, int n_fine_x,
                   int n_fine, int h_pad, int w_pad, float bg0, float bg1,
                   float bg2, float* __restrict__ rgb,
                   float* __restrict__ depth) {
  __shared__ float sh[kAttr][kFineThreads];

  const int k = blockIdx.x;                 // dirty-list entry
  const int inst = inst_ids[k];
  const int t = tile_ids[k];
  if (inst < 0 || inst >= n_inst || t < 0 || t >= n_fine) return;
  const int ty = t / n_fine_x;
  const int tx = t - ty * n_fine_x;

  FinePixels p;
  init_pixels(p, tx, ty);
  blend_range(pairs, n_pairs, starts[k], ends[k], sh, p);
  store_pixels(p, inst, tx, ty, h_pad, w_pad, bg0, bg1, bg2, rgb, depth);
}

}  // namespace

extern "C" cudaError_t fine_sparse_launch(
    const float* pairs, long long n_pairs, const int* inst_ids,
    const int* tile_ids, const int* starts, const int* ends, int n_dirty,
    int n_inst, int n_fine_x, int n_tiles_y, float bg0, float bg1, float bg2,
    float* rgb, float* depth, cudaStream_t stream) {
  if (n_dirty == 0) return cudaSuccess;
  fine_sparse_kernel<<<(unsigned)n_dirty, kFineThreads, 0, stream>>>(
      pairs, n_pairs, inst_ids, tile_ids, starts, ends, n_inst, n_fine_x,
      n_fine_x * n_tiles_y, n_tiles_y * kTileH, n_fine_x * kFineW, bg0, bg1,
      bg2, rgb, depth);
  return cudaGetLastError();
}
