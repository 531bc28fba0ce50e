// Tile compositors K1 and K7: front-to-back Gaussian-splat blending per
// 8x128 tile.
//
// Replaces two TPU Pallas kernels of the JAX package's
// renderer/tile_kernel.py: K1 (rasterize_tiles_batch, _kernel and
// _composite_scoped) and K7 (rasterize_tiles_batch_t, _kernel_t), which is
// K1 writing the final transmittance as well, the residual of the
// differentiable render's backward (tile_backward.cu).
//
// Design: one CTA of 256 threads per (instance, 8x128 tile), as renderCUDA
// assigns one block per tile; warp w owns the 8x16 block of columns
// [16 w, 16 w + 16), 4 pixels a lane (tile_blend.cuh WarpPixels). Pairs
// stream through two shared buffers in batches of 256, batch n + 1 loading
// by cp.async from the structure-of-arrays pair table (10, P) while batch
// n blends. Each warp tests a landed batch against its block with the
// binning's exact conic cull and a margin derived for bitwise exactness
// (tile_blend.cuh block_keep), then blends only the kept pairs in order:
// a pair it skips cannot pass power <= 0 and alpha >= 1/255 at any pixel
// of the block, so every pixel's sequence of state changes is the one of
// the unculled walk and the frames are bitwise those of the plain version.
// A warp whose pixels are all saturated skips the test and the blend; the
// CTA stops once every pixel of its tile is (__syncthreads_count over the
// live pixels), exactly where the TPU kernel's while_loop stops. The
// per-(pixel, pair) step is tile_blend.cuh's blend_pixel, shared with K2,
// K6, K4 and K5; K7 is this kernel with a T plane, so its rgb and depth are
// K1's bitwise.
//
// Bound: ~20 f32 operations per (pixel, pair) evaluation with one expf, on
// the non-tensor f32 pipe; the cull brings the evaluations from every pair
// of the 8x128 tile's range to the pairs that reach each 8x16 block (the
// wrist's tables keep ~1/4 of them), plus one block test per (warp, pair).
// The 8x128 gating is part of the semantics (a gaussian only reaches the
// tiles of its 3-sigma rect), so the tile shape is kept from the TPU
// design; the cull only skips work.
//
// Numerics: see tile_blend.cuh (no fast math, --fmad=false, expf).

#include <cuda_runtime.h>

#include "tile_blend.cuh"
#include "tile_composite.h"

namespace {

using namespace tile_blend;

// at most 64 registers: four CTAs an SM
__global__ void __launch_bounds__(kThreads, 4)
tile_composite_kernel(const float* __restrict__ pairs, long long n_pairs,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends, int n_tiles_x,
                      int n_tiles, int h_pad, int w_pad, float bg0,
                      float bg1, float bg2, float* __restrict__ rgb,
                      float* __restrict__ depth, float* __restrict__ t_fin) {
  __shared__ float sh[2][kAttr][kBatch];

  const int g = blockIdx.x;                 // (instance, tile)
  const int inst = g / n_tiles;
  const int t = g - inst * n_tiles;
  const int ty = t / n_tiles_x;
  const int tx = t - ty * n_tiles_x;

  WarpPixels p;
  init_pixels(p, tx, ty);
  blend_range_culled(pairs, n_pairs, starts[g], ends[g], sh, p,
                     (float)(tx * kTileW + (threadIdx.x / 32) * kBlockW),
                     (float)(ty * kTileH));
  store_pixels(p, inst, tx, ty, h_pad, w_pad, bg0, bg1, bg2, rgb, depth,
               t_fin);
}

cudaError_t launch(const float* pairs, long long n_pairs, const int* starts,
                   const int* ends, int n_inst, int n_tiles_x, int n_tiles_y,
                   float bg0, float bg1, float bg2, float* rgb, float* depth,
                   float* t_fin, cudaStream_t stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  const long long blocks = (long long)n_inst * n_tiles;
  if (blocks == 0) return cudaSuccess;
  tile_composite_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      pairs, n_pairs, starts, ends, n_tiles_x, n_tiles, n_tiles_y * kTileH,
      n_tiles_x * kTileW, bg0, bg1, bg2, rgb, depth, t_fin);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t tile_composite_launch(
    const float* pairs, long long n_pairs, const int* starts, const int* ends,
    int n_inst, int n_tiles_x, int n_tiles_y, float bg0, float bg1, float bg2,
    float* rgb, float* depth, cudaStream_t stream) {
  return launch(pairs, n_pairs, starts, ends, n_inst, n_tiles_x, n_tiles_y,
                bg0, bg1, bg2, rgb, depth, nullptr, stream);
}

extern "C" cudaError_t tile_composite_t_launch(
    const float* pairs, long long n_pairs, const int* starts, const int* ends,
    int n_inst, int n_tiles_x, int n_tiles_y, float bg0, float bg1, float bg2,
    float* rgb, float* depth, float* t_fin, cudaStream_t stream) {
  return launch(pairs, n_pairs, starts, ends, n_inst, n_tiles_x, n_tiles_y,
                bg0, bg1, bg2, rgb, depth, t_fin, stream);
}
