// Fine-tile compositor K4: front-to-back Gaussian-splat blending per 8x16
// fine tile, over every fine tile of every instance.
//
// Replaces the TPU Pallas kernel K4 of the JAX package's
// renderer/fine_kernel.py (rasterize_fine_batch and _kernel). The fine
// binning cuts each splat at its 3-sigma rect of 8x16 tiles, so its pair
// table differs from the wide one's; the blend is K1's.
//
// Design: one CTA per (instance, fine tile), 128 threads with one pixel
// each, a fine tile f = ty * n_fine_x + tx at pixels [16 tx, 16 tx + 16) x
// [8 ty, 8 ty + 8). Pairs stream through shared memory in batches of 128,
// one coalesced load per attribute of the (10, P) table; the CTA stops
// once every pixel is saturated (__syncthreads_count). The per-batch blend
// is tile_blend.cuh's, instantiated for the 8x16 tile. What the TPU kernel
// does for its vector unit has no counterpart: eight streams walked in
// lockstep per program, their grouping by length and the scatter back to
// the image, the attribute-major packing with its matrix-unit expansion,
// the scalar-prefetch instance split and the DMA over-read pad.
//
// Bound: operations (~20 f32 operations and one expf per pixel and pair,
// on the non-tensor f32 pipe); a fine tile's pairs are read once from L2.
//
// Numerics: see tile_blend.cuh (no fast math, --fmad=false, expf).

#include <cuda_runtime.h>

#include "tile_blend.cuh"
#include "tile_composite.h"

namespace {

using namespace tile_blend;

__global__ void __launch_bounds__(kFineThreads)
fine_composite_kernel(const float* __restrict__ pairs, long long n_pairs,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends, int n_fine_x, int n_fine,
                      int h_pad, int w_pad, float bg0, float bg1, float bg2,
                      float* __restrict__ rgb, float* __restrict__ depth) {
  __shared__ float sh[kAttr][kFineThreads];

  const int g = blockIdx.x;                 // (instance, fine tile)
  const int inst = g / n_fine;
  const int t = g - inst * n_fine;
  const int ty = t / n_fine_x;
  const int tx = t - ty * n_fine_x;

  FinePixels p;
  init_pixels(p, tx, ty);
  blend_range(pairs, n_pairs, starts[g], ends[g], sh, p);
  store_pixels(p, inst, tx, ty, h_pad, w_pad, bg0, bg1, bg2, rgb, depth);
}

}  // namespace

extern "C" cudaError_t fine_composite_launch(
    const float* pairs, long long n_pairs, const int* starts, const int* ends,
    int n_inst, int n_fine_x, int n_tiles_y, float bg0, float bg1, float bg2,
    float* rgb, float* depth, cudaStream_t stream) {
  const int n_fine = n_fine_x * n_tiles_y;
  const long long blocks = (long long)n_inst * n_fine;
  if (blocks == 0) return cudaSuccess;
  fine_composite_kernel<<<(unsigned)blocks, kFineThreads, 0, stream>>>(
      pairs, n_pairs, starts, ends, n_fine_x, n_fine, n_tiles_y * kTileH,
      n_fine_x * kFineW, bg0, bg1, bg2, rgb, depth);
  return cudaGetLastError();
}
