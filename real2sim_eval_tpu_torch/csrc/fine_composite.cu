// Fine-tile compositor K4: front-to-back Gaussian-splat blending per 8x16
// fine tile, over every fine tile of every instance.
//
// Replaces the TPU Pallas kernel K4 of the JAX package's
// renderer/fine_kernel.py (rasterize_fine_batch and _kernel). The fine
// binning cuts each splat at its 3-sigma rect of 8x16 tiles, so its pair
// table differs from the wide one's; the blend is K1's.
//
// Design: one CTA of 128 threads per (instance, fine tile), a fine tile f
// = ty * n_fine_x + tx at pixels [16 tx, 16 tx + 16) x [8 ty, 8 ty + 8);
// warp w owns the 4x8 quadrant (w % 2, w / 2), one pixel a lane
// (tile_blend.cuh QuadPixel), and walks the tile's pair range on its own
// (walk_fine): batches of 32 pairs, one a lane, arrive by cp.async from
// the structure-of-arrays pair table (10, P) into the warp's two shared
// buffers, batch n + 1 loading while batch n blends; each lane tests its
// pair against the quadrant with K1's exact conic cull (tile_blend.cuh
// block_keep on a 4x8 box), and the warp blends only the kept pairs in
// order. The fine binning does not cull by the conic (its tables hold
// every pair whose 3-sigma rect overlaps the fine tile, as the JAX
// binner's do): at the flagship's wrist the quadrants take about half of
// the (pixel, pair) evaluations a whole fine tile would, 8x16 boxes 83 %,
// 2x16 strips 65 % (chip_smoke.py fine_kernel_inputs). A pair a warp skips
// cannot pass power <= 0 and alpha >= 1/255 at any pixel of its quadrant,
// so the frames are bitwise those of the unculled walk and of the plain
// version. A warp stops once its pixels are all done; no barrier ties the
// four warps, so a quadrant that keeps more pairs holds up no other (each
// warp reads the tile's pairs itself: four reads from L1 and L2, one from
// device memory). CTAs take the fine tiles longest first (``order``, from
// the wrapper): the wrist's fine tiles hold 240 pairs on average and up
// to ~3,100. What the TPU kernel does for its vector unit has no
// counterpart: eight streams walked in lockstep per program, their
// grouping by length and the scatter back to the image, the
// attribute-major packing with its matrix-unit expansion, the
// scalar-prefetch instance split and the DMA over-read pad.
//
// Bound: the roofline's is bytes (the pair table read once, the frames
// written once); the kernel is bound by instruction throughput instead:
// one pixel a lane costs ~60 warp instructions per kept (quadrant, pair),
// the blend's ~45 with an accurate expf and no contracted multiply-adds,
// three broadcast loads and the walk's bookkeeping. The cull cuts the
// evaluations; nothing cheaper per evaluation keeps the frames bitwise.
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
                      const int* __restrict__ ends,
                      const int* __restrict__ order, int n_fine_x,
                      int n_fine, int h_pad, int w_pad, float bg0, float bg1,
                      float bg2, float* __restrict__ rgb,
                      float* __restrict__ depth) {
  // each warp's two batch buffers (walk_fine)
  __shared__ __align__(16) float sh[kFineThreads / 32][2][kWarpBatch * kSlot];

  const int g = order[blockIdx.x];          // (instance, fine tile)
  const int inst = g / n_fine;
  const int t = g - inst * n_fine;
  const int ty = t / n_fine_x;
  const int tx = t - ty * n_fine_x;

  QuadPixel p;
  init_pixels(p, tx, ty);
  walk_fine(pairs, n_pairs, starts[g], ends[g], sh[threadIdx.x / 32], p,
            (float)quad_x0(tx), (float)quad_y0(ty));
  store_pixels(p, inst, h_pad, w_pad, bg0, bg1, bg2, rgb, depth);
}

}  // namespace

extern "C" cudaError_t fine_composite_launch(
    const float* pairs, long long n_pairs, const int* starts, const int* ends,
    const int* order, int n_inst, int n_fine_x, int n_tiles_y, float bg0,
    float bg1, float bg2, float* rgb, float* depth, cudaStream_t stream) {
  const int n_fine = n_fine_x * n_tiles_y;
  const long long blocks = (long long)n_inst * n_fine;
  if (blocks == 0) return cudaSuccess;
  fine_composite_kernel<<<(unsigned)blocks, kFineThreads, 0, stream>>>(
      pairs, n_pairs, starts, ends, order, n_fine_x, n_fine,
      n_tiles_y * kTileH, n_fine_x * kFineW, bg0, bg1, bg2, rgb, depth);
  return cudaGetLastError();
}
