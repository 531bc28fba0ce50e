// Tile compositor: front-to-back Gaussian-splat blending per 8x128 tile.
//
// Replaces the TPU Pallas kernel K1 (the JAX package's renderer/
// tile_kernel.py: rasterize_tiles_batch, _kernel and _composite_scoped).
//
// Design: one CTA per (instance, 8x128 tile), as renderCUDA assigns one
// block per tile; 256 threads, each owning 4 pixels of one column (rows
// r, r+2, r+4, r+6), so every row store is 128 consecutive floats. Pairs
// stream through shared memory in batches of 256, loaded cooperatively from
// the structure-of-arrays pair table (10, P): one coalesced load per
// attribute. A CTA stops once every pixel of its tile is saturated
// (__syncthreads_count over the live pixels), exactly where the TPU kernel's
// while_loop stops.
//
// Bound: the inner loop is ~20 f32 operations per (pixel, pair) with one
// expf, so the kernel is bound by operations on the non-tensor f32 pipe;
// the pair table is read once per tile from L2. The 8x128 gating is part of
// the semantics (a gaussian only reaches the tiles of its 3-sigma rect), so
// the tile shape is kept from the TPU design rather than chosen for speed.
//
// Numerics: build without --use_fast_math and with --fmad=false, and use
// expf: every comparison below (alpha >= 1/255, test_T < 1e-4, the T = 0.5
// median-depth crossing) follows _composite_scoped operation for operation,
// so a contracted multiply-add or a fast exponential would flip pixels.

#include <cuda_runtime.h>

#include "tile_composite.h"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kBatch = 256;
constexpr int kPixPerThread = kTileH * kTileW / kThreads;   // 4
constexpr int kAttr = 10;
constexpr float kAlphaMin = 0.003921568859368563f;          // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kDepthDefault = 15.0f;

__global__ void __launch_bounds__(kThreads)
tile_composite_kernel(const float* __restrict__ pairs, long long n_pairs,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends, int n_tiles_x,
                      int n_tiles, int h_pad, int w_pad, float bg0,
                      float bg1, float bg2, float* __restrict__ rgb,
                      float* __restrict__ depth) {
  __shared__ float sh[kAttr][kBatch];

  const int g = blockIdx.x;                 // (instance, tile)
  const int inst = g / n_tiles;
  const int t = g - inst * n_tiles;
  const int ty = t / n_tiles_x;
  const int tx = t - ty * n_tiles_x;
  const int tid = threadIdx.x;
  const int col = tid % kTileW;
  const int row0 = tid / kTileW;            // 0 or 1

  const float px = (float)(tx * kTileW + col);
  float py[kPixPerThread];
  float T[kPixPerThread], Cr[kPixPerThread], Cg[kPixPerThread],
      Cb[kPixPerThread], D[kPixPerThread];
  bool done[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    py[k] = (float)(ty * kTileH + row0 + 2 * k);
    T[k] = 1.0f;
    Cr[k] = 0.0f;
    Cg[k] = 0.0f;
    Cb[k] = 0.0f;
    D[k] = kDepthDefault;
    done[k] = false;
  }

  const int start = starts[g];
  const int end = ends[g];
  for (int base = start; base < end; base += kBatch) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) live |= !done[k];
    // also the barrier that retires the previous batch's shared reads
    if (__syncthreads_count(live) == 0) break;
    const int n = min(kBatch, end - base);
    if (tid < n) {
#pragma unroll
      for (int a = 0; a < kAttr; ++a)
        sh[a][tid] = pairs[(long long)a * n_pairs + base + tid];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float gx = sh[0][j], gy = sh[1][j];
      const float ca = sh[2][j], cb = sh[3][j], cc = sh[4][j];
      const float op = sh[5][j];
      const float r = sh[6][j], gg = sh[7][j], b = sh[8][j];
      const float dep = sh[9][j];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float dx = gx - px;
        const float dy = gy - py[k];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        float alpha = fminf(kAlphaMax, op * expf(power));
        if (!(power <= 0.0f)) alpha = 0.0f;
        const bool alpha_ok = alpha >= kAlphaMin;
        const float test_T = T[k] * (1.0f - alpha);
        const bool would_done = alpha_ok && (test_T < kTEps);
        const bool contrib = alpha_ok && !would_done && !done[k];
        if (contrib) {
          const float aT = alpha * T[k];
          Cr[k] = Cr[k] + aT * r;
          Cg[k] = Cg[k] + aT * gg;
          Cb[k] = Cb[k] + aT * b;
          if (T[k] > 0.5f && test_T < 0.5f) D[k] = dep;
          T[k] = test_T;
        }
        done[k] = done[k] || would_done;
      }
    }
  }

  const long long plane = (long long)h_pad * w_pad;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const long long pix =
        (long long)(ty * kTileH + row0 + 2 * k) * w_pad + tx * kTileW + col;
    float* out = rgb + (long long)inst * 3 * plane + pix;
    out[0] = Cr[k] + T[k] * bg0;
    out[plane] = Cg[k] + T[k] * bg1;
    out[2 * plane] = Cb[k] + T[k] * bg2;
    depth[(long long)inst * plane + pix] = D[k];
  }
}

}  // namespace

extern "C" cudaError_t tile_composite_launch(
    const float* pairs, long long n_pairs, const int* starts, const int* ends,
    int n_inst, int n_tiles_x, int n_tiles_y, float bg0, float bg1, float bg2,
    float* rgb, float* depth, cudaStream_t stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  const long long blocks = (long long)n_inst * n_tiles;
  if (blocks == 0) return cudaSuccess;
  tile_composite_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      pairs, n_pairs, starts, ends, n_tiles_x, n_tiles, n_tiles_y * kTileH,
      n_tiles_x * kTileW, bg0, bg1, bg2, rgb, depth);
  return cudaGetLastError();
}
