// Front-to-back splat blending of one 8x128 tile: the per-thread pixel
// state and the per-batch blend shared by the tile compositors K1 and K7
// (tile_composite.cu), K2 (tile_sparse.cu) and K6 (tile_sparse_merge.cu),
// so they cannot drift apart. The backward K8 (tile_backward.cu) repeats
// the blend's tests in the same order to recompute T.
//
// Layout: one CTA of 256 threads per tile, each thread owning 4 pixels of
// one column (rows r, r+2, r+4, r+6), so every row store is 128 consecutive
// floats. A batch of up to 256 pairs sits in shared memory as
// structure-of-arrays, sh[attr][pair], attrs [x, y, conic a/b/c, opacity,
// r, g, b, depth].
//
// Numerics: build without --use_fast_math and with --fmad=false, and use
// expf: every comparison below (power <= 0, alpha >= 1/255, test_T < 1e-4,
// the T = 0.5 median-depth crossing) follows the TPU kernel's
// _composite_scoped operation for operation, so a contracted multiply-add
// or a fast exponential would flip pixels.

#pragma once

#include <cuda_runtime.h>

namespace tile_blend {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kBatch = 256;
constexpr int kPixPerThread = kTileH * kTileW / kThreads;   // 4
constexpr int kAttr = 10;
constexpr int kDepthAttr = 9;
constexpr float kAlphaMin = 0.003921568859368563f;          // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kDepthDefault = 15.0f;

// The 4 pixels one thread blends: column px, rows py[k].
struct Pixels {
  float px;
  float py[kPixPerThread];
  float T[kPixPerThread], Cr[kPixPerThread], Cg[kPixPerThread],
      Cb[kPixPerThread], D[kPixPerThread];
  bool done[kPixPerThread];
};

__device__ __forceinline__ void init_pixels(Pixels& p, int tx, int ty) {
  const int col = threadIdx.x % kTileW;
  const int row0 = threadIdx.x / kTileW;    // 0 or 1
  p.px = (float)(tx * kTileW + col);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    p.py[k] = (float)(ty * kTileH + row0 + 2 * k);
    p.T[k] = 1.0f;
    p.Cr[k] = 0.0f;
    p.Cg[k] = 0.0f;
    p.Cb[k] = 0.0f;
    p.D[k] = kDepthDefault;
    p.done[k] = false;
  }
}

// 1 while any of this thread's pixels can still take a contribution; a
// CTA stops once __syncthreads_count of it is 0 (the TPU kernel's
// while_loop condition).
__device__ __forceinline__ int any_live(const Pixels& p) {
  int live = 0;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) live |= !p.done[k];
  return live;
}

// Blend the first n pairs of the shared batch, in order, into p.
__device__ __forceinline__ void blend_batch(const float (*sh)[kBatch], int n,
                                            Pixels& p) {
  for (int j = 0; j < n; ++j) {
    const float gx = sh[0][j], gy = sh[1][j];
    const float ca = sh[2][j], cb = sh[3][j], cc = sh[4][j];
    const float op = sh[5][j];
    const float r = sh[6][j], gg = sh[7][j], b = sh[8][j];
    const float dep = sh[9][j];
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const float dx = gx - p.px;
      const float dy = gy - p.py[k];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      float alpha = fminf(kAlphaMax, op * expf(power));
      if (!(power <= 0.0f)) alpha = 0.0f;
      const bool alpha_ok = alpha >= kAlphaMin;
      const float test_T = p.T[k] * (1.0f - alpha);
      const bool would_done = alpha_ok && (test_T < kTEps);
      const bool contrib = alpha_ok && !would_done && !p.done[k];
      if (contrib) {
        const float aT = alpha * p.T[k];
        p.Cr[k] = p.Cr[k] + aT * r;
        p.Cg[k] = p.Cg[k] + aT * gg;
        p.Cb[k] = p.Cb[k] + aT * b;
        if (p.T[k] > 0.5f && test_T < 0.5f) p.D[k] = dep;
        p.T[k] = test_T;
      }
      p.done[k] = p.done[k] || would_done;
    }
  }
}

// Blend the contiguous pair range [start, end) of a (10, n_pairs) table,
// batch by batch, stopping once every pixel of the tile is done.
__device__ __forceinline__ void blend_range(const float* __restrict__ pairs,
                                            long long n_pairs, int start,
                                            int end, float (*sh)[kBatch],
                                            Pixels& p) {
  const int tid = threadIdx.x;
  for (int base = start; base < end; base += kBatch) {
    // also the barrier that retires the previous batch's shared reads
    if (__syncthreads_count(any_live(p)) == 0) break;
    const int n = min(kBatch, end - base);
    if (tid < n) {
#pragma unroll
      for (int a = 0; a < kAttr; ++a)
        sh[a][tid] = pairs[(long long)a * n_pairs + base + tid];
    }
    __syncthreads();
    blend_batch(sh, n, p);
  }
}

// out = C + T * bg and the median depth, into instance inst's frame; the
// final transmittance T too where t_fin is not null (K7).
__device__ __forceinline__ void store_pixels(const Pixels& p, int inst,
                                             int tx, int ty, int h_pad,
                                             int w_pad, float bg0, float bg1,
                                             float bg2, float* rgb,
                                             float* depth,
                                             float* t_fin = nullptr) {
  const int col = threadIdx.x % kTileW;
  const int row0 = threadIdx.x / kTileW;
  const long long plane = (long long)h_pad * w_pad;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const long long pix =
        (long long)(ty * kTileH + row0 + 2 * k) * w_pad + tx * kTileW + col;
    float* out = rgb + (long long)inst * 3 * plane + pix;
    out[0] = p.Cr[k] + p.T[k] * bg0;
    out[plane] = p.Cg[k] + p.T[k] * bg1;
    out[2 * plane] = p.Cb[k] + p.T[k] * bg2;
    depth[(long long)inst * plane + pix] = p.D[k];
    if (t_fin) t_fin[(long long)inst * plane + pix] = p.T[k];
  }
}

}  // namespace tile_blend
