// Front-to-back splat blending of one tile, 8 rows high: the per-thread
// pixel state and the per-batch blend shared by the wide (8x128) tile
// compositors K1 and K7 (tile_composite.cu), K2 (tile_sparse.cu) and K6
// (tile_sparse_merge.cu), and the fine (8x16) compositors K4
// (fine_composite.cu) and K5 (fine_sparse.cu), so they cannot drift apart.
// The backward K8 (tile_backward.cu) repeats the blend's tests in the same
// order to recompute T.
//
// Layout: one CTA of NT threads per tile of width TW, each thread owning
// the pixels of one column at rows row0, row0 + NT/TW, ... (row0 =
// tid / TW), so every row store is TW consecutive floats. The wide tile
// takes 256 threads with 4 pixels each (rows r, r+2, r+4, r+6), the fine
// tile 128 threads with one pixel each. A batch of up to NT pairs sits in
// shared memory as structure-of-arrays, sh[attr][pair], attrs [x, y, conic
// a/b/c, opacity, r, g, b, depth].
//
// Numerics: build without --use_fast_math and with --fmad=false, and use
// expf: every comparison below (power <= 0, alpha >= 1/255, test_T < 1e-4,
// the T = 0.5 median-depth crossing) follows the TPU kernels'
// _composite_scoped (and fine_kernel._kernel) operation for operation, so
// a contracted multiply-add or a fast exponential would flip pixels.

#pragma once

#include <cuda_runtime.h>

namespace tile_blend {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kBatch = 256;
constexpr int kPixPerThread = kTileH * kTileW / kThreads;   // 4
constexpr int kFineW = 16;
constexpr int kFineThreads = 128;                           // 1 pixel each
constexpr int kAttr = 10;
constexpr int kDepthAttr = 9;
constexpr float kAlphaMin = 0.003921568859368563f;          // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kDepthDefault = 15.0f;

// The pixels one of NT threads blends in a kTileH x TW tile: column px,
// rows py[k].
template <int TW, int NT>
struct PixelsT {
  static constexpr int kPix = kTileH * TW / NT;
  static constexpr int kRowStep = NT / TW;
  static_assert(NT % TW == 0 && kTileH % kRowStep == 0,
                "a thread owns whole rows of one column");
  float px;
  float py[kPix];
  float T[kPix], Cr[kPix], Cg[kPix], Cb[kPix], D[kPix];
  bool done[kPix];
};

using Pixels = PixelsT<kTileW, kThreads>;          // K1, K2, K6, K7, K8
using FinePixels = PixelsT<kFineW, kFineThreads>;  // K4, K5
static_assert(Pixels::kPix == kPixPerThread && kBatch == kThreads,
              "the wide tile's layout");

// Keeps a parameter out of template argument deduction: the tile shape is
// deduced from the pixels alone, and the shared batch converts as usual.
template <typename T>
struct Same {
  using type = T;
};

template <int TW, int NT>
__device__ __forceinline__ void init_pixels(PixelsT<TW, NT>& p, int tx,
                                            int ty) {
  using P = PixelsT<TW, NT>;
  const int col = threadIdx.x % TW;
  const int row0 = threadIdx.x / TW;
  p.px = (float)(tx * TW + col);
#pragma unroll
  for (int k = 0; k < P::kPix; ++k) {
    p.py[k] = (float)(ty * kTileH + row0 + P::kRowStep * k);
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
template <int TW, int NT>
__device__ __forceinline__ int any_live(const PixelsT<TW, NT>& p) {
  int live = 0;
#pragma unroll
  for (int k = 0; k < PixelsT<TW, NT>::kPix; ++k) live |= !p.done[k];
  return live;
}

// Blend the first n pairs of the shared batch, in order, into p.
template <int TW, int NT>
__device__ __forceinline__ void blend_batch(
    typename Same<const float (*)[NT]>::type sh, int n,
    PixelsT<TW, NT>& p) {
  for (int j = 0; j < n; ++j) {
    const float gx = sh[0][j], gy = sh[1][j];
    const float ca = sh[2][j], cb = sh[3][j], cc = sh[4][j];
    const float op = sh[5][j];
    const float r = sh[6][j], gg = sh[7][j], b = sh[8][j];
    const float dep = sh[9][j];
#pragma unroll
    for (int k = 0; k < PixelsT<TW, NT>::kPix; ++k) {
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
// batch by batch of NT pairs, stopping once every pixel of the tile is
// done.
template <int TW, int NT>
__device__ __forceinline__ void blend_range(
    const float* __restrict__ pairs, long long n_pairs, int start, int end,
    typename Same<float (*)[NT]>::type sh, PixelsT<TW, NT>& p) {
  const int tid = threadIdx.x;
  for (int base = start; base < end; base += NT) {
    // also the barrier that retires the previous batch's shared reads
    if (__syncthreads_count(any_live(p)) == 0) break;
    const int n = min(NT, end - base);
    if (tid < n) {
#pragma unroll
      for (int a = 0; a < kAttr; ++a)
        sh[a][tid] = pairs[(long long)a * n_pairs + base + tid];
    }
    __syncthreads();
    blend_batch(sh, n, p);
  }
}

// out = C + T * bg and the median depth, into instance inst's frame of
// h_pad x w_pad pixels at tile (tx, ty); the final transmittance T too
// where t_fin is not null (K7).
template <int TW, int NT>
__device__ __forceinline__ void store_pixels(const PixelsT<TW, NT>& p,
                                             int inst, int tx, int ty,
                                             int h_pad, int w_pad, float bg0,
                                             float bg1, float bg2,
                                             float* rgb, float* depth,
                                             float* t_fin = nullptr) {
  using P = PixelsT<TW, NT>;
  const int col = threadIdx.x % TW;
  const int row0 = threadIdx.x / TW;
  const long long plane = (long long)h_pad * w_pad;
#pragma unroll
  for (int k = 0; k < P::kPix; ++k) {
    const long long pix =
        (long long)(ty * kTileH + row0 + P::kRowStep * k) * w_pad + tx * TW +
        col;
    float* out = rgb + (long long)inst * 3 * plane + pix;
    out[0] = p.Cr[k] + p.T[k] * bg0;
    out[plane] = p.Cg[k] + p.T[k] * bg1;
    out[2 * plane] = p.Cb[k] + p.T[k] * bg2;
    depth[(long long)inst * plane + pix] = p.D[k];
    if (t_fin) t_fin[(long long)inst * plane + pix] = p.T[k];
  }
}

}  // namespace tile_blend
