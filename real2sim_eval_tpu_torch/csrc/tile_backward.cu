// Tile compositor backward K8: per-pair gradients of the rendered rgb and
// median depth, by one front-to-back re-walk of each tile.
//
// Replaces the TPU Pallas kernel K8 (the JAX package's renderer/diff.py:
// _bwd_pairs and _bwd_kernel). Semantics, per pixel and contributing pair i
// (the forward's gates: alpha >= 1/255, not the pair that would drive T
// under 1e-4, pixel not frozen):
//
//   dC/dalpha_i = c_i T_i - (C_fin + bg T_fin - P_i) / (1 - alpha_i)
//
// with P_i the prefix colour including pair i, so one re-walk that
// recomputes T and P yields every pair's gradient from the forward's
// residuals (C_fin = rgb - T_fin bg, T_fin from K7). d(power) and
// d(opacity) are zero where the 0.99 clamp is active (araw >= 0.99); the
// depth cotangent goes only to the pair that crosses T = 0.5.
//
// Design: one CTA per (instance, 8x128 tile) and 256 threads owning 4
// pixels each, as K1 (tile_blend.cuh: the same tests in the same order,
// so T, the prefix and the early exit are the forward's). Pairs are
// staged in shared memory in batches of 256. For each pair a thread sums
// its 4 pixels' ten gradient terms, a warp sums its 32 threads by
// shuffles (skipped when no pixel of the warp takes the pair), and lane 0
// stores the warp's partials in shared memory; after the batch, thread j
// sums the 8 warps' partials of pair j in warp order and writes its ten
// lanes. No atomics: the result is deterministic, and each CTA writes only
// its own pair range, so the TPU version's chunk alignment has no
// counterpart. A CTA stops where the forward stops (every pixel frozen);
// pairs it never reaches keep the wrapper's zeros.
//
// Bound: operations. Each (pixel, pair) walk repeats the forward's ~20 f32
// operations; each contributing one adds ~60 for the gradient terms; the
// warp reductions come on top. Shared memory: 92,160 bytes (dynamic).
//
// Numerics: no fast math, --fmad=false, IEEE division and expf, as the
// forward, so the recomputed T and the 1/(1 - alpha) of the suffix identity
// follow the JAX kernel operation for operation.

#include <cuda_runtime.h>

#include "tile_blend.cuh"
#include "tile_composite.h"

namespace {

using namespace tile_blend;

constexpr int kWarps = kThreads / 32;
constexpr int kGrad = 10;
constexpr size_t kSmemBytes =
    sizeof(float) * (size_t)(kAttr + kWarps * kGrad) * kBatch;

// A thread's 4 pixels: their cotangents and the bg-inclusive final colour
// C_fin + bg T_fin of the suffix identity.
struct Cotangents {
  float dr[kPixPerThread], dg[kPixPerThread], db[kPixPerThread],
      dd[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread];
};

__global__ void __launch_bounds__(kThreads)
tile_backward_kernel(const float* __restrict__ pairs, long long n_pairs,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int n_tiles_x,
                     int n_tiles, int h_pad, int w_pad,
                     const float* __restrict__ dl_rgb,
                     const float* __restrict__ dl_depth,
                     const float* __restrict__ c_fin,
                     const float* __restrict__ t_fin, float bg0, float bg1,
                     float bg2, float* __restrict__ grads) {
  extern __shared__ float smem[];
  float(*sh)[kBatch] = reinterpret_cast<float(*)[kBatch]>(smem);
  // part[(w * kGrad + a) * kBatch + j]: warp w's sum of lane a for pair j
  float* part = smem + kAttr * kBatch;

  const int g = blockIdx.x;                 // (instance, tile)
  const int inst = g / n_tiles;
  const int t = g - inst * n_tiles;
  const int ty = t / n_tiles_x;
  const int tx = t - ty * n_tiles_x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  Pixels p;                                 // Cr/Cg/Cb hold the prefix P
  init_pixels(p, tx, ty);
  Cotangents c;
  {
    const int col = tid % kTileW, row0 = tid / kTileW;
    const long long plane = (long long)h_pad * w_pad;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const long long pix = (long long)(ty * kTileH + row0 + 2 * k) * w_pad +
                            tx * kTileW + col;
      const long long rgb_at = (long long)inst * 3 * plane + pix;
      const long long hw_at = (long long)inst * plane + pix;
      const float tf = t_fin[hw_at];
      c.dr[k] = dl_rgb[rgb_at];
      c.dg[k] = dl_rgb[rgb_at + plane];
      c.db[k] = dl_rgb[rgb_at + 2 * plane];
      c.dd[k] = dl_depth[hw_at];
      c.cr[k] = c_fin[rgb_at] + bg0 * tf;
      c.cg[k] = c_fin[rgb_at + plane] + bg1 * tf;
      c.cb[k] = c_fin[rgb_at + 2 * plane] + bg2 * tf;
    }
  }

  const int start = starts[g], end = ends[g];
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

    for (int j = 0; j < n; ++j) {
      const float gx = sh[0][j], gy = sh[1][j];
      const float ca = sh[2][j], cb = sh[3][j], cc = sh[4][j];
      const float op = sh[5][j];
      const float r = sh[6][j], gg = sh[7][j], b = sh[8][j];
      float s[kGrad];
#pragma unroll
      for (int a = 0; a < kGrad; ++a) s[a] = 0.0f;
      bool took = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float dx = gx - p.px;
        const float dy = gy - p.py[k];
        const float power =
            -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        const float gexp = expf(power);
        const float araw = op * gexp;
        float alpha = fminf(kAlphaMax, araw);
        if (!(power <= 0.0f)) alpha = 0.0f;
        const bool alpha_ok = alpha >= kAlphaMin;
        const float T = p.T[k];
        const float test_T = T * (1.0f - alpha);
        const bool would_done = alpha_ok && (test_T < kTEps);
        const bool contrib = alpha_ok && !would_done && !p.done[k];
        if (contrib) {
          took = true;
          const float aT = alpha * T;
          p.Cr[k] = p.Cr[k] + aT * r;
          p.Cg[k] = p.Cg[k] + aT * gg;
          p.Cb[k] = p.Cb[k] + aT * b;
          const float inv1 = 1.0f / (1.0f - alpha);
          const float dal = c.dr[k] * (r * T - (c.cr[k] - p.Cr[k]) * inv1) +
                            c.dg[k] * (gg * T - (c.cg[k] - p.Cg[k]) * inv1) +
                            c.db[k] * (b * T - (c.cb[k] - p.Cb[k]) * inv1);
          const bool notcl = araw < kAlphaMax;
          const float dpow = notcl ? dal * araw : 0.0f;
          const float dop = notcl ? dal * gexp : 0.0f;
          s[0] = s[0] + dpow * (-(ca * dx + cb * dy));
          s[1] = s[1] + dpow * (-(cc * dy + cb * dx));
          s[2] = s[2] + dpow * (-0.5f * dx * dx);
          s[3] = s[3] + dpow * (-dx * dy);
          s[4] = s[4] + dpow * (-0.5f * dy * dy);
          s[5] = s[5] + dop;
          s[6] = s[6] + c.dr[k] * aT;
          s[7] = s[7] + c.dg[k] * aT;
          s[8] = s[8] + c.db[k] * aT;
          if (T > 0.5f && test_T < 0.5f) s[9] = s[9] + c.dd[k];
          p.T[k] = test_T;
        }
        p.done[k] = p.done[k] || would_done;
      }
      if (__any_sync(0xffffffffu, took)) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
#pragma unroll
          for (int a = 0; a < kGrad; ++a)
            s[a] = s[a] + __shfl_down_sync(0xffffffffu, s[a], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < kGrad; ++a)
          part[(warp * kGrad + a) * kBatch + j] = s[a];
      }
    }
    __syncthreads();
    if (tid < n) {
#pragma unroll
      for (int a = 0; a < kGrad; ++a) {
        float v = part[a * kBatch + tid];
        for (int w = 1; w < kWarps; ++w)
          v = v + part[(w * kGrad + a) * kBatch + tid];
        grads[(long long)a * n_pairs + base + tid] = v;
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t tile_backward_launch(
    const float* pairs, long long n_pairs, const int* starts, const int* ends,
    int n_inst, int n_tiles_x, int n_tiles_y, const float* dl_rgb,
    const float* dl_depth, const float* c_fin, const float* t_fin, float bg0,
    float bg1, float bg2, float* grads, cudaStream_t stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  const long long blocks = (long long)n_inst * n_tiles;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      tile_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  tile_backward_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      pairs, n_pairs, starts, ends, n_tiles_x, n_tiles, n_tiles_y * kTileH,
      n_tiles_x * kTileW, dl_rgb, dl_depth, c_fin, t_fin, bg0, bg1, bg2,
      grads);
  return cudaGetLastError();
}
