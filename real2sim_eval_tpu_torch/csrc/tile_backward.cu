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
// Design: one CTA of 256 threads per (instance, 8x128 tile), walked as K1
// walks it (tile_blend.cuh walk_culled): warp w owns the 8x16 block of
// columns [16 w, 16 w + 16), 4 pixels a lane; pairs arrive in batches of
// 256 by cp.async into two shared buffers, batch n + 1 loading while batch
// n is walked; each warp tests a landed batch against its block with the
// forward's exact block cull (block_keep) and re-walks only the kept pairs,
// in order, with the forward's tests (so T, the prefix and the early exit
// are K7's). A pair the cull drops reaches no pixel of the block, changes
// no T, prefix or done flag there, and its gradient terms from the block
// are exactly 0. For a kept pair a lane sums its 4 pixels' ten terms, the
// warp sums its lanes by a butterfly of shuffles that leaves each term's
// sum in two lanes (warp_sum_terms; skipped when no lane took the pair),
// and ten lanes store the warp's partials in shared memory; the warps'
// keep masks go there too. After the batch, thread j sums pair j's
// partials over the warps that kept it, in warp order, and writes its ten
// lanes. No atomics: the result is deterministic, and each CTA writes only
// its own pair range, so the TPU version's chunk alignment has no
// counterpart. A CTA stops where the forward stops (every pixel frozen);
// pairs it never reaches keep the wrapper's zeros. CTA b takes tile
// order[b]: the wrapper lists the tiles by falling pair count, so the
// longest walks start first and do not trail the rest of the launch.
//
// Bound: operations. Each (pixel, pair) walk repeats the forward's ~20 f32
// operations; each contributing one adds ~60 for the gradient terms; the
// block tests and the warp reductions come on top. Shared memory: two
// attribute buffers (20,480 bytes), the 8 warps' partials of one batch
// (90,112, 11 floats a pair) and their keep masks (256), 110,848 bytes
// (dynamic): two CTAs fit on an SM, as the registers allow.
//
// Numerics: no fast math, --fmad=false, IEEE division and expf, as the
// forward, so the recomputed T and the 1/(1 - alpha) of the suffix identity
// follow the JAX kernel operation for operation. The per-pair sums run over
// 8x16 blocks and then over the blocks in order, not in the JAX kernel's
// order: the gradients match it to rounding, not bitwise.

#include <cuda_runtime.h>

#include "tile_blend.cuh"
#include "tile_composite.h"

namespace {

using namespace tile_blend;

constexpr int kWarps = kThreads / 32;
constexpr int kGrad = 10;
// a warp's ten sums of one pair sit kPartStride floats apart from the
// next pair's: the lanes' stores of one pair and the threads' loads of
// consecutive pairs hit distinct banks
constexpr int kPartStride = kGrad + 1;
constexpr int kMaskWords = kBatch / 32;
constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)2 * kAttr * kBatch +
                     (size_t)kWarps * kBatch * kPartStride) +
    sizeof(unsigned) * (size_t)kWarps * kMaskWords;
constexpr int kPix = WarpPixels::kPix;

// One step of warp_sum_terms: lanes l and l ^ (1 << BIT) swap halves of
// the H terms each holds, lane l keeping the upper half where bit BIT of
// l is set, and add.
template <int H, int BIT>
__device__ __forceinline__ void halve_terms(float (&s)[16], int lane) {
  const bool upper = (lane >> BIT) & 1;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? s[i] : s[i + H];
    const float keep = upper ? s[i + H] : s[i];
    s[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << BIT);
  }
}

// The warp's sums of a lane's kGrad terms (held in s[0, kGrad), the rest
// of s 0): a butterfly that halves the terms a lane holds at each of four
// steps and sums the last one over lanes l and l ^ 1, so lanes 2 a and
// 2 a + 1 end with the sum of term a. 16 shuffles, not 5 per term; the
// order of the additions is fixed, and IEEE addition commutes, so both
// lanes of a pair hold the same bits.
__device__ __forceinline__ float warp_sum_terms(float (&s)[16], int lane) {
  halve_terms<8, 4>(s, lane);
  halve_terms<4, 3>(s, lane);
  halve_terms<2, 2>(s, lane);
  halve_terms<1, 1>(s, lane);
  return s[0] + __shfl_xor_sync(0xffffffffu, s[0], 1);
}

// A lane's 4 pixels: their cotangents and the bg-inclusive final colour
// C_fin + bg T_fin of the suffix identity.
struct Cotangents {
  float dr[kPix], dg[kPix], db[kPix], dd[kPix];
  float cr[kPix], cg[kPix], cb[kPix];
};

__global__ void __launch_bounds__(kThreads, 2)
tile_backward_kernel(const float* __restrict__ pairs, long long n_pairs,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const int* __restrict__ order, int n_tiles_x,
                     int n_tiles, int h_pad, int w_pad,
                     const float* __restrict__ dl_rgb,
                     const float* __restrict__ dl_depth,
                     const float* __restrict__ c_fin,
                     const float* __restrict__ t_fin, float bg0, float bg1,
                     float bg2, float* __restrict__ grads) {
  extern __shared__ float smem[];
  auto sh = reinterpret_cast<float(*)[kAttr][kBatch]>(smem);
  // part[(w * kBatch + j) * kPartStride + a]: warp w's sum of lane a for
  // pair j
  float* part = smem + 2 * kAttr * kBatch;
  // kept[w * kMaskWords + k]: bit l set where warp w kept pair 32 k + l
  unsigned* kept =
      reinterpret_cast<unsigned*>(part + kWarps * kBatch * kPartStride);

  const int g = order[blockIdx.x];          // (instance, tile)
  if (g < 0 || g >= (int)gridDim.x) return;
  const int inst = g / n_tiles;
  const int t = g - inst * n_tiles;
  const int ty = t / n_tiles_x;
  const int tx = t - ty * n_tiles_x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  WarpPixels p;                             // Cr/Cg/Cb hold the prefix P
  init_pixels(p, tx, ty);
  Cotangents c;
  {
    const long long plane = (long long)h_pad * w_pad;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const long long pix =
          (long long)(ty * kTileH + warp_row0() + 2 * k) * w_pad +
          tx * kTileW + warp_col();
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

  int base = starts[g];
  RangeSource src{pairs, n_pairs, base, ends[g]};
  const auto pair = [&](const float (*b)[kBatch], int j) {
    const float gx = b[0][j], gy = b[1][j];
    const float ca = b[2][j], cb = b[3][j], cc = b[4][j];
    const float op = b[5][j];
    const float r = b[6][j], gg = b[7][j], bl = b[8][j];
    float s[16];
#pragma unroll
    for (int a = 0; a < 16; ++a) s[a] = 0.0f;
    bool took = false;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float dx = gx - p.px;
      const float dy = gy - p.py[k];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
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
        p.Cb[k] = p.Cb[k] + aT * bl;
        const float inv1 = 1.0f / (1.0f - alpha);
        const float dal = c.dr[k] * (r * T - (c.cr[k] - p.Cr[k]) * inv1) +
                          c.dg[k] * (gg * T - (c.cg[k] - p.Cg[k]) * inv1) +
                          c.db[k] * (bl * T - (c.cb[k] - p.Cb[k]) * inv1);
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
    const float v = __any_sync(0xffffffffu, took) ? warp_sum_terms(s, lane)
                                                  : 0.0f;
    if (!(lane & 1) && lane / 2 < kGrad)
      part[(warp * kBatch + j) * kPartStride + lane / 2] = v;
  };
  const auto end_batch = [&](int n, const unsigned* keep) {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kMaskWords; ++k)
        kept[warp * kMaskWords + k] = keep[k];
    }
    __syncthreads();
    if (tid < n) {
      // the warps that kept pair tid, summed in warp order
      unsigned warps = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        warps |= ((kept[w * kMaskWords + tid / 32] >> (tid % 32)) & 1u) << w;
#pragma unroll
      for (int a = 0; a < kGrad; ++a) {
        float v = 0.0f;
        for (unsigned m = warps; m; m &= m - 1)
          v = v + part[((__ffs(m) - 1) * kBatch + tid) * kPartStride + a];
        grads[(long long)a * n_pairs + base + tid] = v;
      }
    }
    base += n;
  };
  walk_culled(src, sh, p, (float)(tx * kTileW + warp * kBlockW),
              (float)(ty * kTileH), pair, end_batch);
}

}  // namespace

extern "C" cudaError_t tile_backward_launch(
    const float* pairs, long long n_pairs, const int* starts, const int* ends,
    const int* order, int n_inst, int n_tiles_x, int n_tiles_y,
    const float* dl_rgb, const float* dl_depth, const float* c_fin,
    const float* t_fin, float bg0, float bg1, float bg2, float* grads,
    cudaStream_t stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  const long long blocks = (long long)n_inst * n_tiles;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      tile_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  // the most shared memory the SM offers, so that two CTAs fit
  err = cudaFuncSetAttribute(tile_backward_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  tile_backward_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      pairs, n_pairs, starts, ends, order, n_tiles_x, n_tiles,
      n_tiles_y * kTileH, n_tiles_x * kTileW, dl_rgb, dl_depth, c_fin, t_fin,
      bg0, bg1, bg2, grads);
  return cudaGetLastError();
}
