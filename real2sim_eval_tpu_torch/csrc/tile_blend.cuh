// Front-to-back splat blending: the per-(pixel, pair) step and the walks
// shared by the wide (8x128) tile compositors K1 and K7
// (tile_composite.cu), K2 (tile_sparse.cu) and K6 (tile_sparse_merge.cu),
// and the fine (8x16) compositors K4 (fine_composite.cu) and K5
// (fine_sparse.cu), so they cannot drift apart. The backward K8
// (tile_backward.cu) walks the wide tile as K1 does and repeats the blend's
// tests in the same order to recompute T.
//
// The wide tile (WarpPixels): one CTA of 256 threads, each warp owning one
// 8x16 block, 4 pixels a lane; walk_culled feeds it batches from a
// RangeSource (a contiguous pair range: K1, K7, K2, K8) or a MergeSource
// (the depth merge of a static and a dynamic segment: K6), structure of
// arrays sh[attr][pair], attrs [x, y, conic a/b/c, opacity, r, g, b,
// depth], and skips, per warp, the pairs that provably cannot reach the
// warp's block. The fine tile (QuadPixel, walk_fine): one CTA of 128
// threads, each warp owning one 4x8 quadrant, one pixel a lane, walking
// the tile's pairs on its own with the same cull on the quadrant. Every
// compositor evaluates a (pixel, pair) through
// blend_pixel, so their per-pixel sequences of operations are one.
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
constexpr int kFineW = 16;
constexpr int kAttr = 10;
constexpr int kDepthAttr = 9;
constexpr float kAlphaMin = 0.003921568859368563f;          // f32(1/255)
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kDepthDefault = 15.0f;

static_assert(kBatch == kThreads, "one thread loads each slot of a batch");

// 1 while any of this thread's pixels can still take a contribution; a
// wide tile's CTA (walk_culled) or a fine quadrant's warp (walk_fine)
// stops once it is 0 on all its threads (the TPU kernel's while_loop
// condition). P is WarpPixels or QuadPixel.
template <typename P>
__device__ __forceinline__ int any_live(const P& p) {
  int live = 0;
#pragma unroll
  for (int k = 0; k < P::kPix; ++k) live |= !p.done[k];
  return live;
}

// One pair over one pixel at (px, py): the TPU kernel's per-(pixel, pair)
// step, the only place any compositor evaluates it.
__device__ __forceinline__ void blend_pixel(float gx, float gy, float ca,
                                            float cb, float cc, float op,
                                            float r, float gg, float b,
                                            float dep, float px, float py,
                                            float& T, float& Cr, float& Cg,
                                            float& Cb, float& D, bool& done) {
  const float dx = gx - px;
  const float dy = gy - py;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  float alpha = fminf(kAlphaMax, op * expf(power));
  if (!(power <= 0.0f)) alpha = 0.0f;
  const bool alpha_ok = alpha >= kAlphaMin;
  const float test_T = T * (1.0f - alpha);
  const bool would_done = alpha_ok && (test_T < kTEps);
  const bool contrib = alpha_ok && !would_done && !done;
  if (contrib) {
    const float aT = alpha * T;
    Cr = Cr + aT * r;
    Cg = Cg + aT * gg;
    Cb = Cb + aT * b;
    if (T > 0.5f && test_T < 0.5f) D = dep;
    T = test_T;
  }
  done = done || would_done;
}

// Pair j of a shared batch over the kPix pixels of p, in order.
template <typename P, int NT>
__device__ __forceinline__ void blend_pair(const float (*sh)[NT], int j,
                                           P& p) {
  const float gx = sh[0][j], gy = sh[1][j];
  const float ca = sh[2][j], cb = sh[3][j], cc = sh[4][j];
  const float op = sh[5][j];
  const float r = sh[6][j], gg = sh[7][j], b = sh[8][j];
  const float dep = sh[9][j];
#pragma unroll
  for (int k = 0; k < P::kPix; ++k)
    blend_pixel(gx, gy, ca, cb, cc, op, r, gg, b, dep, p.px, p.py[k], p.T[k],
                p.Cr[k], p.Cg[k], p.Cb[k], p.D[k], p.done[k]);
}

// ---------------------------------------------------------------------------
// K1, K7, K2, K6 and K8: one 8x16 block of the 8x128 tile per warp
// ---------------------------------------------------------------------------

constexpr int kBlockW = 16;
constexpr int kWarpBlocks = kThreads / 32;
static_assert(kWarpBlocks * kBlockW == kTileW, "8 warps span the wide tile");

// The 4 pixels of a lane of warp w: column 16 w + lane % 16, rows
// lane / 16 + {0, 2, 4, 6}; the warp's 32 lanes cover its 8x16 block.
struct WarpPixels {
  static constexpr int kPix = 4;
  float px;
  float py[kPix];
  float T[kPix], Cr[kPix], Cg[kPix], Cb[kPix], D[kPix];
  bool done[kPix];
};

__device__ __forceinline__ int warp_col() {
  return (threadIdx.x / 32) * kBlockW + (threadIdx.x % kBlockW);
}

__device__ __forceinline__ int warp_row0() { return (threadIdx.x % 32) / 16; }

__device__ __forceinline__ void init_pixels(WarpPixels& p, int tx, int ty) {
  p.px = (float)(tx * kTileW + warp_col());
#pragma unroll
  for (int k = 0; k < WarpPixels::kPix; ++k) {
    p.py[k] = (float)(ty * kTileH + warp_row0() + 2 * k);
    p.T[k] = 1.0f;
    p.Cr[k] = 0.0f;
    p.Cg[k] = 0.0f;
    p.Cb[k] = 0.0f;
    p.D[k] = kDepthDefault;
    p.done[k] = false;
  }
}

// The block cull's margin (renderer/tile_kernel.py ``block_cull_keep`` is
// the same test in PyTorch). A pixel takes a pair only where its f32 power
// p = -Q/2, Q = a dx^2 + 2 b dx dy + c dy^2, has fl(op * expf(p)) >=
// f32(1/255) > 1/255; expf within 2 ulp and the product's rounding give
// Q(pixel) <= 2 ln(255 op) + 2 eta, eta = 2^-22 + 2^-24, for the f32 Q of
// the pixel. That f32 Q differs from the exact one by at most ~8 u S, u =
// 2^-24, S = |a| dx^2 + 2 |b| |dx dy| + |c| dy^2: rounding is relative to
// the terms, not to Q, which thin rotated splats cancel to near 0. The
// box's exact minimum of Q lies below every pixel's; its f32 estimate (a
// candidate of the binning's formulas, on a box whose corners are rounded
// once or twice) exceeds it by at most ~10 u S more (4 u S from the box's
// shift along the gradient, 6 u S from evaluating Q; a candidate off the
// exact minimiser by rounding adds only O(u^2 S)). S is largest at the
// box's far corner, so keeping every pair with
//   qmin <= 2 ln(255 op) + kCullAbs + kCullRel * S(far corner)
// keeps every pair a pixel of the box takes: kCullRel = 1e-5 is ~168 u
// against the ~18 u needed, kCullAbs = 1e-4 covers 2 eta and the f32
// threshold's own error (~3e-6). Nothing above depends on the box's size:
// the per-pixel and the per-box bounds are each relative to S at some
// point of the box, and the far corner bounds S over any axis-aligned box,
// so the margin holds as it is for K1's 8x16 blocks and for the fine
// kernels' 4x8 quadrants alike. A wider margin only costs speed.
// R2S_CULL_ABS exists for one test build: chip_smoke.py compiles the fine
// kernels with a negative margin and checks that its gates reject them.
#ifndef R2S_CULL_ABS
#define R2S_CULL_ABS 1e-4f
#endif
constexpr float kCullAbs = R2S_CULL_ABS;
constexpr float kCullRel = 1e-5f;

// false only where pair (gx, gy, conic a/b/c, op) adds nothing to any pixel
// of the BW x BH box (columns x rows; K1's 8x16 block by default) whose
// first pixel is (bx0, by0): the binning's exact conic cull
// (renderer/binning.py _exact_cull_keep) on the box, with the margin above.
// A conic that is not positive definite, a non-finite attribute or a
// negative opacity is always kept.
template <int BW = kBlockW, int BH = kTileH>
__device__ __forceinline__ bool block_keep(float gx, float gy, float ca,
                                           float cb, float cc, float op,
                                           float bx0, float by0) {
  if (!(ca >= 1e-20f && cc >= 1e-20f && ca * cc - cb * cb > 0.0f &&
        op >= 0.0f && isfinite(gx + gy + ca + cb + cc + op)))
    return true;
  const float lx = bx0 - gx, ux = lx + (float)(BW - 1);
  const float ly = by0 - gy, uy = ly + (float)(BH - 1);
  const float ica = 1.0f / ca, icc = 1.0f / cc;
  const auto q = [&](float dx, float dy) {
    return ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy;
  };
  const auto cl = [](float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
  };
  const float q0 = q(cl(0.0f, lx, ux), cl(0.0f, ly, uy));
  const float q1 = q(lx, cl(-cb * lx * icc, ly, uy));
  const float q2 = q(ux, cl(-cb * ux * icc, ly, uy));
  const float q3 = q(cl(-cb * ly * ica, lx, ux), ly);
  const float q4 = q(cl(-cb * uy * ica, lx, ux), uy);
  const float qmin = fminf(fminf(fminf(q0, q1), fminf(q2, q3)), q4);
  const float X = fmaxf(fabsf(lx), fabsf(ux));
  const float Y = fmaxf(fabsf(ly), fabsf(uy));
  const float mag = ca * X * X + 2.0f * fabsf(cb) * X * Y + cc * Y * Y;
  const float thr = 2.0f * logf(255.0f * fmaxf(op, 1e-12f)) + kCullAbs +
                    kCullRel * mag;
  return !(qmin > thr);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The batches a culled walk takes: each load() issues the cp.async copies
// of the next batch of up to kBatch pairs, in order, into one shared buffer
// (sh[attr][slot]), commits them as one group and returns the batch's
// size, 0 once the stream is spent. Every thread of the CTA calls load()
// together.
//
// RangeSource: the contiguous range [next, end) of a (10, n_pairs) table
// (K1, K7, K2, K8).
struct RangeSource {
  const float* __restrict__ pairs;
  long long n_pairs;
  int next, end;

  __device__ __forceinline__ int load(float (*dst)[kBatch]) {
    const int tid = threadIdx.x;
    const int n = max(0, min(kBatch, end - next));
    if (tid < n) {
#pragma unroll
      for (int a = 0; a < kAttr; ++a)
        cp_async4(&dst[a][tid], pairs + (long long)a * n_pairs + next + tid);
    }
    cp_async_commit();
    next += n;
    return n;
  }
};

// MergeSource: the depth merge of the static segment [s0, s0 + ls) of
// data_s and the dynamic segment [d0, d0 + ld) of data_d (both (10, n)
// tables, each segment depth-sorted, the depth in lane kDepthAttr), a
// dynamic pair first on equal depth: dynamic pair j goes before static pair
// i iff depth_d[j] <= depth_s[i] (K6; renderer/tile_kernel.py
// merge_segments builds the same order by a stable sort). (i, j) is the
// co-rank of the next batch's first merged pair: i statics and j dynamics
// come before it. A batch's merged pairs lie in the windows [i, i + kBatch)
// and [j, j + kBatch) of the two segments; their depths are staged in
// shared memory (win), thread t finds the co-rank of merged pair t by a
// binary search over the windows (at most 9 steps) and copies that pair's
// attributes from whichever table holds it; the count of statics taken
// gives the next batch's co-rank.
struct MergeSource {
  const float* __restrict__ data_s;
  long long n_s;
  const float* __restrict__ data_d;
  long long n_d;
  int s0, ls, d0, ld;
  int i, j;
  float (*win)[kBatch];                     // [2][kBatch], shared

  __device__ __forceinline__ int load(float (*dst)[kBatch]) {
    const int tid = threadIdx.x;
    const int ns = min(kBatch, ls - i), nd = min(kBatch, ld - j);
    const int n = min(kBatch, ns + nd);
    // the previous load's searches ended at its __syncthreads_count, so
    // the windows are free
    if (tid < ns)
      win[0][tid] = data_s[(long long)kDepthAttr * n_s + s0 + i + tid];
    if (tid < nd)
      win[1][tid] = data_d[(long long)kDepthAttr * n_d + d0 + j + tid];
    __syncthreads();
    bool take_s = false;
    if (tid < n) {
      // co-rank of merged pair tid: the smallest a such that static a does
      // not precede dynamic tid - a - 1; a statics and tid - a dynamics of
      // the windows come first
      int lo = max(0, tid - nd), hi = min(tid, ns);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (win[0][mid] < win[1][tid - mid - 1])
          lo = mid + 1;
        else
          hi = mid;
      }
      const int a = lo, b = tid - lo;
      take_s = b >= nd || (a < ns && win[0][a] < win[1][b]);
      const float* src = take_s ? data_s + s0 + i + a : data_d + d0 + j + b;
      const long long stride = take_s ? n_s : n_d;
#pragma unroll
      for (int k = 0; k < kAttr; ++k)
        cp_async4(&dst[k][tid], src + (long long)k * stride);
    }
    cp_async_commit();
    const int taken_s = __syncthreads_count(take_s);
    i += taken_s;
    j += n - taken_s;
    return n;
  }
};

// Walk the pairs of ``src`` over the warp blocks' pixels: batches of kBatch
// pairs through two shared buffers, batch n + 1 loading by cp.async while
// batch n is walked. After a batch lands each warp tests it against its
// block (lane l tests pairs l, l + 32, ...; __ballot_sync gathers 8 masks)
// and calls pair(batch, slot) for the kept pairs only, in ascending order;
// a warp whose 128 pixels are all done skips both. Then every thread calls
// end_batch(batch size, its warp's masks), the masks all 0 for a warp that
// skipped. The CTA stops once every pixel is done, as the TPU kernel's
// while_loop does. p is read for liveness only; pair() updates it.
template <typename Source, typename Pair, typename EndBatch>
__device__ __forceinline__ void walk_culled(Source& src,
                                            float (*sh)[kAttr][kBatch],
                                            const WarpPixels& p, float bx0,
                                            float by0, Pair&& pair,
                                            EndBatch&& end_batch) {
  const int lane = threadIdx.x % 32;
  int n = src.load(sh[0]);
  for (int buf = 0; n > 0; buf ^= 1) {
    // also the barrier that retires the previous batch's shared reads,
    // whose buffer the next load refills
    if (__syncthreads_count(any_live(p)) == 0) break;
    const int n_next = src.load(sh[buf ^ 1]);
    if (n_next > 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    unsigned keep[kBatch / 32];
    if (__any_sync(0xffffffffu, any_live(p))) {
      const float (*b)[kBatch] = sh[buf];
#pragma unroll
      for (int k = 0; k < kBatch / 32; ++k) {
        const int j = lane + 32 * k;
        keep[k] = __ballot_sync(
            0xffffffffu, j < n && block_keep(b[0][j], b[1][j], b[2][j],
                                             b[3][j], b[4][j], b[5][j], bx0,
                                             by0));
      }
#pragma unroll
      for (int k = 0; k < kBatch / 32; ++k) {
        for (unsigned m = keep[k]; m; m &= m - 1)
          pair(b, 32 * k + __ffs(m) - 1);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kBatch / 32; ++k) keep[k] = 0u;
    }
    end_batch(n, keep);
    n = n_next;
  }
  cp_async_wait<0>();   // no copy may land after the CTA has left
}

// The forward walk of K1, K7, K2 and K6: blend the kept pairs of ``src``
// into p, in order.
template <typename Source>
__device__ __forceinline__ void blend_culled(Source& src,
                                             float (*sh)[kAttr][kBatch],
                                             WarpPixels& p, float bx0,
                                             float by0) {
  walk_culled(
      src, sh, p, bx0, by0,
      [&](const float (*b)[kBatch], int j) { blend_pair(b, j, p); },
      [](int, const unsigned*) {});
}

// blend_culled over the contiguous pair range [start, end) of a (10,
// n_pairs) table.
__device__ __forceinline__ void blend_range_culled(
    const float* __restrict__ pairs, long long n_pairs, int start, int end,
    float (*sh)[kAttr][kBatch], WarpPixels& p, float bx0, float by0) {
  RangeSource src{pairs, n_pairs, start, end};
  blend_culled(src, sh, p, bx0, by0);
}

// out = C + T * bg and the median depth, into instance inst's frame of
// h_pad x w_pad pixels at tile (tx, ty); the final transmittance T too
// where t_fin is not null (K7). For the warp blocks of K1, K7, K2 and K6.
__device__ __forceinline__ void store_pixels(const WarpPixels& p, int inst,
                                             int tx, int ty, int h_pad,
                                             int w_pad, float bg0, float bg1,
                                             float bg2, float* rgb,
                                             float* depth,
                                             float* t_fin = nullptr) {
  const long long plane = (long long)h_pad * w_pad;
#pragma unroll
  for (int k = 0; k < WarpPixels::kPix; ++k) {
    const long long pix =
        (long long)(ty * kTileH + warp_row0() + 2 * k) * w_pad +
        tx * kTileW + warp_col();
    float* out = rgb + (long long)inst * 3 * plane + pix;
    out[0] = p.Cr[k] + p.T[k] * bg0;
    out[plane] = p.Cg[k] + p.T[k] * bg1;
    out[2 * plane] = p.Cb[k] + p.T[k] * bg2;
    depth[(long long)inst * plane + pix] = p.D[k];
    if (t_fin) t_fin[(long long)inst * plane + pix] = p.T[k];
  }
}

// ---------------------------------------------------------------------------
// K4 and K5: one 4x8 quadrant of the 8x16 fine tile per warp
// ---------------------------------------------------------------------------

constexpr int kFineThreads = 128;           // 4 warps, one quadrant each
constexpr int kQuadW = 8;
constexpr int kQuadH = 4;
static_assert(kFineThreads / 32 * kQuadW * kQuadH == kFineW * kTileH,
              "4 quadrants span the fine tile");
// A warp's batch: kWarpBatch pairs, one a lane, stored pair-major as
// three float4s [x, y, a, b] [c, op, r, g] [b, depth, -, -]: a lane reads
// its own slot without bank conflicts (48-byte stride), and the warp reads
// a kept pair with three broadcast loads.
constexpr int kWarpBatch = 32;
constexpr int kSlot = 12;

// The pixel of a lane of warp w: quadrant (w % 2, w / 2) of the fine tile,
// column 8 (w % 2) + lane % 8, row 4 (w / 2) + lane / 8.
struct QuadPixel {
  static constexpr int kPix = 1;
  float px, py;
  float T[kPix], Cr[kPix], Cg[kPix], Cb[kPix], D[kPix];
  bool done[kPix];
};

// The first pixel of this warp's quadrant in fine tile (tx, ty).
__device__ __forceinline__ int quad_x0(int tx) {
  return tx * kFineW + ((threadIdx.x / 32) % 2) * kQuadW;
}

__device__ __forceinline__ int quad_y0(int ty) {
  return ty * kTileH + (threadIdx.x / 32 / 2) * kQuadH;
}

__device__ __forceinline__ void init_pixels(QuadPixel& p, int tx, int ty) {
  p.px = (float)(quad_x0(tx) + threadIdx.x % kQuadW);
  p.py = (float)(quad_y0(ty) + (threadIdx.x % 32) / kQuadW);
  p.T[0] = 1.0f;
  p.Cr[0] = 0.0f;
  p.Cg[0] = 0.0f;
  p.Cb[0] = 0.0f;
  p.D[0] = kDepthDefault;
  p.done[0] = false;
}

// One warp's walk of the contiguous pair range [start, end) of a (10,
// n_pairs) table over its quadrant, on its own: batches of kWarpBatch
// pairs through the warp's two shared buffers (sh[buf] holds kWarpBatch *
// kSlot floats, 16-byte aligned), batch n + 1 loading by cp.async while
// batch n is walked. Once a batch lands, lane l tests pair l against the
// quadrant; the warp then blends the kept pairs only, in ascending order.
// The warp stops once its 32 pixels are done (the TPU kernel's while_loop
// condition, per quadrant); no barrier ties it to the other warps of its
// CTA, so a quadrant that keeps more pairs holds up no other. Every pixel
// thus sees the pairs of the unculled walk less some that cannot pass
// power <= 0 and alpha >= 1/255 at it: its state changes are the plain
// version's.
__device__ __forceinline__ void walk_fine(const float* __restrict__ pairs,
                                          long long n_pairs, int start,
                                          int end,
                                          float (*sh)[kWarpBatch * kSlot],
                                          QuadPixel& p, float bx0,
                                          float by0) {
  const int lane = threadIdx.x % 32;
  const auto load = [&](int base, float* dst) {
    const int n = max(0, min(kWarpBatch, end - base));
    if (lane < n) {
#pragma unroll
      for (int a = 0; a < kAttr; ++a)
        cp_async4(dst + lane * kSlot + a,
                  pairs + (long long)a * n_pairs + base + lane);
    }
    cp_async_commit();
    return n;
  };
  int base = start;
  int n = load(base, sh[0]);
  for (int buf = 0; n > 0; buf ^= 1) {
    if (!__any_sync(0xffffffffu, any_live(p))) break;
    // every lane has read the buffer that the next load refills
    __syncwarp();
    const int n_next = load(base + n, sh[buf ^ 1]);
    if (n_next > 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    const float* b = sh[buf];
    bool kept = false;
    if (lane < n) {                           // the pair this lane loaded
      const float4 v0 = *reinterpret_cast<const float4*>(b + lane * kSlot);
      const float4 v1 =
          *reinterpret_cast<const float4*>(b + lane * kSlot + 4);
      kept = block_keep<kQuadW, kQuadH>(v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                                        bx0, by0);
    }
    // every lane's copies have landed before any lane reads another's slot
    __syncwarp();
    for (unsigned m = __ballot_sync(0xffffffffu, kept); m; m &= m - 1) {
      const float* q = b + (__ffs(m) - 1) * kSlot;
      const float4 v0 = *reinterpret_cast<const float4*>(q);
      const float4 v1 = *reinterpret_cast<const float4*>(q + 4);
      const float4 v2 = *reinterpret_cast<const float4*>(q + 8);
      blend_pixel(v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, v2.x, v2.y,
                  p.px, p.py, p.T[0], p.Cr[0], p.Cg[0], p.Cb[0], p.D[0],
                  p.done[0]);
    }
    base += n;
    n = n_next;
  }
  cp_async_wait<0>();   // no copy may land after the warp has left
}

// out = C + T * bg and the median depth of p, into instance inst's frame
// of h_pad x w_pad pixels.
__device__ __forceinline__ void store_pixels(const QuadPixel& p, int inst,
                                             int h_pad, int w_pad, float bg0,
                                             float bg1, float bg2,
                                             float* rgb, float* depth) {
  const long long plane = (long long)h_pad * w_pad;
  const long long pix = (long long)p.py * w_pad + (long long)p.px;
  float* out = rgb + (long long)inst * 3 * plane + pix;
  out[0] = p.Cr[0] + p.T[0] * bg0;
  out[plane] = p.Cg[0] + p.T[0] * bg1;
  out[2 * plane] = p.Cb[0] + p.T[0] * bg2;
  depth[(long long)inst * plane + pix] = p.D[0];
}

}  // namespace tile_blend
