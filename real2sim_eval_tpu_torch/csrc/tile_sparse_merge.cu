// Stream-merge dirty-tile compositor K6: K2 with the merge of the static and
// dynamic pair streams done inside the kernel.
//
// Replaces the TPU Pallas kernel K6 (the JAX package's renderer/
// tile_kernel.py: rasterize_tiles_sparse_merge, _kernel_sparse_merge and
// _composite_merge_scoped).
//
// Design: one CTA of 256 threads per entry of the flat dirty (instance,
// tile) list. Its inputs are two depth-sorted segments: [s_start, s_end) of
// the frozen static table of all fixed cameras, shared by every env and
// already truncated at the static-only saturation point, and [d_start,
// d_end) of this step's dynamic table. Both tables are structure-of-arrays
// (10, P) f32 with the exact view depth in lane 9 (the port never packs
// payloads), so no separate depth plane is needed. The merged order puts
// dynamic pair j before static pair i iff depth_d[j] <= depth_s[i] (the TPU
// kernel's `d <= s`): the full pipeline's stable depth sort of the
// [dynamic; static] scene. The walk is K2's (tile_blend.cuh walk_culled:
// warp w owns the 8x16 block of columns [16 w, 16 w + 16), batches of 256
// merged pairs through two shared buffers by cp.async, each warp blending
// only the pairs of a landed batch that pass the exact block cull); only
// the source of the batches differs (tile_blend.cuh MergeSource): a batch
// starts at the co-rank where the previous one ended, stages the two depth
// windows it can draw from in shared memory, and each thread finds its
// merged pair's co-rank by a binary search there and copies that pair's 10
// attributes from whichever table holds it. So the frames are bitwise K2's
// on the merged table, and its plain version's. Early exit and the write
// into the cached frames are K2's.
//
// Bound: as K2, the pair tables' bytes; the merge adds two depth loads per
// merged pair (the windows) and a search of at most 9 steps in shared
// memory.

#include <cuda_runtime.h>

#include "tile_blend.cuh"
#include "tile_composite.h"

namespace {

using namespace tile_blend;

// at most 64 registers: four CTAs an SM
__global__ void __launch_bounds__(kThreads, 4)
tile_sparse_merge_kernel(const float* __restrict__ data_s, long long n_s,
                         const float* __restrict__ data_d, long long n_d,
                         const int* __restrict__ inst_ids,
                         const int* __restrict__ tile_ids,
                         const int* __restrict__ s_starts,
                         const int* __restrict__ s_ends,
                         const int* __restrict__ d_starts,
                         const int* __restrict__ d_ends, int n_inst,
                         int n_tiles_x, int n_tiles, int h_pad, int w_pad,
                         float bg0, float bg1, float bg2,
                         float* __restrict__ rgb, float* __restrict__ depth) {
  __shared__ float sh[2][kAttr][kBatch];
  __shared__ float win[2][kBatch];

  const int k = blockIdx.x;                 // dirty-list entry
  const int inst = inst_ids[k];
  const int t = tile_ids[k];
  if (inst < 0 || inst >= n_inst || t < 0 || t >= n_tiles) return;
  const int ty = t / n_tiles_x;
  const int tx = t - ty * n_tiles_x;

  const int s0 = s_starts[k], d0 = d_starts[k];
  MergeSource src{data_s, n_s, data_d, n_d,
                  s0, max(s_ends[k] - s0, 0), d0, max(d_ends[k] - d0, 0),
                  0, 0, win};
  WarpPixels p;
  init_pixels(p, tx, ty);
  blend_culled(src, sh, p,
               (float)(tx * kTileW + (threadIdx.x / 32) * kBlockW),
               (float)(ty * kTileH));
  store_pixels(p, inst, tx, ty, h_pad, w_pad, bg0, bg1, bg2, rgb, depth);
}

}  // namespace

extern "C" cudaError_t tile_sparse_merge_launch(
    const float* data_s, long long n_s, const float* data_d, long long n_d,
    const int* inst_ids, const int* tile_ids, const int* s_starts,
    const int* s_ends, const int* d_starts, const int* d_ends, int n_dirty,
    int n_inst, int n_tiles_x, int n_tiles_y, float bg0, float bg1,
    float bg2, float* rgb, float* depth, cudaStream_t stream) {
  if (n_dirty == 0) return cudaSuccess;
  tile_sparse_merge_kernel<<<(unsigned)n_dirty, kThreads, 0, stream>>>(
      data_s, n_s, data_d, n_d, inst_ids, tile_ids, s_starts, s_ends,
      d_starts, d_ends, n_inst, n_tiles_x, n_tiles_x * n_tiles_y,
      n_tiles_y * kTileH, n_tiles_x * kTileW, bg0, bg1, bg2, rgb, depth);
  return cudaGetLastError();
}
