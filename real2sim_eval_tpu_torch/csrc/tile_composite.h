// C interface of the tile compositors: K1 and K7 (tile_composite.cu), K8
// (tile_backward.cu), K2 (tile_sparse.cu), K6 (tile_sparse_merge.cu), and
// the fine-tile compositors K4 (fine_composite.cu) and K5 (fine_sparse.cu).
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// pairs: (10, n_pairs) f32 attribute lanes; starts/ends: (n_inst *
// n_tiles) i32 pair ranges; rgb: (n_inst, 3, 8 * n_tiles_y, 128 *
// n_tiles_x) f32 and depth: (n_inst, 8 * n_tiles_y, 128 * n_tiles_x) f32,
// written in full. Launches on ``stream``; returns the launch status.
cudaError_t tile_composite_launch(const float* pairs, long long n_pairs,
                                  const int* starts, const int* ends,
                                  int n_inst, int n_tiles_x, int n_tiles_y,
                                  float bg0, float bg1, float bg2, float* rgb,
                                  float* depth, cudaStream_t stream);

// K7: K1 writing the final transmittance t_fin (n_inst, 8 * n_tiles_y,
// 128 * n_tiles_x) f32 as well; rgb and depth are K1's bitwise.
cudaError_t tile_composite_t_launch(const float* pairs, long long n_pairs,
                                    const int* starts, const int* ends,
                                    int n_inst, int n_tiles_x, int n_tiles_y,
                                    float bg0, float bg1, float bg2,
                                    float* rgb, float* depth, float* t_fin,
                                    cudaStream_t stream);

// K8 (tile_backward.cu): per-pair gradients of K7's rgb and depth. dl_rgb
// and c_fin (the bg-free colour rgb - t_fin * bg) are shaped as rgb,
// dl_depth and t_fin as depth; order: a permutation of the n_inst * n_tiles
// (instance, tile) indices, the order in which CTAs take them; grads (10,
// n_pairs) f32 in the pair table's lane order, zeroed by the caller: the
// kernel writes the pairs each tile reaches before its pixels are all
// frozen.
cudaError_t tile_backward_launch(const float* pairs, long long n_pairs,
                                 const int* starts, const int* ends,
                                 const int* order, int n_inst,
                                 int n_tiles_x, int n_tiles_y,
                                 const float* dl_rgb, const float* dl_depth,
                                 const float* c_fin, const float* t_fin,
                                 float bg0, float bg1, float bg2,
                                 float* grads, cudaStream_t stream);

// K2: for each of the n_dirty entries, the tile tile_ids[k] of instance
// inst_ids[k] is re-composited from pairs[starts[k], ends[k]) into rgb and
// depth (shaped as for K1); every other pixel is left as it is.
cudaError_t tile_sparse_launch(const float* pairs, long long n_pairs,
                               const int* inst_ids, const int* tile_ids,
                               const int* starts, const int* ends,
                               int n_dirty, int n_inst, int n_tiles_x,
                               int n_tiles_y, float bg0, float bg1, float bg2,
                               float* rgb, float* depth, cudaStream_t stream);

// K6: as K2, but entry k blends the depth merge of the static segment
// data_s[s_starts[k], s_ends[k]) and the dynamic segment
// data_d[d_starts[k], d_ends[k]) (both (10, n) f32, depth-sorted), a
// dynamic pair first on equal depth.
cudaError_t tile_sparse_merge_launch(
    const float* data_s, long long n_s, const float* data_d, long long n_d,
    const int* inst_ids, const int* tile_ids, const int* s_starts,
    const int* s_ends, const int* d_starts, const int* d_ends, int n_dirty,
    int n_inst, int n_tiles_x, int n_tiles_y, float bg0, float bg1,
    float bg2, float* rgb, float* depth, cudaStream_t stream);

// K4: K1 over 8x16 fine tiles. starts/ends: (n_inst * n_fine_x *
// n_tiles_y) i32 pair ranges of fine tile ty * n_fine_x + tx; order: a
// permutation of those (instance, fine tile) indices, the order in which
// CTAs take them; rgb: (n_inst, 3, 8 * n_tiles_y, 16 * n_fine_x) f32 and
// depth: (n_inst, 8 * n_tiles_y, 16 * n_fine_x) f32, written in full.
cudaError_t fine_composite_launch(const float* pairs, long long n_pairs,
                                  const int* starts, const int* ends,
                                  const int* order, int n_inst, int n_fine_x,
                                  int n_tiles_y, float bg0, float bg1,
                                  float bg2, float* rgb, float* depth,
                                  cudaStream_t stream);

// K5: K2 over 8x16 fine tiles: for each of the n_dirty entries, fine tile
// tile_ids[k] of instance inst_ids[k] is re-composited from
// pairs[starts[k], ends[k]) into rgb and depth (shaped as for K4); every
// other pixel is left as it is. order: a permutation of the entries, the
// order in which CTAs take them.
cudaError_t fine_sparse_launch(const float* pairs, long long n_pairs,
                               const int* inst_ids, const int* tile_ids,
                               const int* starts, const int* ends,
                               const int* order, int n_dirty, int n_inst,
                               int n_fine_x, int n_tiles_y, float bg0,
                               float bg1, float bg2, float* rgb, float* depth,
                               cudaStream_t stream);

#ifdef __cplusplus
}
#endif
