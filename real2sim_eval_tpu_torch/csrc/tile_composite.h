// C interface of the tile compositor (tile_composite.cu).
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

#ifdef __cplusplus
}
#endif
