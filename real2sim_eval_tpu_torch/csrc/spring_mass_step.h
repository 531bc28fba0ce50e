// C interface of the spring-mass control step (spring_mass_step.cu).
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// All tensors contiguous on one device. Shapes: B envs, N particles, R
// spring records, M self-collision particles x Ks slots, PM contact
// candidates, C colliders (fingers first), S substeps.
struct SpringStepArgs {
  int B, N, R, M, Ks, PM, C, n_f, F, S;
  float dt, gz, rev, ground, cdist;
  int use_pusher;
  int ranks;               // CTAs per env: 1, or 2 in a thread-block cluster
  int drift_ns;            // > 0: the drift test's delays (see the source)
  const float* x;          // (B, N, 3)
  const float* v;          // (B, N, 3)
  const float* masses;     // (N,)
  const int* row_ptr;      // (N + 1,) particle i's records [row_ptr[i], row_ptr[i + 1])
  const float4* records;   // (R,) {j (int bits), stiffness, damping, rest}
  const float* scal;       // (8,) elas/fric ground, eef, self; drag decay
  const int* sc_sel;       // (B, M) self-collision particles
  const int* sc_idx;       // (B, M, Ks) their frozen candidates
  const int* sc_ok;        // (B, M, Ks) candidate valid
  const float* sc_invm;    // (B, M, Ks) 1/m_i + 1/m_j
  const float* sc_msel;    // (B, M) m_i
  const int* c_inv;        // (B, N) contact slot of each particle, -1 none
  const int* c_ok;         // (B, PM) contact slot in reach
  const float* pose;       // (B, S, C, 24) [Tinv 3x4 | R 3x3 | eef centre]
  const float* dyn_lin;    // (B, max(n_f, 1), 3) finger surface velocity
  const float* dyn_omega;  // (B, 3)
  const float* corners;    // (cells, 8) packed SDF cell corners
  const float* g_origin;   // (C, 3)
  const float* g_isp;      // (C,) inverse voxel size
  const int* g_dims;       // (C, 3)
  const long long* g_off;  // (C,) first cell of each collider
  float* x_out;            // (B, N, 3)
  float* v_out;            // (B, N, 3)
  float* ff_out;           // (B, F, 3) last-substep finger forces
};

// Runs all S substeps of every env on ``stream``: one CTA per env
// (ranks 1) or a cluster of two (ranks 2).
cudaError_t spring_mass_step_launch(const struct SpringStepArgs* a,
                                    cudaStream_t stream);

#ifdef __cplusplus
}
#endif
