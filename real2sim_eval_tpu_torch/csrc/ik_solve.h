// C interface of the damped-least-squares IK solve (ik_solve.cu).
#pragma once

#include <cuda_runtime.h>

#ifdef __cplusplus
extern "C" {
#endif

// Floats per link of the packed chain table (kinematics/ik.py
// pack_chain): [joint type (0 fixed, 1 revolute, 2 prismatic), dof index
// (-1 if fixed), axis x y z, parent->joint origin (4 x 4, row-major),
// three zeros].
#define IK_TABLE_WIDTH 24
#define IK_MAX_PATH 32      // links on the root -> eef path
#define IK_MAX_ACTIVE 31    // tangent directions: one thread each
#define IK_MAX_DOF 64       // width of q

// All pointers to contiguous float32 device memory of one device.
struct IkSolveArgs {
  int E;                 // lanes
  int n;                 // width of q: n_active solved joints, the rest held
  int n_active;
  int n_path;
  int iters;             // Gauss-Newton steps
  float damping, step_scale, pos_tol, rot_tol;
  const float* table;    // (n_path, IK_TABLE_WIDTH), root first
  const float* q_init;   // (E, n)
  const float* target;   // (E, 4, 4)
  float* q_out;          // (E, n)
};

cudaError_t ik_solve_launch(const IkSolveArgs* args, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
