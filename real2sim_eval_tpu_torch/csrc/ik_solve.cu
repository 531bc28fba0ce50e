// Damped-least-squares IK: the whole solve of kinematics/ik.py make_ik_fn
// (32 Gauss-Newton steps on the 6D twist error, then the verify and
// fallback) in one launch.
//
// Replaces no TPU kernel: the JAX package leaves kinematics/ik.py to XLA.
// Eagerly on the card a Gauss-Newton step is some 300 small PyTorch
// operations; replayed as one CUDA graph the solve was ~30,000 kernels of
// ~1.2 us each, ~36 ms a call at 64 lanes, launch and tail latency almost
// all of it.
//
// Design. One warp per lane (grid E, 32 threads). Thread 0 carries the
// primal: the pose P down the ancestor path, the pose error and its
// rotation log. Thread 1 + k carries the tangent along joint k < n_active:
// dP_k by the product rule and the derivative of the error, J's column k.
// At each link of the path the warp meets twice (__syncwarp): once thread
// 0 has put the link's transform L in shared memory, and once every
// tangent has read it and the previous pose. Threads 0-5 then form
// J J^T + damping I from the columns in shared memory, thread 0 factors
// and solves the 6 x 6 system, and each tangent thread steps its joint.
// The chain table, q and the small matrices stay in shared memory and
// registers across the steps: the kernel reads the table, q_init and the
// target once and writes q_out once.
//
// Bound: latency. A lane's step is ~5,000 flops in dependent chains (the
// 4 x 4 products down the path, the 6 x 6 elimination on one thread), 32
// steps in a row; no bytes or rates of the SM come near a limit. Spreading
// the 1 + n_active directions over threads makes a step one walk of the
// path instead of 1 + n_active.
//
// Numerics: bitwise the eager solve on the card (TF32 off). Each eager
// operation is done once, in the eager order, rounded as the card rounds
// it (found on an H100 with PyTorch 2.11 and CUDA 12.8 by dumping every
// stage of the eager solve; tests/test_torch_ik_card.py holds it):
//   - matrix products (the FK's 4 x 4 and their tangents, the 3 x 3
//     rotation error, J J^T): each entry fused multiply-adds in ascending
//     k from zero, as cuBLAS does at these shapes, except for a (4, 4) @
//     (4, 4), any product at E = 1, and a pose times a fixed link's origin
//     at E <= 4: there cuBLAS sums k = 0, 1 and k = 2, 3 so and adds the
//     two; and at E = 1 the rotation error is rounded products added
//     unfused (mm4, rot_err, and the kernel's note on which product is
//     which);
//   - J^T sol: k = 0..2 and k = 3..5 each so, then the two added (cuBLAS
//     splits that K = 6 product in two at every E);
//   - solve_ex: LU with partial pivoting (the first largest |a| of the
//     column, whole rows swapped), multipliers times the pivot's
//     reciprocal, updates a - l u fused; then the swaps on the right-hand
//     side, the unit-lower and the upper substitution column by column,
//     fused, the latter dividing by the pivot;
//   - reductions as PyTorch's reduction tree adds (each square rounded):
//     3 entries (0 + 2) + 1, 4 entries (0 + 2) + (1 + 3), 9 entries
//     (((0 + 8) + 4) + (2 + 6)) + ((1 + 5) + (3 + 7));
//   - elementwise: one IEEE rounding per PyTorch operation, no contraction
//     (--fmad=false), cosf, sinf, atan2f, IEEE division and square root;
//     clamp passes NaN, argmax takes the first largest score (a NaN first).

#include "ik_solve.h"

#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr float kQuatEps = 1e-12f;     // tf.rot_to_quat's eps
constexpr float kAngleEps = 1e-8f;     // tf.rot_to_axis_angle's eps

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return is_nan(x) ? x : (x < lo ? lo : x);
}

// C = A @ B, 4 x 4 row-major; C may alias A or B. Each entry fused
// multiply-adds in ascending k from zero; with ``split`` k = 0, 1 and
// k = 2, 3 each so, then the two added. cuBLAS sums so (found on the
// card) for a (4, 4) @ (4, 4), for any product at E = 1, and for an
// (E, 4, 4) pose times a fixed link's (4, 4) origin at E <= 4 (the kernel
// says which product is which).
__device__ __forceinline__ void mm4(const float* A, const float* B, float* C,
                                    bool split = false) {
  float out[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo =
          fmaf(A[4 * i + 1], B[4 + j], fmaf(A[4 * i], B[j], 0.0f));
      if (split) {
        const float hi = fmaf(A[4 * i + 3], B[12 + j],
                              fmaf(A[4 * i + 2], B[8 + j], 0.0f));
        out[4 * i + j] = lo + hi;
      } else {
        out[4 * i + j] =
            fmaf(A[4 * i + 3], B[12 + j], fmaf(A[4 * i + 2], B[8 + j], lo));
      }
    }
#pragma unroll
  for (int i = 0; i < 16; ++i) C[i] = out[i];
}

// chain.py _rot_about_axis / _prismatic (d = false) and ik.py
// _rot_about_axis_d / _prismatic_d (d = true) of one joint
__device__ void joint_motion(int jt, const float* axis, float v, bool d,
                             float* m) {
  const float x = axis[0], y = axis[1], z = axis[2];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = 0.0f;
  if (jt == 2) {
    if (d) {
      m[3] = x;
      m[7] = y;
      m[11] = z;
    } else {
      m[0] = m[5] = m[10] = m[15] = 1.0f;
      m[3] = x * v;
      m[7] = y * v;
      m[11] = z * v;
    }
    return;
  }
  const float c = cosf(v), s = sinf(v);
  const float xx = x * x, xy = x * y, xz = x * z;
  const float yy = y * y, yz = y * z, zz = z * z;
  if (d) {
    m[0] = -s + xx * s;
    m[1] = xy * s - z * c;
    m[2] = xz * s + y * c;
    m[4] = xy * s + z * c;
    m[5] = -s + yy * s;
    m[6] = yz * s - x * c;
    m[8] = xz * s - y * c;
    m[9] = yz * s + x * c;
    m[10] = -s + zz * s;
  } else {
    const float C = 1.0f - c;
    m[0] = c + xx * C;
    m[1] = xy * C - z * s;
    m[2] = xz * C + y * s;
    m[4] = xy * C + z * s;
    m[5] = c + yy * C;
    m[6] = yz * C - x * s;
    m[8] = xz * C - y * s;
    m[9] = yz * C + x * s;
    m[10] = c + zz * C;
    m[15] = 1.0f;
  }
}

// The link's local transform: origin @ motion (split: a batch of one), or
// the origin of a fixed link
__device__ void link_local(const float* row, const float* q, float* L,
                           bool split) {
  const int jt = (int)row[0];
  if (jt == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) L[i] = row[5 + i];
    return;
  }
  float m[16];
  joint_motion(jt, row + 2, q[(int)row[1]], false, m);
  mm4(row + 5, m, L, split);
}

// The primal rotation log's values the tangents read (ik.py
// _rot_to_quat_jvp, _rot_to_axis_angle_jvp)
struct Primal {
  int best;          // argmax of the four scores
  int pivot_ok;      // pivot > eps: the square root's derivative is taken
  float s;           // 2 sqrt(max(pivot, eps))
  float a[4];        // the candidate's entries before division by s
  float qn[4];       // the normalised quaternion
  float norm;        // its norm before normalising
  float sign;        // -1 if qn[0] < 0
  float w;           // clamp(sign qn[0], -1, 1)
  int w_inside;      // -1 < sign qn[0] < 1
  float xyz[3];      // sign qn[1:]
  float n3, nc;      // |xyz|, max(|xyz|, eps)
  int small;         // |xyz| < eps
  float theta, scale;
};

// The four candidates' pivots and off-pivot entries of tf.rot_to_quat, in
// the eager order, from the 3 x 3 matrix m (row-major): (pivot, entries)
// of candidate b; the entry at index b is left unset.
__device__ __forceinline__ float quat_candidate(const float* m, int b,
                                               float* a, bool tangent) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4],
              m12 = m[5], m20 = m[6], m21 = m[7], m22 = m[8];
  // the pivots' leading term: 1 + ... in the primal, none in the tangent
  switch (b) {
    case 0:
      a[1] = m21 - m12;
      a[2] = m02 - m20;
      a[3] = m10 - m01;
      return tangent ? (m00 + m11) + m22 : 1.0f + ((m00 + m11) + m22);
    case 1:
      a[0] = m21 - m12;
      a[2] = m01 + m10;
      a[3] = m02 + m20;
      return tangent ? (m00 - m11) - m22 : ((1.0f + m00) - m11) - m22;
    case 2:
      a[0] = m02 - m20;
      a[1] = m01 + m10;
      a[3] = m12 + m21;
      return tangent ? (-m00 + m11) - m22 : ((1.0f - m00) + m11) - m22;
    default:
      a[0] = m10 - m01;
      a[1] = m02 + m20;
      a[2] = m12 + m21;
      return tangent ? (-m00 - m11) + m22 : ((1.0f - m00) - m11) + m22;
  }
}

__device__ void primal_log(const float* m, Primal& p) {
  const float tr = (m[0] + m[4]) + m[8];
  const float sc[4] = {tr, (m[0] - m[4]) - m[8], (m[4] - m[0]) - m[8],
                       (m[8] - m[0]) - m[4]};
  int best = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (!is_nan(sc[best]) && (is_nan(sc[i]) || sc[i] > sc[best])) best = i;
  p.best = best;
  float q[4];
  const float pivot = quat_candidate(m, best, p.a, false);
  p.pivot_ok = pivot > kQuatEps;
  const float r = sqrtf(clamp_min(pivot, kQuatEps));
  p.s = r * 2.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = j == best ? 0.25f * p.s : p.a[j] / p.s;
  p.norm = sqrtf((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]));
  const float nq = clamp_min(p.norm, kQuatEps);
#pragma unroll
  for (int j = 0; j < 4; ++j) p.qn[j] = q[j] / nq;
  p.sign = p.qn[0] < 0.0f ? -1.0f : 1.0f;
  const float q0 = p.qn[0] * p.sign;
  p.w = is_nan(q0) ? q0 : fminf(fmaxf(q0, -1.0f), 1.0f);
  p.w_inside = q0 > -1.0f && q0 < 1.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) p.xyz[j] = p.qn[j + 1] * p.sign;
  const float x = p.xyz[0], y = p.xyz[1], z = p.xyz[2];
  p.n3 = sqrtf((x * x + z * z) + y * y);
  p.theta = 2.0f * atan2f(p.n3, p.w);
  p.small = p.n3 < kAngleEps;
  p.nc = clamp_min(p.n3, kAngleEps);
  p.scale = p.small ? 2.0f : p.theta / p.nc;
}

// The rotation log's derivative along dm (the tangent of the error matrix)
__device__ void tangent_log(const float* dm, const Primal& p, float* daa) {
  float da[4], dq[4];
  const float dpivot = quat_candidate(dm, p.best, da, true);
  const float dr = p.pivot_ok ? dpivot / p.s : 0.0f;   // dx / (2 sqrt x)
  const float ds = dr * 2.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    dq[j] = j == p.best ? 0.25f * ds
                        : da[j] / p.s - (p.a[j] * ds) / (p.s * p.s);
  const float dot = (p.qn[0] * dq[0] + p.qn[2] * dq[2]) +
                    (p.qn[1] * dq[1] + p.qn[3] * dq[3]);
  float dqs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    dqs[j] = ((dq[j] - p.qn[j] * dot) / p.norm) * p.sign;
  const float dw = p.w_inside ? dqs[0] : 0.0f;
  const float x = p.xyz[0], y = p.xyz[1], z = p.xyz[2];
  const float s3 = (x * dqs[1] + z * dqs[3]) + y * dqs[2];
  const float dn = s3 / p.nc;
  const float dtheta =
      (2.0f * (p.w * dn - p.n3 * dw)) / (p.n3 * p.n3 + p.w * p.w);
  const float dscale =
      p.small ? 0.0f : (dtheta * p.nc - p.theta * dn) / (p.nc * p.nc);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    daa[j] = dqs[j + 1] * p.scale + p.xyz[j] * dscale;
}

// R_t @ X[:3, :3]^T of the target's and a 4 x 4's rotation blocks; with
// ``plain`` (cuBLAS's order for one (1, 3, 3) batch) the products rounded
// and added in ascending k, unfused
__device__ __forceinline__ void rot_err(const float* T, const float* X,
                                       float* m, bool plain = false) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float acc;
      if (plain) {
        acc = T[4 * a] * X[4 * b];
#pragma unroll
        for (int j = 1; j < 3; ++j) acc = acc + T[4 * a + j] * X[4 * b + j];
      } else {
        acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          acc = fmaf(T[4 * a + j], X[4 * b + j], acc);
      }
      m[3 * a + b] = acc;
    }
}

// torch.linalg.solve_ex(A, b) of one 6 x 6 system, in place
__device__ void solve6(float* A, float* b) {
  int piv[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float big = fabsf(A[6 * k + k]);
    for (int i = k + 1; i < 6; ++i) {
      const float v = fabsf(A[6 * i + k]);
      if (v > big) {
        big = v;
        p = i;
      }
    }
    piv[k] = p;
    if (p != k)
      for (int j = 0; j < 6; ++j) {
        const float t = A[6 * k + j];
        A[6 * k + j] = A[6 * p + j];
        A[6 * p + j] = t;
      }
    const float rcp = 1.0f / A[6 * k + k];
    for (int i = k + 1; i < 6; ++i) A[6 * i + k] = A[6 * i + k] * rcp;
    for (int i = k + 1; i < 6; ++i)
      for (int j = k + 1; j < 6; ++j)
        A[6 * i + j] = fmaf(-A[6 * i + k], A[6 * k + j], A[6 * i + j]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float t = b[k];
    b[k] = b[piv[k]];
    b[piv[k]] = t;
  }
  for (int k = 0; k < 6; ++k)
    for (int i = k + 1; i < 6; ++i) b[i] = fmaf(-A[6 * i + k], b[k], b[i]);
  for (int k = 5; k >= 0; --k) {
    b[k] = b[k] / A[6 * k + k];
    for (int i = 0; i < k; ++i) b[i] = fmaf(-A[6 * i + k], b[k], b[i]);
  }
}

__global__ void __launch_bounds__(kWarp) ik_solve_kernel(const IkSolveArgs a) {
  __shared__ float tab[IK_MAX_PATH * IK_TABLE_WIDTH];
  __shared__ float q[IK_MAX_DOF];
  __shared__ float L_sh[16], P_sh[16];
  __shared__ float J[IK_MAX_ACTIVE][6];     // de of each tangent direction
  __shared__ float A[36];
  __shared__ float sol[6];
  __shared__ Primal prim;
  __shared__ int ok_sh;

  const int t = threadIdx.x;
  const int k = t - 1;                      // the tangent's joint
  const bool tangent = t >= 1 && t <= a.n_active;
  // The eager products' shapes decide cuBLAS's order (mm4): at E = 1 every
  // (E, 4, 4) product is a batch of one (split, and rot_err plain); an
  // (E, 4, 4) @ (4, 4), a pose times a fixed link's origin, is one product
  // of 4 E rows (split for E <= 4). The tangents' products are the same
  // with n_active E in place of E (never split at the n_active of 7 that
  // was measured).
  const bool one = a.E == 1;
  const bool few = a.E <= 4;
  const long long tE = (long long)a.n_active * a.E;
  const bool root_fixed = (int)a.table[0] == 0;
  const long long lane = blockIdx.x;
  for (int i = t; i < a.n_path * IK_TABLE_WIDTH; i += kWarp)
    tab[i] = a.table[i];
  for (int i = t; i < a.n; i += kWarp) q[i] = a.q_init[lane * a.n + i];
  float T[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i] = a.target[lane * 16 + i];
  __syncwarp();

  float M[16];          // P on thread 0, dP_k on tangent thread k
  for (int it = 0; it < a.iters; ++it) {
    // FK down the path and its forward-mode derivative (ik.py fk_link_jvp)
    for (int n = 0; n < a.n_path; ++n) {
      const float* row = tab + n * IK_TABLE_WIDTH;
      const int jt = (int)row[0];
      const bool mine = tangent && jt != 0 && (int)row[1] == k;
      float dL[16];
      if (t == 0) {
        float L[16];
        link_local(row, q, L, one);
#pragma unroll
        for (int i = 0; i < 16; ++i) L_sh[i] = L[i];
      }
      if (mine) {
        float dm[16];
        joint_motion(jt, row + 2, q[k], true, dm);
        mm4(row + 5, dm, dL, one);
      }
      __syncwarp();
      if (n == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          M[i] = t == 0 ? L_sh[i] : (mine ? dL[i] : 0.0f);
      } else if (t == 0 || tangent) {
        // P @ L: E batches where L moves, or where P is still the root's
        // origin expanded over the lanes; else 4 E rows times the origin
        const bool by_rows = jt == 0 && !(n == 1 && root_fixed);
        mm4(M, L_sh, M,
            t == 0 ? (by_rows ? few : one) : (jt != 0 ? tE == 1 : tE <= 4));
        if (mine) {
          float PdL[16];
          mm4(P_sh, dL, PdL, one);
#pragma unroll
          for (int i = 0; i < 16; ++i) M[i] = M[i] + PdL[i];
        }
      }
      __syncwarp();
      if (t == 0)
#pragma unroll
        for (int i = 0; i < 16; ++i) P_sh[i] = M[i];
    }
    // the twist error and its derivative (ik.py pose_error_jvp)
    float e[6];
    if (t == 0) {
      float m[9];
      rot_err(T, M, m, one);
      Primal p;
      primal_log(m, p);
      prim = p;
      e[0] = T[3] - M[3];
      e[1] = T[7] - M[7];
      e[2] = T[11] - M[11];
#pragma unroll
      for (int j = 0; j < 3; ++j) e[3 + j] = p.xyz[j] * p.scale;
    }
    __syncwarp();
    if (tangent) {
      float dm[9], daa[3];
      rot_err(T, M, dm);
      tangent_log(dm, prim, daa);
      J[k][0] = -M[3];
      J[k][1] = -M[7];
      J[k][2] = -M[11];
#pragma unroll
      for (int j = 0; j < 3; ++j) J[k][3 + j] = daa[j];
    }
    __syncwarp();
    // J J^T + damping I, a row a thread
    if (t < 6) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float acc = 0.0f;
        for (int j = 0; j < a.n_active; ++j)
          acc = fmaf(J[j][t], J[j][c], acc);
        A[6 * t + c] = acc + (t == c ? a.damping : 0.0f);
      }
    }
    __syncwarp();
    if (t == 0) {
      float Am[36];
#pragma unroll
      for (int i = 0; i < 36; ++i) Am[i] = A[i];
      solve6(Am, e);
#pragma unroll
      for (int i = 0; i < 6; ++i) sol[i] = e[i];
    }
    __syncwarp();
    // qa - step_scale * J^T sol
    if (tangent) {
      float lo = 0.0f, hi = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) lo = fmaf(J[k][r], sol[r], lo);
#pragma unroll
      for (int r = 3; r < 6; ++r) hi = fmaf(J[k][r], sol[r], hi);
      q[k] = q[k] - a.step_scale * (lo + hi);
    }
    __syncwarp();
  }
  // the verify (chain.fk_link, the position and Frobenius rotation gaps)
  if (t == 0) {
    float P[16];
    bool batched = false;         // P has the lanes' dim: a joint passed
    for (int n = 0; n < a.n_path; ++n) {
      const float* row = tab + n * IK_TABLE_WIDTH;
      const bool moves = (int)row[0] != 0;
      float L[16];
      link_local(row, q, L, one);
      if (n == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) P[i] = L[i];
      } else {
        // (4, 4) @ (4, 4) splits; by a joint's (E, 4, 4) at E = 1; a
        // batched pose times an origin by its 4 E rows
        mm4(P, L, P, moves ? one : (batched ? few : true));
      }
      batched = batched || moves;
    }
    const float d0 = P[3] - T[3], d1 = P[7] - T[7], d2 = P[11] - T[11];
    const float pos = sqrtf((d0 * d0 + d2 * d2) + d1 * d1);
    float v[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float d = P[4 * i + j] - T[4 * i + j];
        v[3 * i + j] = d * d;
      }
    const float rot = sqrtf((((v[0] + v[8]) + v[4]) + (v[2] + v[6])) +
                            ((v[1] + v[5]) + (v[3] + v[7])));
    ok_sh = pos <= a.pos_tol && rot <= a.rot_tol;
  }
  __syncwarp();
  for (int i = t; i < a.n; i += kWarp)
    a.q_out[lane * a.n + i] = ok_sh ? q[i] : a.q_init[lane * a.n + i];
}

}  // namespace

extern "C" cudaError_t ik_solve_launch(const IkSolveArgs* a,
                                       cudaStream_t stream) {
  if (a->n_path < 1 || a->n_path > IK_MAX_PATH || a->n_active < 0 ||
      a->n_active > IK_MAX_ACTIVE || a->n_active > a->n || a->n > IK_MAX_DOF)
    return cudaErrorInvalidValue;
  if (a->E == 0) return cudaSuccess;
  ik_solve_kernel<<<a->E, kWarp, 0, stream>>>(*a);
  return cudaGetLastError();
}
