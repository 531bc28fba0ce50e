// Spring-mass control step: every substep of one control step in one launch.
//
// Replaces the TPU Pallas kernel K3 (the JAX package's physics/
// pallas_step.py: _kernel via make_pallas_step_fn); computes what
// the JAX package's physics/spring_mass.py make_step_fn computes, batched
// over envs.
//
// Design. Positions and velocities live in shared memory as
// structure-of-arrays for all S substeps, in two copies: substep s reads
// copy s % 2 and writes copy (s + 1) % 2. Each substep is four phases
// separated by barriers:
//   A. spring + dashpot forces, gravity, drag -> v1. Each particle walks
//      its compacted spring records (physics/fused_step.py
//      spring_records): only the neighbour slots whose stiffness or
//      damping is nonzero, one 16-byte record {j, k, c, rest} each, in
//      ascending slot order, so every particle's operations and their
//      order are those of the dense table with its inactive slots skipped.
//      A record is one __ldg, and the next kPrefetch records load while
//      the current ones are used, so an L2 read's latency is not exposed
//      behind a branch on the slot's activity; the neighbours' x and v are
//      CTA-local gathers from shared memory;
//   B. self-collision impulses over the frozen (M x Ks) candidate slots,
//      which read other particles' v1 (computed, barrier, then written);
//   C. SDF contact for the frozen candidate particles against C colliders,
//      sampling each collider's full grid trilinearly from global memory;
//   D. ground response and integration (the reference's double advance
//      when colliders exist).
// Every thread owns one particle (and the particle 1024 further on, and
// so on, above 1024 particles) in A, C and D. Two launches compute
// bitwise the same step:
//   ranks 2 (the main path): a cluster of two CTAs of 1024 threads per
//      env, so 64 envs fill 128 of the 132 SMs. Each CTA owns half the
//      particles and keeps a full mirror of x, v and v1. After phase A it
//      stores its half's v1 into the other CTA's mirror (distributed
//      shared memory), and in phase D its half's new x and v into the
//      other CTA's next copy; a cluster barrier (release/acquire) follows
//      each. Both CTAs compute every self-collision row (the same inputs
//      give the same rows), so phase B exchanges nothing, and the contact
//      slots of the last substep are stored into both CTAs. The two
//      copies of x and v make the exchange safe: the other CTA may still
//      read this substep's copy in phase B while this one writes the next.
//      drift_ns > 0 delays one CTA of each pair by varying amounts at
//      every phase boundary (the drift test, chip_smoke.py check_k3_drift),
//      which must leave the result bitwise that of ranks 1;
//   ranks 1: one CTA of 1024 threads per env, the drift test's reference.
// The per-control-step freezes (candidate slots, contact candidates, the
// per-substep collider poses) are computed by PyTorch outside the kernel,
// as XLA computes them outside the Pallas kernel. The TPU kernel's SDF
// patches, rolled spring tables and RCM permutation exist only because
// Mosaic has no general gather; here gathers are native, so none of them is
// carried and the patch-escape telemetry is 0 by construction.
//
// Bound: ~30 f32 operations (four IEEE divisions and a square root among
// them) per active spring slot and substep; the records (16 B per active
// slot, shared by all envs) stay in L2. Phase A is most of a substep, and
// each thread's walk of its ~31 records is bound by its chain of
// dependent operations, not by the SM's instruction rate (PERF.md).
// Shared memory: 15 N + 3 M + 4 PM words, so N up
// to ~3,700 particles. Numerics: no fast math, no contracted multiply-adds
// (--fmad=false), every formula in the order of spring_mass.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "spring_mass_step.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxColliders = 8;
constexpr int kPoseRow = 24;
constexpr int kPrefetch = 2;

struct Colliders {
  float origin[kMaxColliders][3];
  float isp[kMaxColliders];
  int dims[kMaxColliders][3];
  long long off[kMaxColliders];
};

// Trilinear SDF value and world-unaware unit gradient of collider c at the
// collider-frame point (px, py, pz); 1e3 outside the grid (sdf_query).
__device__ float sdf_query(const Colliders& g, const float* __restrict__ corners,
                           int c, float px, float py, float pz, float* nl) {
  const float isp = g.isp[c];
  const float ux = (px - g.origin[c][0]) * isp;
  const float uy = (py - g.origin[c][1]) * isp;
  const float uz = (pz - g.origin[c][2]) * isp;
  const float hx = (float)(g.dims[c][0] - 1);
  const float hy = (float)(g.dims[c][1] - 1);
  const float hz = (float)(g.dims[c][2] - 1);
  const bool inside = ux >= 0.0f && uy >= 0.0f && uz >= 0.0f && ux <= hx &&
                      uy <= hy && uz <= hz;
  const float cx = fminf(fmaxf(ux, 0.0f), hx - 1e-4f);
  const float cy = fminf(fmaxf(uy, 0.0f), hy - 1e-4f);
  const float cz = fminf(fmaxf(uz, 0.0f), hz - 1e-4f);
  const int ix = (int)floorf(cx), iy = (int)floorf(cy), iz = (int)floorf(cz);
  const float fx = cx - (float)ix, fy = cy - (float)iy, fz = cz - (float)iz;
  const long long cell =
      ((long long)(ix * (g.dims[c][1] - 1) + iy) * (g.dims[c][2] - 1) + iz) +
      g.off[c];
  const float* k = corners + cell * 8;
  const float c000 = k[0], c001 = k[1], c010 = k[2], c011 = k[3];
  const float c100 = k[4], c101 = k[5], c110 = k[6], c111 = k[7];
  const float c00 = c000 * (1 - fz) + c001 * fz;
  const float c01 = c010 * (1 - fz) + c011 * fz;
  const float c10 = c100 * (1 - fz) + c101 * fz;
  const float c11 = c110 * (1 - fz) + c111 * fz;
  const float c0 = c00 * (1 - fy) + c01 * fy;
  const float c1 = c10 * (1 - fy) + c11 * fy;
  const float val = c0 * (1 - fx) + c1 * fx;
  const float gx = (c1 - c0) * isp;
  const float gy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx) * isp;
  const float gz = (((c001 - c000) * (1 - fy) + (c011 - c010) * fy) * (1 - fx) +
                    ((c101 - c100) * (1 - fy) + (c111 - c110) * fy) * fx) *
                   isp;
  const float gl = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-9f);
  nl[0] = gx / gl;
  nl[1] = gy / gl;
  nl[2] = gz / gl;
  return inside ? val : 1e3f;
}

// Distance and world normal of collider c at world point p (this substep).
__device__ float query_world(const Colliders& g,
                             const float* __restrict__ corners,
                             const float* row, int c, const float* p,
                             float* n) {
  const float* r = row + c * kPoseRow;
  const float lx = r[0] * p[0] + r[1] * p[1] + r[2] * p[2] + r[3];
  const float ly = r[4] * p[0] + r[5] * p[1] + r[6] * p[2] + r[7];
  const float lz = r[8] * p[0] + r[9] * p[1] + r[10] * p[2] + r[11];
  float nl[3];
  const float d = sdf_query(g, corners, c, lx, ly, lz, nl);
  n[0] = r[12] * nl[0] + r[13] * nl[1] + r[14] * nl[2];
  n[1] = r[15] * nl[0] + r[16] * nl[1] + r[17] * nl[2];
  n[2] = r[18] * nl[0] + r[19] * nl[1] + r[20] * nl[2];
  return d;
}

// Spring + dashpot force of one particle at (xi, vi) over its records
// [beg, end), in order: the records of the next kPrefetch slots are loaded
// before the current ones are used.
__device__ __forceinline__ void spring_force(
    const float4* __restrict__ rec, int beg, int end, const float* xs,
    const float* vs, int N, float xi0, float xi1, float xi2, float vi0,
    float vi1, float vi2, float& f0, float& f1, float& f2) {
  float4 cur[kPrefetch], nxt[kPrefetch];
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) {
    cur[u] = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    nxt[u] = cur[u];
    if (beg + u < end) cur[u] = __ldg(rec + beg + u);
  }
  for (int r = beg; r < end; r += kPrefetch) {
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u)
      if (r + kPrefetch + u < end) nxt[u] = __ldg(rec + r + kPrefetch + u);
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      if (r + u < end) {
        const int j = __float_as_int(cur[u].x);
        const float kk = cur[u].y, cc = cur[u].z, rest = cur[u].w;
        const float dx = xs[j] - xi0, dy = xs[N + j] - xi1,
                    dz = xs[2 * N + j] - xi2;
        const float len = sqrtf(dx * dx + dy * dy + dz * dz);
        const float m = fmaxf(len, 1e-6f);
        const float ux = dx / m, uy = dy / m, uz = dz / m;
        const float smag = kk * (len / rest - 1.0f);
        const float vrel = (vs[j] - vi0) * ux + (vs[N + j] - vi1) * uy +
                           (vs[2 * N + j] - vi2) * uz;
        const float cmag = cc * vrel;
        f0 = f0 + (smag * ux + cmag * ux);
        f1 = f1 + (smag * uy + cmag * uy);
        f2 = f2 + (smag * uz + cmag * uz);
      }
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) cur[u] = nxt[u];
  }
}

// All threads of the env's CTA (ranks 1) or cluster (ranks 2); the cluster
// barrier releases this CTA's stores into the other CTA's shared memory
// and acquires the other's.
template <int R>
__device__ __forceinline__ void env_barrier() {
  if constexpr (R == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// The drift test's delay at phase boundary ph of substep s: the CTA of
// rank (s + ph) % 2 sleeps, each warp a different multiple of drift_ns.
__device__ __forceinline__ void drift(const SpringStepArgs& a, int rank,
                                      int s, int ph) {
  if (a.drift_ns <= 0 || ((s + ph) & 1) != rank) return;
  const unsigned k = (unsigned)(3 * s + 5 * ph + (threadIdx.x >> 5)) % 8u;
  __nanosleep((unsigned)a.drift_ns * k);
}

template <int R>
__device__ __forceinline__ void step_body(const SpringStepArgs& a) {
  extern __shared__ float smem[];
  __shared__ Colliders g;
  __shared__ float srow[kMaxColliders * kPoseRow];

  const int N = a.N, M = a.M, PM = a.PM, C = a.C, Ks = a.Ks;
  int rank = 0;
  float* peer = nullptr;        // smem of the other CTA of the cluster
  if constexpr (R == 2) {
    cg::cluster_group cl = cg::this_cluster();
    rank = (int)cl.block_rank();
    peer = cl.map_shared_rank(smem, rank ^ 1);
  }
  const int b = blockIdx.x / R;
  const int tid = threadIdx.x;
  const int own = (N + R - 1) / R;
  const int lo = rank * own, hi = min(N, lo + own);   // this CTA's particles
  // smem: [2][x (3, N) | v (3, N)], v1 (3, N), self-collision rows (3, M),
  // last-substep contact forces (3, PM) and fingers (PM), as in the peer
  const int o_svn = 12 * N, o_svb = o_svn + 3 * N, o_sfc = o_svb + 3 * M,
            o_sfi = o_sfc + 3 * PM;
  float* svn = smem + o_svn;
  float* svb = smem + o_svb;
  float* sfc = smem + o_sfc;
  int* sfi = (int*)(smem + o_sfi);

  const float elas_g = a.scal[0], fric_g = a.scal[1];
  const float elas_e = a.scal[2], fric_e = a.scal[3];
  const float elas_s = a.scal[4], fric_s = a.scal[5];
  const float decay = a.scal[6];
  const float dt = a.dt;

  for (int c = tid; c < C; c += kThreads) {
    for (int k = 0; k < 3; ++k) {
      g.origin[c][k] = a.g_origin[c * 3 + k];
      g.dims[c][k] = a.g_dims[c * 3 + k];
    }
    g.isp[c] = a.g_isp[c];
    g.off[c] = a.g_off[c];
  }
  for (int i = tid; i < N; i += kThreads) {
    for (int k = 0; k < 3; ++k) {
      smem[k * N + i] = a.x[((long long)b * N + i) * 3 + k];
      smem[3 * N + k * N + i] = a.v[((long long)b * N + i) * 3 + k];
    }
  }
  // ranks 2: also guarantees the peer runs before anything is stored into
  // its shared memory
  env_barrier<R>();

  const float om0 = C ? a.dyn_omega[b * 3 + 0] : 0.0f;
  const float om1 = C ? a.dyn_omega[b * 3 + 1] : 0.0f;
  const float om2 = C ? a.dyn_omega[b * 3 + 2] : 0.0f;
  const int F_lin = a.n_f > 0 ? a.n_f : 1;

  for (int s = 0; s < a.S; ++s) {
    const int o_cur = (s & 1) * 6 * N;          // this substep's x, v
    const int o_nxt = ((s + 1) & 1) * 6 * N;    // the next one's
    const float* sx = smem + o_cur;
    const float* sv = sx + 3 * N;
    // this substep's collider poses, consumed after the phase-A barrier
    for (int k = tid; k < C * kPoseRow; k += kThreads)
      srow[k] = a.pose[((long long)b * a.S + s) * C * kPoseRow + k];

    // ---- A: springs + dashpots, gravity, drag (velocity_update) --------
    for (int i = lo + tid; i < hi; i += kThreads) {
      const float xi0 = sx[i], xi1 = sx[N + i], xi2 = sx[2 * N + i];
      const float vi0 = sv[i], vi1 = sv[N + i], vi2 = sv[2 * N + i];
      float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
      spring_force(a.records, a.row_ptr[i], a.row_ptr[i + 1], sx, sv, N, xi0,
                   xi1, xi2, vi0, vi1, vi2, f0, f1, f2);
      const float mi = a.masses[i];
      const float a0 = f0 / mi, a1 = f1 / mi, a2 = (f2 + mi * a.gz) / mi;
      const float o0 = (vi0 + a0 * dt) * decay;
      const float o1 = (vi1 + a1 * dt) * decay;
      const float o2 = (vi2 + a2 * dt) * decay;
      svn[i] = o0;
      svn[N + i] = o1;
      svn[2 * N + i] = o2;
      if constexpr (R == 2) {
        float* q = peer + o_svn;
        q[i] = o0;
        q[N + i] = o1;
        q[2 * N + i] = o2;
      }
    }
    drift(a, rank, s, 0);
    env_barrier<R>();
    drift(a, rank, s, 1);

    // ---- B: self-collision over the frozen slots (every row) -----------
    if (M > 0) {
      for (int j = tid; j < M; j += kThreads) {
        const long long base = (long long)b * M + j;
        const int i = a.sc_sel[base];
        const float xi0 = sx[i], xi1 = sx[N + i], xi2 = sx[2 * N + i];
        const float vi0 = svn[i], vi1 = svn[N + i], vi2 = svn[2 * N + i];
        float J0 = 0.0f, J1 = 0.0f, J2 = 0.0f;
        int count = 0;
        for (int k = 0; k < Ks; ++k) {
          if (!a.sc_ok[base * Ks + k]) continue;
          const int jj = a.sc_idx[base * Ks + k];
          const float dx = sx[jj] - xi0, dy = sx[N + jj] - xi1,
                      dz = sx[2 * N + jj] - xi2;
          const float len = sqrtf(dx * dx + dy * dy + dz * dz);
          const float r0 = svn[jj] - vi0, r1 = svn[N + jj] - vi1,
                      r2 = svn[2 * N + jj] - vi2;
          const float dot = dx * r0 + dy * r1 + dz * r2;
          if (!(len < a.cdist && dot < -1e-4f)) continue;
          const float m = fmaxf(len, 1e-6f);
          const float n0 = dx / m, n1 = dy / m, n2 = dz / m;
          const float vn = r0 * n0 + r1 * n1 + r2 * n2;
          const float vn0 = vn * n0, vn1 = vn * n1, vn2 = vn * n2;
          const float invm = a.sc_invm[base * Ks + k];
          const float t0 = r0 - vn0, t1 = r1 - vn1, t2 = r2 - vn2;
          const float vtl = fmaxf(sqrtf(t0 * t0 + t1 * t1 + t2 * t2), 1e-6f);
          const float at = fmaxf(
              0.0f, 1.0f - fric_s * (1.0f + elas_s) * fabsf(vn) / vtl);
          const float sn = -(1.0f + elas_s);
          J0 = J0 + ((sn * vn0) / invm + ((at - 1.0f) * t0) / invm);
          J1 = J1 + ((sn * vn1) / invm + ((at - 1.0f) * t1) / invm);
          J2 = J2 + ((sn * vn2) / invm + ((at - 1.0f) * t2) / invm);
          ++count;
        }
        float o0 = vi0, o1 = vi1, o2 = vi2;
        if (count > 0) {
          const float cnt = (float)count;
          const float ms = a.sc_msel[base];
          o0 = vi0 - (J0 / cnt) / ms;
          o1 = vi1 - (J1 / cnt) / ms;
          o2 = vi2 - (J2 / cnt) / ms;
        }
        svb[j] = o0;
        svb[M + j] = o1;
        svb[2 * M + j] = o2;
      }
      __syncthreads();
      for (int j = tid; j < M; j += kThreads) {
        const int i = a.sc_sel[(long long)b * M + j];
        svn[i] = svb[j];
        svn[N + i] = svb[M + j];
        svn[2 * N + i] = svb[2 * M + j];
      }
      __syncthreads();
    }
    drift(a, rank, s, 2);

    // ---- C + D: contact for candidates, ground, integrate (own particle)
    const bool last = s == a.S - 1;
    for (int i = lo + tid; i < hi; i += kThreads) {
      float x[3] = {sx[i], sx[N + i], sx[2 * N + i]};
      float v[3] = {svn[i], svn[N + i], svn[2 * N + i]};
      if (C > 0) {
        const float nx[3] = {x[0] + v[0] * dt, x[1] + v[1] * dt,
                             x[2] + v[2] * dt};
        const int j = a.c_inv[(long long)b * N + i];
        const bool ok = j >= 0 && a.c_ok[(long long)b * PM + j];
        float fc[3] = {0.0f, 0.0f, 0.0f};
        int fi = 0;
        if (ok) {
          float dist = 0.0f, nrm[3] = {0.0f, 0.0f, 0.0f};
          int best = 0;
          for (int c = 0; c < C; ++c) {
            float n[3];
            const float d = query_world(g, a.corners, srow, c, nx, n);
            if (c == 0 || d < dist) {
              dist = d;
              best = c;
              nrm[0] = n[0];
              nrm[1] = n[1];
              nrm[2] = n[2];
            }
          }
          const bool is_dyn = best < a.n_f;
          const int finger = min(best, max(a.n_f - 1, 0));
          const bool in_range = fabsf(dist) < 0.02f;
          const float margin = (is_dyn && !a.use_pusher) ? 0.005f : 0.001f;
          const float err = dist - margin;
          const bool contact = in_range && err < 0.0f;
          const float* ctr = srow + 21;
          const float* lin = a.dyn_lin + ((long long)b * F_lin + finger) * 3;
          const float r0 = x[0] - ctr[0], r1 = x[1] - ctr[1],
                      r2 = x[2] - ctr[2];
          const float vs[3] = {lin[0] + (om1 * r2 - om2 * r1),
                               lin[1] + (om2 * r0 - om0 * r2),
                               lin[2] + (om0 * r1 - om1 * r0)};
          float vr[3];
          for (int k = 0; k < 3; ++k) vr[k] = is_dyn ? v[k] - vs[k] : v[k];
          const float el = is_dyn ? elas_e : elas_g;
          const float fr = is_dyn ? fric_e : fric_g;
          const float vn = vr[0] * nrm[0] + vr[1] * nrm[1] + vr[2] * nrm[2];
          float vnv[3], vt[3];
          for (int k = 0; k < 3; ++k) {
            vnv[k] = vn * nrm[k];
            vt[k] = vr[k] - vnv[k];
          }
          const float vtl =
              fmaxf(sqrtf(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2]),
                    1e-6f);
          const float at =
              fmaxf(0.0f, 1.0f - fr * (1.0f + el) * fabsf(vn) / vtl);
          float vnn[3], vnew[3];
          for (int k = 0; k < 3; ++k) {
            vnn[k] = -el * vnv[k];
            float resp = vnn[k] + at * vt[k];
            if (is_dyn) resp = resp + vs[k];
            vnew[k] = contact ? resp : v[k];
          }
          float xo[3] = {nx[0], nx[1], nx[2]};
          if (contact) {
            if (is_dyn) {
              const float n2x[3] = {x[0] + vnew[0] * dt, x[1] + vnew[1] * dt,
                                    x[2] + vnew[2] * dt};
              float n2[3];
              const float d2 = query_world(g, a.corners, srow, finger, n2x, n2);
              const float err2 = d2 - margin;
              const bool hit2 = fabsf(d2) < 0.02f && err2 < 0.0f;
              for (int k = 0; k < 3; ++k)
                xo[k] = hit2 ? n2x[k] - n2[k] * err2 : n2x[k];
            } else {
              for (int k = 0; k < 3; ++k) xo[k] = nx[k] - nrm[k] * err;
            }
          }
          if (last && contact && is_dyn) {
            for (int k = 0; k < 3; ++k) fc[k] = (vnn[k] - vnv[k]) / dt;
          }
          fi = finger;
          for (int k = 0; k < 3; ++k) {
            x[k] = xo[k];
            v[k] = vnew[k];
          }
        } else {
          for (int k = 0; k < 3; ++k) x[k] = nx[k];
        }
        if (last && j >= 0) {
          for (int k = 0; k < 3; ++k) sfc[k * PM + j] = fc[k];
          sfi[j] = fi;
          if constexpr (R == 2) {
            for (int k = 0; k < 3; ++k) peer[o_sfc + k * PM + j] = fc[k];
            ((int*)(peer + o_sfi))[j] = fi;
          }
        }
      }
      // ground response with time-of-impact integration
      const float rev = a.rev;
      const float next_z = (x[2] + v[2] * dt) * rev;
      const bool colliding = next_z < a.ground && v[2] * rev < -1e-4f;
      float vo[3] = {v[0], v[1], v[2]};
      float toi = 0.0f;
      if (colliding) {
        const float vn = v[2] * rev;
        const float vnz = vn * rev;
        const float t0 = v[0], t1 = v[1], t2 = v[2] - vnz;
        const float vtl =
            fmaxf(sqrtf(t0 * t0 + t1 * t1 + t2 * t2), 1e-6f);
        const float at =
            fmaxf(0.0f, 1.0f - fric_g * (1.0f + elas_g) * fabsf(vn) / vtl);
        vo[0] = at * t0;
        vo[1] = at * t1;
        vo[2] = -elas_g * vnz + at * t2;
        toi = -(x[2] - a.ground) / v[2];
      }
      for (int k = 0; k < 3; ++k) {
        const float xn = x[k] + v[k] * toi + vo[k] * (dt - toi);
        smem[o_nxt + k * N + i] = xn;
        smem[o_nxt + 3 * N + k * N + i] = vo[k];
        if constexpr (R == 2) {
          peer[o_nxt + k * N + i] = xn;
          peer[o_nxt + 3 * N + k * N + i] = vo[k];
        }
      }
    }
    drift(a, rank, s, 3);
    env_barrier<R>();
  }

  // last-substep finger forces, summed over contact slots in slot order
  if (rank == 0) {
    for (int q = tid; q < a.F * 3; q += kThreads) {
      const int f = q / 3, k = q % 3;
      float acc = 0.0f;
      if (f < a.n_f) {
        for (int j = 0; j < PM; ++j)
          if (a.c_ok[(long long)b * PM + j] && sfi[j] == f)
            acc += sfc[k * PM + j];
      }
      a.ff_out[((long long)b * a.F + f) * 3 + k] = acc;
    }
  }
  const float* xf = smem + (a.S & 1) * 6 * N;
  for (int i = lo + tid; i < hi; i += kThreads) {
    for (int k = 0; k < 3; ++k) {
      a.x_out[((long long)b * N + i) * 3 + k] = xf[k * N + i];
      a.v_out[((long long)b * N + i) * 3 + k] = xf[3 * N + k * N + i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
spring_mass_step_kernel(const SpringStepArgs a) {
  step_body<1>(a);
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
spring_mass_step_cluster_kernel(const SpringStepArgs a) {
  step_body<2>(a);
}

}  // namespace

extern "C" cudaError_t spring_mass_step_launch(const SpringStepArgs* a,
                                               cudaStream_t stream) {
  if (a->C > kMaxColliders || (a->ranks != 1 && a->ranks != 2))
    return cudaErrorInvalidValue;
  if (a->B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (15 * (size_t)a->N + 3 * (size_t)a->M +
                                       3 * (size_t)a->PM) +
                      sizeof(int) * (size_t)a->PM;
  const auto kernel = a->ranks == 1 ? spring_mass_step_kernel
                                    : spring_mass_step_cluster_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<a->B * a->ranks, kThreads, smem, stream>>>(*a);
  return cudaGetLastError();
}
