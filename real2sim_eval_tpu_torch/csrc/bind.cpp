// Python binding of the port's CUDA kernels: the only source that includes
// PyTorch's headers. Callers (renderer/tile_kernel.py,
// renderer/fine_kernel.py, physics/fused_step.py, kinematics/ik.py)
// validate shapes and allocate outputs; this file checks device, dtype,
// contiguity and every shape the kernels index through once more, launches
// on the current stream and checks the launch.

#include <torch/extension.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <utility>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include "ik_solve.h"
#include "spring_mass_step.h"
#include "tile_composite.h"

namespace {

void check(const torch::Tensor& t, const char* name, at::ScalarType dtype) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, name, " has the wrong dtype");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void check_table(const torch::Tensor& t, const char* name) {
  check(t, name, at::kFloat);
  TORCH_CHECK(t.dim() == 2 && t.size(0) == 10, name, " must be (10, P)");
}

// rgb (I, 3, 8 * n_tiles_y, tile_w * n_tiles_x) and depth (I, Hp, Wp),
// f32; tile_w is 128 (wide tiles) or 16 (fine tiles)
void check_frames(const torch::Tensor& rgb, const torch::Tensor& depth,
                  int64_t n_inst, int64_t n_tiles_x, int64_t n_tiles_y,
                  int64_t tile_w = 128) {
  check(rgb, "rgb", at::kFloat);
  check(depth, "depth", at::kFloat);
  const int64_t h_pad = 8 * n_tiles_y, w_pad = tile_w * n_tiles_x;
  TORCH_CHECK(rgb.dim() == 4 && rgb.size(0) == n_inst && rgb.size(1) == 3 &&
                  rgb.size(2) == h_pad && rgb.size(3) == w_pad,
              "rgb must be (I, 3, 8 * n_tiles_y, tile_w * n_tiles_x)");
  TORCH_CHECK(depth.dim() == 3 && depth.size(0) == n_inst &&
                  depth.size(1) == h_pad && depth.size(2) == w_pad,
              "depth must be (I, 8 * n_tiles_y, tile_w * n_tiles_x)");
}

// the (n_dirty,) i32 tables of a dirty-tile list, all of one length
int64_t check_dirty_list(std::initializer_list<std::pair<const torch::Tensor*,
                                                         const char*>> ts) {
  const int64_t n = ts.begin()->first->numel();
  for (const auto& p : ts) {
    check(*p.first, p.second, at::kInt);
    TORCH_CHECK(p.first->dim() == 1 && p.first->size(0) == n, p.second,
                " must be (n_dirty,) like the other dirty-tile tables");
  }
  return n;
}

// the pair table and its (I, n_tiles) i32 tile ranges; returns I
int64_t check_ranges(const torch::Tensor& pairs, const torch::Tensor& starts,
                     const torch::Tensor& ends, int64_t n_tiles_x,
                     int64_t n_tiles_y) {
  check_table(pairs, "pairs");
  check(starts, "tile_starts", at::kInt);
  check(ends, "tile_ends", at::kInt);
  TORCH_CHECK(starts.dim() == 2 && starts.size(1) == n_tiles_x * n_tiles_y &&
                  ends.sizes() == starts.sizes(),
              "tile_starts and tile_ends must be (I, n_tiles_x * n_tiles_y)");
  return starts.size(0);
}

void tile_composite(torch::Tensor pairs, torch::Tensor starts,
                    torch::Tensor ends, int64_t n_tiles_x, int64_t n_tiles_y,
                    double bg0, double bg1, double bg2, torch::Tensor rgb,
                    torch::Tensor depth) {
  const int64_t n_inst =
      check_ranges(pairs, starts, ends, n_tiles_x, n_tiles_y);
  check_frames(rgb, depth, n_inst, n_tiles_x, n_tiles_y);
  const c10::cuda::CUDAGuard guard(pairs.device());
  C10_CUDA_CHECK(tile_composite_launch(
      pairs.data_ptr<float>(), pairs.size(1), starts.data_ptr<int>(),
      ends.data_ptr<int>(), (int)n_inst, (int)n_tiles_x, (int)n_tiles_y,
      (float)bg0, (float)bg1, (float)bg2, rgb.data_ptr<float>(),
      depth.data_ptr<float>(), c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void tile_composite_t(torch::Tensor pairs, torch::Tensor starts,
                      torch::Tensor ends, int64_t n_tiles_x,
                      int64_t n_tiles_y, double bg0, double bg1, double bg2,
                      torch::Tensor rgb, torch::Tensor depth,
                      torch::Tensor t_fin) {
  const int64_t n_inst =
      check_ranges(pairs, starts, ends, n_tiles_x, n_tiles_y);
  check_frames(rgb, depth, n_inst, n_tiles_x, n_tiles_y);
  check(t_fin, "t_fin", at::kFloat);
  TORCH_CHECK(t_fin.sizes() == depth.sizes(), "t_fin must be shaped as depth");
  const c10::cuda::CUDAGuard guard(pairs.device());
  C10_CUDA_CHECK(tile_composite_t_launch(
      pairs.data_ptr<float>(), pairs.size(1), starts.data_ptr<int>(),
      ends.data_ptr<int>(), (int)n_inst, (int)n_tiles_x, (int)n_tiles_y,
      (float)bg0, (float)bg1, (float)bg2, rgb.data_ptr<float>(),
      depth.data_ptr<float>(), t_fin.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void tile_backward(torch::Tensor pairs, torch::Tensor starts,
                   torch::Tensor ends, torch::Tensor order,
                   int64_t n_tiles_x, int64_t n_tiles_y,
                   torch::Tensor dl_rgb, torch::Tensor dl_depth,
                   torch::Tensor c_fin, torch::Tensor t_fin, double bg0,
                   double bg1, double bg2, torch::Tensor grads) {
  const int64_t n_inst =
      check_ranges(pairs, starts, ends, n_tiles_x, n_tiles_y);
  check(order, "order", at::kInt);
  TORCH_CHECK(order.numel() == starts.numel(),
              "order must list every (instance, tile)");
  check_table(grads, "grads");
  TORCH_CHECK(grads.size(1) == pairs.size(1), "grads must be shaped as pairs");
  check_frames(dl_rgb, dl_depth, n_inst, n_tiles_x, n_tiles_y);
  check_frames(c_fin, t_fin, n_inst, n_tiles_x, n_tiles_y);
  const c10::cuda::CUDAGuard guard(pairs.device());
  C10_CUDA_CHECK(tile_backward_launch(
      pairs.data_ptr<float>(), pairs.size(1), starts.data_ptr<int>(),
      ends.data_ptr<int>(), order.data_ptr<int>(), (int)n_inst,
      (int)n_tiles_x, (int)n_tiles_y, dl_rgb.data_ptr<float>(),
      dl_depth.data_ptr<float>(), c_fin.data_ptr<float>(),
      t_fin.data_ptr<float>(), (float)bg0, (float)bg1, (float)bg2,
      grads.data_ptr<float>(), c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void tile_sparse(torch::Tensor pairs, torch::Tensor inst_ids,
                 torch::Tensor tile_ids, torch::Tensor starts,
                 torch::Tensor ends, int64_t n_tiles_x, int64_t n_tiles_y,
                 double bg0, double bg1, double bg2, torch::Tensor rgb,
                 torch::Tensor depth) {
  check_table(pairs, "pairs");
  const int64_t n_dirty = check_dirty_list(
      {{&inst_ids, "inst_ids"}, {&tile_ids, "tile_ids"},
       {&starts, "starts"}, {&ends, "ends"}});
  check_frames(rgb, depth, rgb.size(0), n_tiles_x, n_tiles_y);
  const c10::cuda::CUDAGuard guard(pairs.device());
  C10_CUDA_CHECK(tile_sparse_launch(
      pairs.data_ptr<float>(), pairs.size(1), inst_ids.data_ptr<int>(),
      tile_ids.data_ptr<int>(), starts.data_ptr<int>(), ends.data_ptr<int>(),
      (int)n_dirty, (int)rgb.size(0), (int)n_tiles_x, (int)n_tiles_y,
      (float)bg0, (float)bg1, (float)bg2, rgb.data_ptr<float>(),
      depth.data_ptr<float>(), c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void tile_sparse_merge(torch::Tensor data_s, torch::Tensor data_d,
                       torch::Tensor inst_ids, torch::Tensor tile_ids,
                       torch::Tensor s_starts, torch::Tensor s_ends,
                       torch::Tensor d_starts, torch::Tensor d_ends,
                       int64_t n_tiles_x, int64_t n_tiles_y, double bg0,
                       double bg1, double bg2, torch::Tensor rgb,
                       torch::Tensor depth) {
  check_table(data_s, "static pairs");
  check_table(data_d, "dynamic pairs");
  const int64_t n_dirty = check_dirty_list(
      {{&inst_ids, "inst_ids"}, {&tile_ids, "tile_ids"},
       {&s_starts, "s_starts"}, {&s_ends, "s_ends"},
       {&d_starts, "d_starts"}, {&d_ends, "d_ends"}});
  check_frames(rgb, depth, rgb.size(0), n_tiles_x, n_tiles_y);
  const c10::cuda::CUDAGuard guard(data_s.device());
  C10_CUDA_CHECK(tile_sparse_merge_launch(
      data_s.data_ptr<float>(), data_s.size(1), data_d.data_ptr<float>(),
      data_d.size(1), inst_ids.data_ptr<int>(), tile_ids.data_ptr<int>(),
      s_starts.data_ptr<int>(), s_ends.data_ptr<int>(),
      d_starts.data_ptr<int>(), d_ends.data_ptr<int>(), (int)n_dirty,
      (int)rgb.size(0), (int)n_tiles_x, (int)n_tiles_y, (float)bg0,
      (float)bg1, (float)bg2, rgb.data_ptr<float>(), depth.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fine_composite(torch::Tensor pairs, torch::Tensor starts,
                    torch::Tensor ends, torch::Tensor order, int64_t n_fine_x,
                    int64_t n_tiles_y, double bg0, double bg1, double bg2,
                    torch::Tensor rgb, torch::Tensor depth) {
  const int64_t n_inst =
      check_ranges(pairs, starts, ends, n_fine_x, n_tiles_y);
  check(order, "order", at::kInt);
  TORCH_CHECK(order.numel() == starts.numel(),
              "order must list every (instance, fine tile)");
  check_frames(rgb, depth, n_inst, n_fine_x, n_tiles_y, 16);
  const c10::cuda::CUDAGuard guard(pairs.device());
  C10_CUDA_CHECK(fine_composite_launch(
      pairs.data_ptr<float>(), pairs.size(1), starts.data_ptr<int>(),
      ends.data_ptr<int>(), order.data_ptr<int>(), (int)n_inst,
      (int)n_fine_x, (int)n_tiles_y, (float)bg0, (float)bg1, (float)bg2,
      rgb.data_ptr<float>(), depth.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fine_sparse(torch::Tensor pairs, torch::Tensor inst_ids,
                 torch::Tensor tile_ids, torch::Tensor starts,
                 torch::Tensor ends, torch::Tensor order, int64_t n_fine_x,
                 int64_t n_tiles_y, double bg0, double bg1, double bg2,
                 torch::Tensor rgb, torch::Tensor depth) {
  check_table(pairs, "pairs");
  const int64_t n_dirty = check_dirty_list(
      {{&inst_ids, "inst_ids"}, {&tile_ids, "tile_ids"},
       {&starts, "starts"}, {&ends, "ends"}, {&order, "order"}});
  check_frames(rgb, depth, rgb.size(0), n_fine_x, n_tiles_y, 16);
  const c10::cuda::CUDAGuard guard(pairs.device());
  C10_CUDA_CHECK(fine_sparse_launch(
      pairs.data_ptr<float>(), pairs.size(1), inst_ids.data_ptr<int>(),
      tile_ids.data_ptr<int>(), starts.data_ptr<int>(), ends.data_ptr<int>(),
      order.data_ptr<int>(), (int)n_dirty, (int)rgb.size(0), (int)n_fine_x,
      (int)n_tiles_y, (float)bg0, (float)bg1, (float)bg2,
      rgb.data_ptr<float>(), depth.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void spring_mass_step(
    torch::Tensor x, torch::Tensor v, torch::Tensor masses,
    torch::Tensor row_ptr, torch::Tensor records, torch::Tensor scal,
    torch::Tensor sc_sel,
    torch::Tensor sc_idx, torch::Tensor sc_ok, torch::Tensor sc_invm,
    torch::Tensor sc_msel, torch::Tensor c_inv, torch::Tensor c_ok,
    torch::Tensor pose, torch::Tensor dyn_lin, torch::Tensor dyn_omega,
    torch::Tensor corners, torch::Tensor g_origin, torch::Tensor g_isp,
    torch::Tensor g_dims, torch::Tensor g_off, int64_t n_f, int64_t S,
    double dt, double gz, double rev, double ground, double cdist,
    bool use_pusher, int64_t ranks, int64_t drift_ns, torch::Tensor x_out,
    torch::Tensor v_out, torch::Tensor ff_out) {
  for (const auto& p : {std::make_pair(&x, "x"), std::make_pair(&v, "v"),
                  std::make_pair(&masses, "masses"),
                  std::make_pair(&records, "records"),
                  std::make_pair(&scal, "scal"),
                  std::make_pair(&sc_invm, "sc_invm"),
                  std::make_pair(&sc_msel, "sc_msel"),
                  std::make_pair(&pose, "pose"),
                  std::make_pair(&dyn_lin, "dyn_lin"),
                  std::make_pair(&dyn_omega, "dyn_omega"),
                  std::make_pair(&corners, "corners"),
                  std::make_pair(&g_origin, "g_origin"),
                  std::make_pair(&g_isp, "g_isp"),
                  std::make_pair(&x_out, "x_out"),
                  std::make_pair(&v_out, "v_out"),
                  std::make_pair(&ff_out, "ff_out")})
    check(*p.first, p.second, at::kFloat);
  for (const auto& p : {std::make_pair(&row_ptr, "row_ptr"),
                  std::make_pair(&sc_sel, "sc_sel"),
                  std::make_pair(&sc_idx, "sc_idx"),
                  std::make_pair(&sc_ok, "sc_ok"),
                  std::make_pair(&c_inv, "c_inv"),
                  std::make_pair(&c_ok, "c_ok"),
                  std::make_pair(&g_dims, "g_dims")})
    check(*p.first, p.second, at::kInt);
  check(g_off, "g_off", at::kLong);

  // every shape the kernel indexes through (it reads them unchecked)
  TORCH_CHECK(x.dim() == 3 && x.size(2) == 3, "x must be (B, N, 3)");
  const int64_t B = x.size(0), N = x.size(1);
  for (const auto* t : {&v, &x_out, &v_out})
    TORCH_CHECK(t->sizes() == x.sizes(), "v, x_out and v_out must match x");
  TORCH_CHECK(masses.dim() == 1 && masses.size(0) == N, "masses must be (N)");
  TORCH_CHECK(row_ptr.dim() == 1 && row_ptr.size(0) == N + 1,
              "row_ptr must be (N + 1)");
  TORCH_CHECK(records.dim() == 2 && records.size(1) == 4,
              "records must be (R, 4)");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(records.data_ptr<float>()) % 16 ==
                  0,
              "records must be 16-byte aligned");
  TORCH_CHECK(ranks == 1 || ranks == 2, "ranks must be 1 or 2");
  TORCH_CHECK(drift_ns >= 0 && drift_ns <= 100000,
              "drift_ns must lie in [0, 100000]");
  TORCH_CHECK(scal.dim() == 1 && scal.size(0) == 8, "scal must be (8)");
  TORCH_CHECK(sc_sel.dim() == 2 && sc_sel.size(0) == B &&
                  sc_sel.size(1) <= N,
              "sc_sel must be (B, M) with M <= N");
  const int64_t M = sc_sel.size(1);
  TORCH_CHECK(sc_idx.dim() == 3 && sc_idx.size(0) == B && sc_idx.size(1) == M,
              "sc_idx must be (B, M, Ks)");
  for (const auto* t : {&sc_ok, &sc_invm})
    TORCH_CHECK(t->sizes() == sc_idx.sizes(),
                "sc_ok and sc_invm must match sc_idx (B, M, Ks)");
  TORCH_CHECK(sc_msel.sizes() == sc_sel.sizes(), "sc_msel must be (B, M)");
  TORCH_CHECK(c_inv.dim() == 2 && c_inv.size(0) == B && c_inv.size(1) == N,
              "c_inv must be (B, N)");
  TORCH_CHECK(c_ok.dim() == 2 && c_ok.size(0) == B, "c_ok must be (B, PM)");
  const int64_t C = g_isp.numel();
  TORCH_CHECK(g_isp.dim() == 1 && C <= 8, "g_isp must be (C) with C <= 8");
  TORCH_CHECK(g_origin.numel() == 3 * C && g_dims.numel() == 3 * C &&
                  g_off.numel() == C,
              "g_origin and g_dims must be (C, 3), g_off (C)");
  TORCH_CHECK(n_f >= 0 && n_f <= C, "n_f must lie in [0, C]");
  TORCH_CHECK(dyn_lin.dim() == 3 && dyn_lin.size(0) == B &&
                  dyn_lin.size(1) == std::max<int64_t>(n_f, 1) &&
                  dyn_lin.size(2) == 3,
              "dyn_lin must be (B, max(n_f, 1), 3)");
  TORCH_CHECK(dyn_omega.dim() == 2 && dyn_omega.size(0) == B &&
                  dyn_omega.size(1) == 3,
              "dyn_omega must be (B, 3)");
  TORCH_CHECK(ff_out.dim() == 3 && ff_out.size(0) == B &&
                  ff_out.size(1) >= n_f && ff_out.size(2) == 3,
              "ff_out must be (B, F, 3) with F >= n_f");
  if (C > 0) {
    TORCH_CHECK(pose.dim() == 4 && pose.size(0) == B && pose.size(1) == S &&
                    pose.size(2) == C && pose.size(3) == 24,
                "pose must be (B, S, C, 24)");
    TORCH_CHECK(corners.dim() == 2 && corners.size(1) == 8,
                "corners must be (cells, 8)");
  }

  SpringStepArgs a;
  a.B = (int)B;
  a.N = (int)N;
  a.R = (int)records.size(0);
  a.M = (int)M;
  a.Ks = (int)sc_idx.size(2);
  a.PM = (int)c_ok.size(1);
  a.C = (int)C;
  a.n_f = (int)n_f;
  a.F = (int)ff_out.size(1);
  a.S = (int)S;
  a.dt = (float)dt;
  a.gz = (float)gz;
  a.rev = (float)rev;
  a.ground = (float)ground;
  a.cdist = (float)cdist;
  a.use_pusher = use_pusher ? 1 : 0;
  a.ranks = (int)ranks;
  a.drift_ns = (int)drift_ns;
  a.x = x.data_ptr<float>();
  a.v = v.data_ptr<float>();
  a.masses = masses.data_ptr<float>();
  a.row_ptr = row_ptr.data_ptr<int>();
  a.records = reinterpret_cast<const float4*>(records.data_ptr<float>());
  a.scal = scal.data_ptr<float>();
  a.sc_sel = sc_sel.data_ptr<int>();
  a.sc_idx = sc_idx.data_ptr<int>();
  a.sc_ok = sc_ok.data_ptr<int>();
  a.sc_invm = sc_invm.data_ptr<float>();
  a.sc_msel = sc_msel.data_ptr<float>();
  a.c_inv = c_inv.data_ptr<int>();
  a.c_ok = c_ok.data_ptr<int>();
  a.pose = pose.data_ptr<float>();
  a.dyn_lin = dyn_lin.data_ptr<float>();
  a.dyn_omega = dyn_omega.data_ptr<float>();
  a.corners = corners.data_ptr<float>();
  a.g_origin = g_origin.data_ptr<float>();
  a.g_isp = g_isp.data_ptr<float>();
  a.g_dims = g_dims.data_ptr<int>();
  a.g_off = reinterpret_cast<const long long*>(g_off.data_ptr<int64_t>());
  a.x_out = x_out.data_ptr<float>();
  a.v_out = v_out.data_ptr<float>();
  a.ff_out = ff_out.data_ptr<float>();
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(
      spring_mass_step_launch(&a, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void ik_solve(torch::Tensor table, torch::Tensor q_init, torch::Tensor target,
              int64_t n_active, int64_t iters, double damping,
              double step_scale, double pos_tol, double rot_tol,
              torch::Tensor q_out) {
  for (const auto& p : {std::make_pair(&table, "table"),
                        std::make_pair(&q_init, "q_init"),
                        std::make_pair(&target, "target"),
                        std::make_pair(&q_out, "q_out")})
    check(*p.first, p.second, at::kFloat);
  TORCH_CHECK(table.dim() == 2 && table.size(1) == IK_TABLE_WIDTH &&
                  table.size(0) >= 1 && table.size(0) <= IK_MAX_PATH,
              "table must be (n_path, 24) with 1 <= n_path <= 32");
  TORCH_CHECK(q_init.dim() == 2 && q_init.size(1) <= IK_MAX_DOF,
              "q_init must be (E, n) with n <= 64");
  const int64_t E = q_init.size(0), n = q_init.size(1);
  TORCH_CHECK(target.dim() == 3 && target.size(0) == E &&
                  target.size(1) == 4 && target.size(2) == 4,
              "target must be (E, 4, 4)");
  TORCH_CHECK(q_out.sizes() == q_init.sizes(), "q_out must match q_init");
  TORCH_CHECK(n_active >= 0 && n_active <= IK_MAX_ACTIVE && n_active <= n,
              "n_active must lie in [0, min(31, n)]");
  TORCH_CHECK(iters >= 0, "iters must be >= 0");
  for (const auto* t : {&table, &target, &q_out})
    TORCH_CHECK(t->device() == q_init.device(),
                "table, q_init, target and q_out must be on one device");
  IkSolveArgs a{};
  a.E = static_cast<int>(E);
  a.n = static_cast<int>(n);
  a.n_active = static_cast<int>(n_active);
  a.n_path = static_cast<int>(table.size(0));
  a.iters = static_cast<int>(iters);
  a.damping = static_cast<float>(damping);
  a.step_scale = static_cast<float>(step_scale);
  a.pos_tol = static_cast<float>(pos_tol);
  a.rot_tol = static_cast<float>(rot_tol);
  a.table = table.data_ptr<float>();
  a.q_init = q_init.data_ptr<float>();
  a.target = target.data_ptr<float>();
  a.q_out = q_out.data_ptr<float>();
  const c10::cuda::CUDAGuard guard(q_init.device());
  C10_CUDA_CHECK(ik_solve_launch(&a, c10::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("tile_composite", &tile_composite,
        "Tile compositor over (instance, 8x128 tile) (CUDA)");
  m.def("tile_composite_t", &tile_composite_t,
        "Tile compositor writing the final transmittance too (CUDA)");
  m.def("tile_backward", &tile_backward,
        "Per-pair gradients of the tile compositor by a front-to-back "
        "re-walk (CUDA)");
  m.def("tile_sparse", &tile_sparse,
        "Dirty-tile compositor over a merged pair table, in place (CUDA)");
  m.def("tile_sparse_merge", &tile_sparse_merge,
        "Dirty-tile compositor merging static and dynamic segments, in "
        "place (CUDA)");
  m.def("fine_composite", &fine_composite,
        "Fine-tile compositor over (instance, 8x16 fine tile) (CUDA)");
  m.def("fine_sparse", &fine_sparse,
        "Dirty fine-tile compositor over a merged pair table, in place "
        "(CUDA)");
  m.def("spring_mass_step", &spring_mass_step,
        "All substeps of one spring-mass control step, one CTA per env or "
        "a cluster of two (CUDA)");
  m.def("ik_solve", &ik_solve,
        "The damped-least-squares IK solve, one warp per lane (CUDA)");
}
