"""A frozen copy of the plain PyTorch and NumPy code of
``real2sim_eval_tpu_torch`` (config, envs, kinematics, parallel, physics,
renderer, utils, the rigid-object writer), taken when the benchmark was
written. It is the benchmark's reference and the source of its scene
writers, so later changes to the program cannot move either.

Edits against the program's files: every kernel call takes its plain
PyTorch version on every device (``tile_kernel``, ``fine_kernel``,
``fused_step``: ``if True``; ``ext`` is a stub that raises), the IK solve
runs eagerly (no CUDA graph), the PLY reader is the numpy one, and the
viewers, the differentiable render, the profiler helpers, ICP and the
multi-card mesh are left out.
"""
