"""real2sim_eval_tpu_torch: the PyTorch + CUDA port of the JAX package.

The JAX package beside this one is the reference this port is held
against; this package imports neither it nor JAX. Layout and names mirror
the JAX package module for module (``utils/``, ``renderer/``, ``physics/``,
``kinematics/``, ``parallel/``), so each counterpart is easy to find.

Two hand-written CUDA kernels (``csrc/``, built at first use for
``sm_90a``) replace the two TPU Pallas kernels on the batched evaluation
path: the spring-mass control step (``physics/fused_step.py``) and the tile
compositor (``renderer/tile_kernel.py``). Each has a plain PyTorch version
beside it, which runs only for tensors on the CPU.

Entry points default to ``device="cuda"`` and raise when no card is
present, unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
