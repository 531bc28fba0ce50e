"""real2sim_eval_tpu_torch: the PyTorch + CUDA port of the JAX package.

The JAX package beside this one is the reference this port is held
against; this package imports neither it nor JAX. Layout and names mirror
the JAX package module for module (``utils/``, ``renderer/``, ``physics/``,
``kinematics/``, ``parallel/``), so each counterpart is easy to find.

Hand-written CUDA kernels (``csrc/``, built at first use for ``sm_90a``)
replace the TPU Pallas kernels of the ported paths: the spring-mass
control step (``physics/fused_step.py``), the tile compositors of the
batched and incremental render on 8x128 tiles (``renderer/tile_kernel.py``)
and on 8x16 fine tiles (``renderer/fine_kernel.py``), and the
differentiable render's forward and backward (``renderer/tile_kernel.py``,
``renderer/diff.py``). Each
has a plain PyTorch version beside it, which runs only for tensors on the
CPU.

Entry points default to ``device="cuda"`` and raise when no card is
present, unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
