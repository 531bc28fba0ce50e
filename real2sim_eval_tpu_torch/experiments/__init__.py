"""Command-line tools of the port (the JAX package's experiments/): the
batched and single-env policy evaluation, replay, keyboard teleoperation,
the episode writer and, under utils/, the success calculators and the
scene refinement."""
