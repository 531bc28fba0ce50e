"""Command-line tools of the port (the JAX package's experiments/)."""
