"""Utility tools: run directories, videos, the success calculators and
scene refinement (refine_gs)."""
