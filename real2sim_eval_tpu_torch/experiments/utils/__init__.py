"""Utility tools: scene refinement (refine_gs)."""
