"""Synthetic, (seed, step)-pure data pipelines."""
from .synthetic import DataSpec, jet_batch, make_pipeline

__all__ = ["DataSpec", "jet_batch", "make_pipeline"]
