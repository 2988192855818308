"""Synthetic, (seed, step)-pure data pipelines."""
from .synthetic import (DataSpec, jet_batch, make_pipeline, muon_batch,
                        svhn_batch)

__all__ = ["DataSpec", "jet_batch", "make_pipeline", "muon_batch",
           "svhn_batch"]
