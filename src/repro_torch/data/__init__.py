"""Synthetic, (seed, step)-pure data pipelines."""
from .synthetic import (DataSpec, asr_batch, jet_batch, lm_batch,
                        make_pipeline, muon_batch, svhn_batch)

__all__ = ["DataSpec", "asr_batch", "jet_batch", "lm_batch",
           "make_pipeline", "muon_batch", "svhn_batch"]
