"""Synthetic training data of the port's LLM substrate, mirroring the
reference package's ``data``."""
from .pipeline import (LMBatchIterator, make_lm_batches, make_modality_batch,
                       synthetic_corpus)

__all__ = ["LMBatchIterator", "make_lm_batches", "make_modality_batch",
           "synthetic_corpus"]
