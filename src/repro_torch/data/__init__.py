"""Data pipeline: deterministic synthetic LM token streams (a copy of the
reference's ``data/pipeline.py``, numpy only)."""
from repro_torch.data.pipeline import TokenStream, make_batch_iterator

__all__ = ["TokenStream", "make_batch_iterator"]
