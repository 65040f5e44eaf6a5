"""Data pipeline of the port (``repro.data``): the synthetic tokenized stream
with WFE-reclaimed prefetch."""

from .pipeline import SyntheticLMData, PrefetchingLoader

__all__ = ["SyntheticLMData", "PrefetchingLoader"]
