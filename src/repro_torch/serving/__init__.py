"""Serving: the paged KV pool (``serving.cache``) and the
continuous-batching engine (``serving.engine``)."""
from repro_torch.serving.cache import (NULL_PAGE, OutOfPages, PagedKVCache,
                                       PagePool)
from repro_torch.serving.engine import (GenerationRequest, GenerationResult,
                                        ServingEngine, pow2_buckets)

__all__ = [
    "PagedKVCache", "PagePool", "OutOfPages", "NULL_PAGE", "ServingEngine",
    "GenerationRequest", "GenerationResult", "pow2_buckets",
]
