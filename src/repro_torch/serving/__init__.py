"""Serving: the page pools, of KV pages or of recurrent state
(``serving.cache``), and the continuous-batching engine
(``serving.engine``)."""
from repro_torch.serving.cache import (NULL_PAGE, DenseKVCache, OutOfPages,
                                       PagedKVCache, PagePool)
from repro_torch.serving.engine import (GenerationRequest, GenerationResult,
                                        ServingEngine, pow2_buckets)

__all__ = [
    "DenseKVCache", "PagedKVCache", "PagePool", "OutOfPages", "NULL_PAGE", "ServingEngine",
    "GenerationRequest", "GenerationResult", "pow2_buckets",
]
