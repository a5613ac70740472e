"""Continuous-batching serving over paged KV caches (counterpart of
``repro.serving``): page pools and block tables (``paged_cache``), paged
decode attention with the K4 kernel and its gather twin
(``paged_attention``), the pure-Python scheduler and prefix index (copied
from the reference) and the ``PagedServingEngine`` executor."""
from .paged_cache import (NULL_PAGE, append_pages, copy_page, gather_pages,
                          init_pool, pages_needed, write_prefill_prefix)
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_kernel,
                              paged_decode_attention_plain,
                              paged_decode_attention_xla)
from .prefix_index import NO_MATCH, PrefixIndex, PrefixMatch
from .scheduler import (PageAllocator, PrefillChunk, Request, Scheduler,
                        StepPlan)
from .engine import PagedServingEngine

__all__ = [
    "NULL_PAGE", "append_pages", "copy_page", "gather_pages", "init_pool",
    "pages_needed", "write_prefill_prefix",
    "paged_decode_attention", "paged_decode_attention_kernel",
    "paged_decode_attention_plain", "paged_decode_attention_xla",
    "NO_MATCH", "PrefixIndex", "PrefixMatch",
    "PageAllocator", "PrefillChunk", "Request", "Scheduler", "StepPlan",
    "PagedServingEngine",
]
