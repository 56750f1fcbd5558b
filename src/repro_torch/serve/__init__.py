"""Serving: the paged KV cache (``paging``).

The paging subset of the reference's ``serve`` exports. The engine, its
steps, sampling, stats and faults wait for a later slice (ROADMAP Queue 1
item 7); until then ``serve.decode`` (not exported) prefills requests
alone and decodes them together through a contiguous or a paged cache.
"""

from repro_torch.serve.paging import (PageAllocator, PageTable,
                                      PrefixRegistry, gather_pages,
                                      gather_prefix, paged_layer_names,
                                      pages_for, scatter_prefix,
                                      scatter_token, validate_paged_support)

__all__ = [
    "PageAllocator", "PageTable", "PrefixRegistry", "gather_pages",
    "gather_prefix", "paged_layer_names", "pages_for", "scatter_prefix",
    "scatter_token", "validate_paged_support",
]
