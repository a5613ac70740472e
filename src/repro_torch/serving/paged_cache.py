"""Paged KV-cache primitives: fixed-size pages in a shared pool, addressed
through per-request block tables (counterpart of
``repro.serving.paged_cache``, non-quantized pools).

A pool is ``(num_pages, page_size, *tail)`` — with a leading layer axis,
``(layers, num_pages, page_size, *tail)``, for the model's caches; logical
position ``t`` of request ``i`` lives at
``pool[block_table[i, t // page_size], t % page_size]``.  Physical page
``NULL_PAGE`` (= 0) is the reserved scratch page: inactive block-table
entries point at it, so writes from idle decode lanes land somewhere
harmless.

Unlike the reference's pure functions, the writers here update the pool in
place (and return it): a serving step then never copies a pool.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: Reserved scratch page.  The allocator never hands it out; block-table
#: entries of unallocated/finished slots point here.
NULL_PAGE = 0

#: Prefill cache leaf -> paged pool leaf.
PAGED_KEYS = {"k": "k_pages", "v": "v_pages"}


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` positions."""
    return -(-n_tokens // page_size)


def init_pool(num_pages: int, page_size: int, tail: Tuple[int, ...],
              dtype: torch.dtype, device, layers: int = 0) -> torch.Tensor:
    """Zero page pool ``([layers,] num_pages, page_size, *tail)``."""
    if num_pages < 2:
        raise ValueError(
            f"num_pages must be >= 2 (page {NULL_PAGE} is the reserved "
            f"scratch page), got {num_pages}")
    lead = (layers,) if layers else ()
    return torch.zeros(lead + (num_pages, page_size) + tuple(tail),
                       dtype=dtype, device=device)


def _phys(block_row: torch.Tensor, logical: torch.Tensor) -> torch.Tensor:
    """Physical page of each logical page; positions past the row go to the
    scratch page (never clamped onto the row's last page)."""
    npages = block_row.shape[-1]
    phys = torch.gather(block_row, -1,
                        torch.clamp(logical, 0, npages - 1).long())
    return torch.where(logical < npages, phys, torch.zeros_like(phys))


def append_pages(pool: torch.Tensor, new: torch.Tensor,
                 block_table: torch.Tensor,
                 seq_lens: torch.Tensor) -> torch.Tensor:
    """Write ``new (b, s, *tail)`` at logical positions ``seq_lens[i] ..
    seq_lens[i] + s`` of each request into ``pool (P, page, *tail)``, in
    place; returns the pool.  A position past the block-table row is
    redirected to the scratch page, not clamped."""
    b, s = new.shape[0], new.shape[1]
    page_size = pool.shape[1]
    pos = seq_lens[:, None].to(torch.int32) \
        + torch.arange(s, dtype=torch.int32, device=new.device)[None]
    logical = pos // page_size
    phys = _phys(block_table.to(torch.int64), logical)
    off = (pos % page_size).long()
    pool[phys, off] = new.to(pool.dtype)
    return pool


def append_prefix_pages(pool: torch.Tensor, prefix: torch.Tensor,
                        block_row: torch.Tensor) -> torch.Tensor:
    """Scatter one request's whole prefix into the layer-stacked pool
    ``(L, P, page, *tail)`` from logical position 0 (``prefix (L, s,
    *tail)``), in place.  Positions past the row go to the scratch page."""
    s = prefix.shape[1]
    page_size = pool.shape[2]
    pos = torch.arange(s, dtype=torch.int32, device=prefix.device)
    phys = _phys(block_row.to(torch.int64), pos // page_size)
    off = (pos % page_size).long()
    pool[:, phys, off] = prefix.to(pool.dtype)
    return pool


def write_prefill_prefix(paged_caches, prefill_caches, block_row, slot):
    """Scatter one request's batch-1 ``prefill`` caches (``{"k", "v"}``,
    each (L, 1, s, kvh, hd)) into its pages of the paged caches (in
    place); returns the paged caches.  ``slot`` is unused: attention-only
    models keep no per-slot state."""
    del slot
    for key, val in prefill_caches.items():
        append_prefix_pages(paged_caches[PAGED_KEYS[key]], val[:, 0],
                            block_row)
    return paged_caches


def copy_page(paged_caches, src: int, dst: int):
    """Clone physical page ``src`` into ``dst`` in every pool (in place) —
    the copy-on-write boundary-page copy."""
    for val in paged_caches.values():
        val[:, dst] = val[:, src]
    return paged_caches


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """Materialize the virtual contiguous cache ``(b, npages * page_size,
    *tail)`` a block table describes (the twin path; the kernel resolves
    the same pages without materializing them)."""
    b, npages = block_table.shape
    out = pool[block_table.long()]               # (b, npages, page, *tail)
    return out.reshape((b, npages * pool.shape[1]) + tuple(pool.shape[2:]))
