"""Prefix cache index — page-granularity token-prefix sharing.

A copy of ``repro.serving.prefix_index`` (pure Python).  The port's engine
does not use it yet (``prefix_cache=True`` raises); the scheduler imports it.

The paper's footprint discipline taken one level further up the serving
stack: decode is memory-bound, so the cheapest KV bytes are the ones never
recomputed *or* re-staged at all.  Production streams are dominated by
shared prefixes (system prompts, few-shot templates, multi-turn history);
their K/V depends only on the token prefix, so a page whose token span
matches can be installed into a new request's block table by reference.

The index is a radix tree over *page-sized token spans*: a node at depth
``i`` is keyed by the exact tokens of logical page ``i`` (a chain of full
pages identifies a prefix bitwise — no hash collisions to reason about) and
records the physical page holding that span's K/V.  Two node flavors:

  * **full nodes** — a completely-filled page.  Matching requests install
    the physical page *by reference* (refcount bumped, read-only): sharing
    changes which physical page a read resolves to, never arithmetic.
  * **partial nodes** — the trailing, partially-filled page of a
    registered prompt.  A matching request cannot share it by reference
    (it will *write* its own divergent tokens into that page), so the
    engine clones the page into a private one — the copy-on-write
    boundary page — and prefill skips the matched span prefix.

Registration happens when a request's prefill *completes* (its page
contents are final); matching happens at admission.  The index holds one
allocator reference per registered page (``PageAllocator.retain``), so
cached pages outlive their original owner; when admission runs out of free
pages, ``reclaim`` evicts least-recently-used *leaf* nodes whose page no
live request references (leaf-first keeps every remaining chain reachable).

Everything here is pure Python and deterministic — stamps are a logical
clock, tie-breaks are insertion-ordered — so the scheduler's property
tests drive it without a model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixIndex", "PrefixMatch", "NO_MATCH"]


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Admission-time match result.

    ``shared_pages`` are installed by reference into the head of the block
    table (read-only, refcounted).  ``boundary_src`` is the physical page
    to clone into the request's first private page (the COW boundary), or
    ``None``.  ``cached_upto`` counts prompt positions whose K/V is reused
    — prefill starts there.  Always ``cached_upto < len(prompt)``: at
    least the final prompt token is recomputed so the completing prefill
    chunk can emit the first generated token's logits.
    """
    shared_pages: Tuple[int, ...]
    boundary_src: Optional[int]
    cached_upto: int


NO_MATCH = PrefixMatch((), None, 0)


class _Node:
    __slots__ = ("span", "page", "partial", "parent", "children", "partials",
                 "stamp")

    def __init__(self, span, page, partial, parent, stamp):
        self.span = span            # token tuple this node's page holds
        self.page = page            # physical page id
        self.partial = partial      # True -> trailing partially-filled page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}   # full-page spans
        self.partials: Dict[Tuple[int, ...], _Node] = {}   # partial spans
        self.stamp = stamp

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixIndex:
    """Radix index over page-granularity token prefixes."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._root = _Node(span=None, page=None, partial=False, parent=None,
                           stamp=0)
        self._clock = 0
        self.n_nodes = 0

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    # -- matching (admission) ------------------------------------------------

    def match(self, prompt: Sequence[int]) -> PrefixMatch:
        """Longest cached span of ``prompt``, capped at ``len(prompt) - 1``.

        Pure query apart from LRU stamps: refcounts are the scheduler's job
        (it must ``share`` every returned page — including ``boundary_src``
        — before allocating, so a same-tick reclaim cannot evict them).
        """
        ps = self.page_size
        n = len(prompt)
        node = self._root
        shared: List[int] = []
        full = n // ps
        i = 0
        while i < full:
            child = node.children.get(tuple(prompt[i * ps:(i + 1) * ps]))
            if child is None:
                break
            shared.append(child.page)
            self._touch(child)
            node = child
            i += 1
        cached = i * ps
        rem = tuple(prompt[cached:])
        if not rem:
            if not shared:
                return NO_MATCH
            # The whole prompt is covered by full cached pages, but the
            # completing prefill chunk must still run >= 1 token for its
            # logits (and its K/V append is a write): demote the last
            # shared page to a COW boundary copy and recompute only the
            # final token — a value-idempotent overwrite of the clone.
            return PrefixMatch(tuple(shared[:-1]), shared[-1], n - 1)
        best, best_m = None, 0
        for span, pnode in node.partials.items():
            m = min(_common_prefix(span, rem), len(rem) - 1)
            if m > best_m:
                best, best_m = pnode, m
        if best is not None:
            self._touch(best)
            return PrefixMatch(tuple(shared), best.page, cached + best_m)
        if not shared:
            return NO_MATCH
        return PrefixMatch(tuple(shared), None, cached)

    # -- registration (prefill completion) ----------------------------------

    def register(self, prompt: Sequence[int], block_row: Sequence[int],
                 allocator) -> int:
        """Index ``prompt``'s pages (full spans + the trailing partial
        span, if any) with a ``retain`` reference each.  Spans already
        indexed are only LRU-touched — the owning request's duplicate
        private pages stay unregistered and die with it.  Returns the
        number of newly registered pages."""
        ps = self.page_size
        node = self._root
        new = 0
        full = len(prompt) // ps
        for i in range(full):
            span = tuple(prompt[i * ps:(i + 1) * ps])
            child = node.children.get(span)
            if child is None:
                child = _Node(span=span, page=block_row[i], partial=False,
                              parent=node, stamp=0)
                allocator.retain(child.page)
                node.children[span] = child
                self.n_nodes += 1
                new += 1
            self._touch(child)
            node = child
        rem = tuple(prompt[full * ps:])
        if rem:
            pnode = node.partials.get(rem)
            if pnode is None:
                pnode = _Node(span=rem, page=block_row[full], partial=True,
                              parent=node, stamp=0)
                allocator.retain(pnode.page)
                node.partials[rem] = pnode
                self.n_nodes += 1
                new += 1
            self._touch(pnode)
        return new

    # -- eviction (allocation pressure) -------------------------------------

    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in list(node.children.values()) \
                    + list(node.partials.values()):
                if child.is_leaf:
                    out.append(child)
                else:
                    stack.append(child)
        return out

    def _remove(self, node: _Node) -> None:
        parent = node.parent
        if node.partial:
            del parent.partials[node.span]
        else:
            del parent.children[node.span]
        self.n_nodes -= 1

    def reclaim(self, allocator, n_free_target: int) -> int:
        """Evict LRU leaf nodes whose page only the index holds
        (``refcount == 1``) until the allocator has ``n_free_target`` free
        pages or nothing evictable remains.  Leaf-first eviction keeps
        every surviving chain matchable; pages referenced by live block
        tables are never touched.  Returns the number of pages freed."""
        freed = 0
        while allocator.n_free < n_free_target:
            victim = None
            for leaf in self._leaves():
                if allocator.refcount(leaf.page) != 1:
                    continue
                if victim is None or leaf.stamp < victim.stamp:
                    victim = leaf
            if victim is None:
                break
            self._remove(victim)
            allocator.release(victim.page)
            freed += 1
        return freed
