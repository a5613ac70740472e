"""Continuous-batching scheduler — a pure-Python, deterministic step loop.

A copy of ``repro.serving.scheduler``; a test drives both with the same
streams and asserts identical plans.  No tensor imports: the scheduler is a state machine over requests, decode
slots and a page allocator, so its invariants (no page leaked, no page
double-allocated, FIFO admission) are unit/property-testable without a
model.  Each ``step()`` returns a :class:`StepPlan` describing exactly what
the executor (``repro_torch.serving.engine``) should run this tick:

  * ``admit``    — requests newly assigned a slot (pages already reserved),
  * ``prefill``  — one prompt chunk per admitted-but-unprefilled request
                   (long prompts are chunked across consecutive steps),
  * ``decode``   — the slots holding requests in the decode phase,
  * ``evict``    — requests that finished last tick (their pages are freed
                   *before* new admissions, so the freed pages are
                   immediately reusable).

Admission is FIFO and all-or-nothing: a request is admitted only when a
free slot exists *and* the allocator can reserve every page the request
can ever touch (``ceil((prompt + max_new_tokens) / page_size)``) — no
mid-flight OOM, no preemption, deterministic order.

With ``prefix_cache=True`` admission first consults a
:class:`~repro_torch.serving.prefix_index.PrefixIndex`: prompt pages whose token
spans are already cached are installed into the block table *by reference*
(refcounted, read-only) and prefill skips the cached span
(``PrefillChunk.cached_upto``); a request diverging inside a cached page
gets a private clone of only that boundary page (copy-on-write — the
engine performs the pool copy).  Pages are returned to the free list only
when their refcount hits zero, so cached pages outlive the request that
wrote them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .paged_cache import NULL_PAGE, pages_needed
from .prefix_index import NO_MATCH, PrefixIndex, PrefixMatch

__all__ = ["Request", "PageAllocator", "Scheduler", "StepPlan",
           "PrefillChunk"]


@dataclasses.dataclass
class Request:
    """One generation request.  ``prompt`` is the token list; generation
    stops after ``max_new_tokens`` (or on ``eos_id`` if given)."""
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be "
                             f">= 1, got {self.max_new_tokens}")

    @property
    def max_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens


class PageAllocator:
    """Refcounting allocator over physical pages ``1 .. num_pages - 1``
    (page ``NULL_PAGE`` is the reserved scratch page, never handed out).

    Every live page carries a refcount: +1 for its *owner* (the request
    that allocated it and may write it), +1 per sharing request
    (``share`` — read-only block-table references and COW copy sources)
    and +1 when the prefix index pins it (``retain``).  A page returns to
    the free list only at refcount zero.  Without sharing every refcount
    is 1 and this degenerates to the plain free-list allocator.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one is the reserved scratch "
                             f"page), got {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, NULL_PAGE, -1))  # pop() -> 1 first
        self._ref: Dict[int, int] = {}                 # page -> refcount
        self._owned: Dict[int, List[int]] = {}         # rid -> writable pages
        self._shared: Dict[int, List[int]] = {}        # rid -> read-only refs
        self._pinned: Set[int] = set()                 # prefix-index refs

    @property
    def n_free(self) -> int:
        return len(self._free)

    def owned(self, rid: int) -> List[int]:
        return list(self._owned.get(rid, ()))

    def shared(self, rid: int) -> List[int]:
        return list(self._shared.get(rid, ()))

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    @property
    def pinned(self) -> Set[int]:
        return set(self._pinned)

    def alloc(self, rid: int, n: int) -> Optional[List[int]]:
        """Reserve ``n`` fresh pages for ``rid`` — all or nothing.  The
        pages are *owned* (writable) by ``rid``; refcount 1 each."""
        if rid in self._owned:
            raise ValueError(f"request {rid} already holds pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self._owned[rid] = pages
        return list(pages)

    def share(self, rid: int, pages: Sequence[int]) -> None:
        """Add read-only references from ``rid`` to live ``pages``
        (shared prefix pages and COW boundary-copy sources)."""
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"page {p} is not live — cannot share")
        for p in pages:
            self._ref[p] += 1
        self._shared.setdefault(rid, []).extend(pages)

    def unshare_all(self, rid: int) -> None:
        """Drop every shared reference ``rid`` holds (failed-admission
        rollback)."""
        for p in self._shared.pop(rid, ()):
            self._drop(p)

    def retain(self, page: int) -> None:
        """Prefix-index pin: one extra reference keeping a cached page
        alive past its owner's eviction.  At most one pin per page."""
        if page in self._pinned:
            raise ValueError(f"page {page} already pinned")
        if self._ref.get(page, 0) < 1:
            raise ValueError(f"page {page} is not live — cannot pin")
        self._pinned.add(page)
        self._ref[page] += 1

    def release(self, page: int) -> None:
        """Drop a prefix-index pin (cache eviction)."""
        self._pinned.remove(page)
        self._drop(page)

    def free(self, rid: int) -> None:
        """Drop every reference ``rid`` holds; pages reaching refcount
        zero return to the free list."""
        owned = self._owned.pop(rid, None)
        shared = self._shared.pop(rid, [])
        if owned is None and not shared:
            raise KeyError(f"request {rid} holds no pages")
        for p in (owned or []) + shared:
            self._drop(p)

    def _drop(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    rid: int
    slot: int
    start: int          # first prompt position of this chunk
    end: int            # one past the last prompt position
    last: bool          # True when this chunk completes the prefill
    cached_upto: int = 0    # prompt positions served from the prefix cache
    #                         (prefill for this request began there, not 0)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    admit: Tuple[Tuple[int, int], ...]        # (rid, slot)
    prefill: Tuple[PrefillChunk, ...]
    decode: Tuple[Tuple[int, int], ...]       # (rid, slot), decode-phase
    evict: Tuple[Tuple[int, int], ...]        # (rid, slot) freed this step

    @property
    def idle(self) -> bool:
        return not (self.admit or self.prefill or self.decode)


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    block_row: List[int]        # physical pages, logical order
    prefilled: int = 0          # prompt tokens already in the cache
    generated: int = 0          # tokens emitted so far
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    cached_upto: int = 0        # prefix positions served from the cache
    n_shared: int = 0           # leading block_row entries shared by ref
    boundary_src: Optional[int] = None   # page to clone into
    #                                      block_row[n_shared] (COW boundary)


class Scheduler:
    """Continuous-batching control loop over ``max_concurrency`` slots."""

    def __init__(self, num_pages: int, page_size: int, max_concurrency: int,
                 max_pages_per_seq: int,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 spec_lookahead: int = 0):
        if page_size < 1 or max_concurrency < 1 or max_pages_per_seq < 1:
            raise ValueError("page_size, max_concurrency and "
                             "max_pages_per_seq must all be >= 1")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if spec_lookahead < 0:
            raise ValueError(f"spec_lookahead must be >= 0, got "
                             f"{spec_lookahead}")
        self.page_size = page_size
        self.max_concurrency = max_concurrency
        self.max_pages_per_seq = max_pages_per_seq
        self.prefill_chunk = prefill_chunk
        # Burst-decode audit (speculative decoding commits up to
        # spec_lookahead + 1 tokens per tick): admission reserves
        # ceil(max_len / page_size) pages up front — ALL pages the request
        # can ever touch, whatever the per-tick burst — so a k-token
        # accept can never need a page the allocator cannot hand out
        # mid-tick.  The executor separately caps each slot's draft budget
        # at max_new_tokens - generated - 1, so record_decode_burst never
        # sees tokens past the reservation; _emit stops a burst at
        # eos/max_new and the tail KV appends land past seq_lens (masked,
        # scratch-absorbed), never in unreserved pages.
        self.spec_lookahead = spec_lookahead
        self.allocator = PageAllocator(num_pages)
        self.prefix_index = PrefixIndex(page_size) if prefix_cache else None
        self.queue: List[Request] = []
        self.active: Dict[int, _Active] = {}          # rid -> state
        self._slots: List[Optional[int]] = [None] * max_concurrency
        self._finished_last_step: List[Tuple[int, int]] = []
        self.completed: Dict[int, List[int]] = {}     # rid -> emitted tokens
        self.stats = {"prompt_tokens": 0, "cached_tokens": 0,
                      "shared_pages": 0, "boundary_copies": 0,
                      "reclaimed_pages": 0}

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if (req.rid in self.active or req.rid in self.completed
                or any(q.rid == req.rid for q in self.queue)):
            raise ValueError(f"request id {req.rid} already submitted")
        need = pages_needed(req.max_len, self.page_size)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request {req.rid}: needs {need} pages, block "
                f"table holds {self.max_pages_per_seq}")
        # A request needing more pages than the pool can ever hand out
        # (num_pages - 1: the scratch page is reserved) would sit at the
        # head of the FIFO queue forever and surface as an opaque
        # starvation RuntimeError deep in engine.run — reject it here.
        # (Prefix-cache sharing could in principle shrink the private
        # demand below the pool size, but a cold cache gives no such
        # guarantee, so the check stays unconditional.)
        if need > self.allocator.num_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {need} pages, but the pool only "
                f"has {self.allocator.num_pages - 1} allocatable pages "
                f"(page {NULL_PAGE} is the reserved scratch page) — it "
                f"could never be admitted")
        self.queue.append(req)

    # -- the step loop ------------------------------------------------------

    def step(self) -> StepPlan:
        """Advance the control loop one tick and say what to execute."""
        evict = tuple(self._finished_last_step)
        self._finished_last_step = []
        for rid, slot in evict:
            self.allocator.free(rid)
            self._slots[slot] = None
            del self.active[rid]

        admit: List[Tuple[int, int]] = []
        while self.queue:
            req = self.queue[0]
            slot = next((i for i, r in enumerate(self._slots) if r is None),
                        None)
            if slot is None:
                break
            match = NO_MATCH
            if self.prefix_index is not None:
                match = self.prefix_index.match(req.prompt)
            n_total = pages_needed(req.max_len, self.page_size)
            n_shared = len(match.shared_pages)
            # Reference every matched page (including the COW boundary
            # source) BEFORE allocating: an index reclaim triggered by the
            # allocation below must never evict them mid-admission.
            refs = list(match.shared_pages)
            if match.boundary_src is not None:
                refs.append(match.boundary_src)
            if refs:
                self.allocator.share(req.rid, refs)
            pages = self.allocator.alloc(req.rid, n_total - n_shared)
            if pages is None and self.prefix_index is not None:
                self.stats["reclaimed_pages"] += self.prefix_index.reclaim(
                    self.allocator, n_total - n_shared)
                pages = self.allocator.alloc(req.rid, n_total - n_shared)
            if pages is None:       # head-of-line blocks: deterministic FIFO
                if refs:
                    self.allocator.unshare_all(req.rid)
                break
            self.queue.pop(0)
            self._slots[slot] = req.rid
            self.active[req.rid] = _Active(
                req=req, slot=slot,
                block_row=list(match.shared_pages) + pages,
                prefilled=match.cached_upto,
                cached_upto=match.cached_upto,
                n_shared=n_shared,
                boundary_src=match.boundary_src)
            if self.prefix_index is not None:
                self.stats["prompt_tokens"] += len(req.prompt)
                self.stats["cached_tokens"] += match.cached_upto
                self.stats["shared_pages"] += n_shared
                self.stats["boundary_copies"] += \
                    int(match.boundary_src is not None)
            admit.append((req.rid, slot))

        prefill: List[PrefillChunk] = []
        decode: List[Tuple[int, int]] = []
        for rid in list(self.active):
            st = self.active[rid]
            n = len(st.req.prompt)
            if st.prefilled < n:
                chunk = self.prefill_chunk or (n - st.prefilled)
                end = min(st.prefilled + chunk, n)
                prefill.append(PrefillChunk(
                    rid=rid, slot=st.slot, start=st.prefilled, end=end,
                    last=end == n, cached_upto=st.cached_upto))
            elif not st.finished:
                decode.append((rid, st.slot))
        return StepPlan(admit=tuple(admit), prefill=tuple(prefill),
                        decode=tuple(decode), evict=evict)

    # -- executor feedback --------------------------------------------------

    def record_prefill(self, rid: int, end: int,
                       first_token: Optional[int] = None) -> None:
        """The executor prefilled ``prompt[.. end]``; the final chunk also
        emits the first generated token.  A completed prefill registers the
        prompt's pages in the prefix index (their contents are final —
        decode appends past the prompt; only then is sharing sound)."""
        st = self.active[rid]
        st.prefilled = end
        if end == len(st.req.prompt) and self.prefix_index is not None:
            self.prefix_index.register(st.req.prompt, st.block_row,
                                       self.allocator)
        if first_token is not None:
            if end != len(st.req.prompt):
                raise ValueError(f"request {rid}: first token emitted before "
                                 f"the prefill completed")
            self._emit(st, first_token)

    def record_decode(self, rid: int, token: int) -> None:
        """The executor decoded one token for ``rid``."""
        self._emit(self.active[rid], token)

    def record_decode_burst(self, rid: int, tokens: Sequence[int]) -> int:
        """A speculative tick committed up to ``spec_lookahead + 1`` tokens
        for ``rid`` in one step.  Emits them in order, stopping at the
        request's own finish condition (eos / max_new_tokens) — tokens
        past it are discarded.  Returns the count actually committed, by
        which the executor advances ``seq_lens`` (and feeds the proposer).
        """
        if len(tokens) > self.spec_lookahead + 1:
            raise ValueError(
                f"request {rid}: burst of {len(tokens)} tokens exceeds "
                f"spec_lookahead + 1 = {self.spec_lookahead + 1}")
        if not tokens:
            raise ValueError(f"request {rid}: empty decode burst — every "
                             f"verify tick commits at least one token")
        st = self.active[rid]
        committed = 0
        for t in tokens:
            self._emit(st, t)
            committed += 1
            if st.finished:
                break
        return committed

    def _emit(self, st: _Active, token: int) -> None:
        if st.finished:
            raise RuntimeError(
                f"request {st.req.rid}: token emitted after finish")
        st.tokens.append(token)
        st.generated += 1
        eos = st.req.eos_id is not None and token == st.req.eos_id
        if st.generated >= st.req.max_new_tokens or eos:
            st.finished = True
            self.completed[st.req.rid] = list(st.tokens)
            self._finished_last_step.append((st.req.rid, st.slot))

    # -- views for the executor --------------------------------------------

    def block_row(self, rid: int) -> List[int]:
        return list(self.active[rid].block_row)

    @property
    def prefix_stats(self) -> Dict[str, float]:
        """Cache-effectiveness counters (all zero without prefix caching):
        ``hit_rate`` = cached / submitted prompt tokens =
        prefill-tokens-skipped fraction."""
        s = dict(self.stats)
        s["hit_rate"] = (s["cached_tokens"] / s["prompt_tokens"]
                         if s["prompt_tokens"] else 0.0)
        return s

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def done(self) -> bool:
        return not self.queue and not self.active
