"""``PagedServingEngine`` — the executor gluing the pure-Python scheduler to
the port's paged decode path (counterpart of ``repro.serving.engine``).

One engine ``step()`` executes one scheduler tick:

  1. evictions: finished requests' slots are detached (their pages were
     freed by the scheduler; stale pool contents are unreachable once no
     block table points at them — nothing is zeroed),
  2. admissions: the new request's block-table row is installed,
  3. prefill: one ``prefill`` call per request (single-shot), its caches
     scattered into the request's pages,
  4. decode: ONE batched ``decode_step_paged`` over every slot.

Slots not decoding this tick ride the batched step as ghost lanes: free
slots point their whole block-table row at ``NULL_PAGE`` (their writes land
on the scratch page) and just-prefilled slots write at exactly
``seq_lens[slot]``, the position their next real decode step overwrites
before anything reads it.  Greedy decoding (argmax).  Policies reach the
engine through the ambient ``policy_scope``.

Not ported yet (``NotImplementedError``): ``prefill_chunk``,
``prefix_cache``, ``speculative``, ``quantized_kv``, ``mesh`` and the
tuned ``page_size=None``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode_step_paged, init_paged_decode_caches, prefill
from repro_torch.models.base import resolve_device
from .paged_cache import NULL_PAGE, pages_needed, write_prefill_prefix
from .scheduler import Request, Scheduler, StepPlan

__all__ = ["PagedServingEngine"]


class PagedServingEngine:
    """Continuous-batching serving over paged KV caches.

    ``max_seq_len`` bounds prompt + generation per request (it sizes the
    block table); ``num_pages`` defaults to full residency.  ``device``
    defaults to ``"cuda"`` and raises without a card — pass ``"cpu"`` to
    run the plain versions.  ``params`` must live on ``device``.  On a
    CUDA device the engine turns TF32 off for matmuls and convolutions
    (process-wide): the twins and ``fp32_vpu`` rely on full fp32.
    ``stats`` counts prefill calls and batched decode ticks;
    ``all_logits_finite`` says whether every logit computed was finite.
    """

    def __init__(self, cfg: ArchConfig, params, *,
                 page_size: Optional[int] = 16,
                 max_concurrency: int = 4, max_seq_len: int = 256,
                 num_pages: Optional[int] = None,
                 prefill_chunk=None,
                 prefix_cache: bool = False,
                 mesh=None,
                 eos_id: Optional[int] = None,
                 speculative=None,
                 quantized_kv: bool = False,
                 device="cuda"):
        unported = {"prefill_chunk": prefill_chunk is not None,
                    "prefix_cache": prefix_cache,
                    "speculative": speculative is not None,
                    "quantized_kv": quantized_kv,
                    "mesh": mesh is not None,
                    "page_size=None (tuned)": page_size is None}
        for name, asked in unported.items():
            if asked:
                raise NotImplementedError(
                    f"PagedServingEngine({name}) is not ported yet")
        self.device = resolve_device(device)
        p_dev = next(params.parameters()).device
        if p_dev.type != self.device.type or self.device.index not in (
                None, p_dev.index):
            raise ValueError(f"params live on {p_dev}, the engine runs on "
                             f"{self.device}")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.params = params
        self.page_size = page_size
        self.eos_id = eos_id
        self.npages_per_seq = pages_needed(max_seq_len, page_size)
        if num_pages is None:
            num_pages = 1 + max_concurrency * self.npages_per_seq
        self.scheduler = Scheduler(num_pages, page_size, max_concurrency,
                                   self.npages_per_seq)
        self.caches = init_paged_decode_caches(cfg, max_concurrency,
                                               num_pages, page_size,
                                               device=self.device)
        self.block_table = np.full((max_concurrency, self.npages_per_seq),
                                   NULL_PAGE, np.int32)
        self.seq_lens = np.zeros((max_concurrency,), np.int32)
        self._last_tok = np.zeros((max_concurrency,), np.int64)
        self._next_rid = 0
        self.stats = {"prefills": 0, "decode_ticks": 0}
        # Device-side AND of isfinite over every logit computed (read once,
        # by all_logits_finite, so the tick loop gains no host sync).
        self._finite = torch.ones((), dtype=torch.bool, device=self.device)

    def _dev(self, x, dtype=torch.int32) -> torch.Tensor:
        """Host array -> control tensor on the engine's device, with no host
        sync (the reference's ``_dev`` is an asynchronous ``jnp.asarray``).

        On a card the values are first copied into a page-locked block of
        torch's caching host allocator, and that block to the card with a
        non-blocking copy.  The copy records an event on the block, and the
        allocator hands the block out again only once that event has
        completed, so every call stages into its own block and the host may
        rewrite ``x`` (the block table, ``seq_lens``, the last tokens) at
        once.  On the CPU nothing is pinned: the plain ``as_tensor``.
        """
        if self.device.type != "cuda":
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)
        host = torch.as_tensor(np.asarray(x), dtype=dtype).pin_memory()
        return host.to(self.device, non_blocking=True)

    @staticmethod
    def _host_tokens(tokens: torch.Tensor) -> np.ndarray:
        """The greedy tokens, device -> host: the one host sync of a tick,
        which the reference makes too (its ``np.asarray`` of the argmax)."""
        return tokens.cpu().numpy()

    # -- submission ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               rid: Optional[int] = None) -> int:
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        self.scheduler.submit(Request(rid=rid, prompt=list(prompt),
                                      max_new_tokens=max_new_tokens,
                                      eos_id=self.eos_id))
        return rid

    # -- one tick -----------------------------------------------------------

    def step(self) -> StepPlan:
        with torch.inference_mode():
            return self._step()

    def _step(self) -> StepPlan:
        sched = self.scheduler
        plan = sched.step()
        for rid, slot in plan.evict:
            self.block_table[slot] = NULL_PAGE
            self.seq_lens[slot] = 0
        for rid, slot in plan.admit:
            row = sched.block_row(rid)
            self.block_table[slot] = NULL_PAGE
            self.block_table[slot, :len(row)] = row
            self.seq_lens[slot] = sched.active[rid].cached_upto

        for chunk in plan.prefill:
            st = sched.active[chunk.rid]
            tokens = list(st.req.prompt[chunk.start:chunk.end])
            logits, pf = prefill(self.params,
                                 {"tokens": self._dev([tokens], torch.int64)},
                                 self.cfg)
            write_prefill_prefix(self.caches, pf,
                                 self._dev(self.block_table[chunk.slot]),
                                 chunk.slot)
            self.stats["prefills"] += 1
            self._finite = self._finite & torch.isfinite(logits).all()
            self.seq_lens[chunk.slot] = chunk.end
            tok = int(self._host_tokens(torch.argmax(logits[0])))
            sched.record_prefill(chunk.rid, chunk.end, first_token=tok)
            self._last_tok[chunk.slot] = tok

        if plan.decode:
            logits, self.caches = decode_step_paged(
                self.params, self._dev(self._last_tok[:, None], torch.int64),
                self.caches, self._dev(self.block_table),
                self._dev(self.seq_lens), self.cfg)
            self.stats["decode_ticks"] += 1
            self._finite = self._finite & torch.isfinite(logits).all()
            next_tok = self._host_tokens(torch.argmax(logits, dim=-1))
            for rid, slot in plan.decode:
                self.seq_lens[slot] += 1
                tok = int(next_tok[slot])
                sched.record_decode(rid, tok)
                self._last_tok[slot] = tok
        return plan

    @property
    def all_logits_finite(self) -> bool:
        """True when every logit the engine computed so far was finite."""
        return bool(self._finite)

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive the step loop until every submitted request completed.
        Returns ``{rid: emitted tokens}``."""
        steps = 0
        while not self.scheduler.done:
            plan = self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
            if plan.idle and not self.scheduler.done:
                raise RuntimeError(
                    "scheduler idle with work pending (page/slot starvation: "
                    "a queued request can never be admitted)")
        return dict(self.scheduler.completed)
