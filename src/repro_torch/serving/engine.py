"""Continuous-batching serving engine (port of :mod:`repro.serving.engine`,
the FIFO core).

The engine owns a fixed-shape cache with ``n_slots`` batch rows and runs a
tick loop:

1. **admit** — while a slot is free and requests are queued, the next
   request (arrival order; the scheduler copy keeps the reference's
   priority/lookahead rules) runs ONE batch-1 prefill of its prompt
   right-padded to ``max_prompt_len``, its KV is written into the slot's
   cache row (dense) or pages (paged), and the first token is sampled;
2. **decode** — one decode step advances every active slot by one token;
   free slots ride along parked at the row length, where the cache write
   lands nowhere (dense) or in the trash page (paged);
3. **evict** — requests that hit EOS, their ``max_new_tokens`` budget or
   the cache ceiling release their slot at once.

Paged mode (``paged=True``) draws ``block_size``-token pages from one
pool (:class:`repro_torch.serving.blocks.BlockAllocator`, default size =
dense parity): admission is gated on free pages for the context plus one
token, decode maps pages lazily, and a slot whose next page cannot be
mapped stalls (parks for the tick).  When every active slot is stalled,
the lowest-priority stalled request holding the most pages is preempted
and requeued, chosen among those that may requeue (budget
``max_preemptions`` left and a context that fits ``max_prompt_len``);
only when none may is one evicted, as ``cache_full`` or
``preempted_limit``.  A requeued request waits ``1 << min(n - 1, 6)``
ticks after its n-th preemption, then is re-prefilled over its prompt
plus the tokens generated so far, so a greedy stream continues
unchanged.  :meth:`Engine.preempt` requeues a slot on demand.

Not ported yet (their constructor arguments raise when set): deadlines,
the degradation ladder, fault injection, observability hooks and
speculative decoding (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.dist import steps as steps_mod
from repro_torch.serving import sampler as sampler_mod
from repro_torch.serving.blocks import BlockAllocator
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.scheduler import Scheduler

#: keys of ``Engine.stats`` (the reference's names for the same counts)
STATS_KEYS = ("prefill_dispatches", "decode_ticks", "tokens_out",
              "finished", "preempted", "requeued", "stalled_slot_ticks",
              "prefill_s", "decode_s")


class Engine:
    def __init__(
        self,
        model,
        cfg,
        params,
        n_slots: int = 4,
        max_len: int = 128,
        max_prompt_len: Optional[int] = None,
        sample: str = "greedy",
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 0.0,
        seed: int = 0,
        paged: bool = False,
        block_size: int = 16,
        n_blocks: Optional[int] = None,
        spec_k: int = 0,
        draft=None,
        clock=None,
        fault=None,
        obs=None,
        queue_bound: Optional[int] = None,
    ):
        waiting = {"spec_k": spec_k or None, "draft": draft, "clock": clock,
                   "fault": fault, "obs": obs, "queue_bound": queue_bound}
        unported = sorted(k for k, v in waiting.items() if v is not None)
        if unported:
            raise NotImplementedError(
                f"Engine options {unported} are not ported yet "
                "(ROADMAP.md)")
        if model.prefill is None or model.decode_step is None:
            raise ValueError(f"family {cfg.family!r} cannot serve")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.max_prompt_len = max_prompt_len or max_len // 2
        self.paged = paged
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._decode = steps_mod.make_serve_step(
            model, cfg, sample=sample, temperature=temperature, top_k=top_k,
            top_p=top_p, paged=paged)
        self._sample_args = dict(method=sample, temperature=temperature,
                                 top_k=top_k, top_p=top_p)

        if paged:
            self.block_size = block_size
            self.max_blocks = -(-max_len // block_size)
            self._virtual = self.max_blocks * block_size
            if n_blocks is None:
                n_blocks = n_slots * self.max_blocks  # dense-parity pool
            min_pool = -(-(self.max_prompt_len + 1) // block_size)
            if n_blocks < min_pool:
                raise ValueError(
                    f"pool of {n_blocks} blocks cannot admit a "
                    f"max_prompt_len={self.max_prompt_len} request "
                    f"(needs {min_pool})")
            self.allocator = BlockAllocator(n_blocks, block_size, n_slots,
                                            self.max_blocks)
            self.scheduler = Scheduler(
                n_slots,
                admit_ok=lambda r: self.allocator.can_admit(r.ctx_len))
            self._park = self._virtual
            self._cache = model.init_cache_paged(cfg, n_slots, n_blocks,
                                                 block_size, self.device)
            self._slot_template = model.init_cache(cfg, 1, self._virtual,
                                                   self.device)
            self._prefill = steps_mod.make_prefill_step(model, cfg,
                                                        paged=True)
            self._insert = None
        else:
            self.allocator = None
            self.scheduler = Scheduler(n_slots)
            self._park = max_len
            self._cache = model.init_cache(cfg, n_slots, max_len,
                                           self.device)
            self._slot_template = model.init_cache(cfg, 1, max_len,
                                                   self.device)
            self._prefill = steps_mod.make_prefill_step(model, cfg)
            self._insert = steps_mod.make_insert_step()

        self._tokens = np.zeros((n_slots,), np.int32)
        self._positions = np.full((n_slots,), self._park, np.int32)
        self._stalled: Set[int] = set()
        # preempted requests wait out a backoff in ticks before they
        # re-enter the queue: (eligible tick, request)
        self._backoff: List[Tuple[int, Request]] = []
        self._tick_no = 0
        self.stats = {k: 0 for k in STATS_KEYS}
        self.stats["prefill_s"] = self.stats["decode_s"] = 0.0

    @property
    def cache_bytes(self) -> int:
        """Bytes held by the decode cache (dense slabs or the page pool)."""
        return sum(t.numel() * t.element_size() for t in self._cache.values())

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- submission -------------------------------------------------------

    def submit(self, request: Request) -> None:
        if request.prompt_len < 1:
            raise ValueError(f"request {request.rid}: empty prompt")
        if request.prompt_len > self.max_prompt_len:
            raise ValueError(
                f"request {request.rid}: prompt {request.prompt_len} > "
                f"max_prompt_len {self.max_prompt_len}")
        if request.deadline_s is not None:
            raise NotImplementedError(
                "request deadlines are not ported yet (ROADMAP.md)")
        request.t_submit = time.time()
        self.scheduler.submit(request)

    # -- tick loop --------------------------------------------------------

    def _admit_pass(self) -> None:
        if self.paged:
            # one at a time: each allocation must be visible to the next
            # can_admit capacity check
            while True:
                admitted = self.scheduler.admit(limit=1)
                if not admitted:
                    break
                self._admit(*admitted[0])
        else:
            for slot, req in self.scheduler.admit():
                self._admit(slot, req)

    def _release_backoff(self) -> None:
        """Re-enter preempted requests whose backoff has elapsed."""
        ready = [r for t, r in self._backoff if t <= self._tick_no]
        self._backoff = [(t, r) for t, r in self._backoff
                         if t > self._tick_no]
        for req in ready:
            self.scheduler.submit(req)

    def tick(self) -> int:
        """Backoff release + admit + (paged) map this tick's pages + one
        decode step; returns the number of active slots."""
        self._tick_no += 1
        self._release_backoff()
        self._admit_pass()
        if self.paged:
            self._ensure_blocks()
        active = self.scheduler.active()
        if not active:
            return 0
        t0 = time.perf_counter()
        if self.paged:
            pos = self._positions.copy()
            for slot in self._stalled:
                pos[slot] = self._park  # no write, no token this tick
            tok, self._cache = self._decode(
                self.params, self._cache, self._dev(self._tokens),
                self._dev(pos), self._dev(self.allocator.table), self._gen)
        else:
            tok, self._cache = self._decode(
                self.params, self._cache, self._dev(self._tokens),
                self._dev(self._positions), self._gen)
        tok_np = tok.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_ticks"] += 1
        self.stats["stalled_slot_ticks"] += len(self._stalled)
        now = time.time()
        for slot, req in active:
            if slot in self._stalled:
                continue
            t = int(tok_np[slot])
            req.generated.append(t)
            self.stats["tokens_out"] += 1
            self._positions[slot] += 1
            self._tokens[slot] = t
            self._maybe_finish(slot, req, t, now)
        return len(active)

    @property
    def has_work(self) -> bool:
        """Queued, active, or backoff-parked work remains."""
        return self.scheduler.has_work or bool(self._backoff)

    def run(self, requests: Sequence[Request],
            max_ticks: Optional[int] = None) -> List[Request]:
        """Submit everything, tick until drained, return the requests."""
        for r in requests:
            self.submit(r)
        ticks = 0
        while self.has_work:
            if max_ticks is not None and ticks >= max_ticks:
                raise RuntimeError(f"engine not drained after {ticks} ticks")
            self.tick()
            ticks += 1
        return list(requests)

    # -- internals --------------------------------------------------------

    # -- preemption ---------------------------------------------------------

    def _can_requeue(self, req: Request) -> bool:
        """Requeue budget left, and a context short enough to re-prefill
        (prompt plus generated-so-far within the prefill window)."""
        return (req.n_preemptions < req.max_preemptions
                and req.ctx_len <= self.max_prompt_len)

    def _evict_reason(self, req: Request) -> str:
        return ("preempted_limit"
                if req.n_preemptions >= req.max_preemptions
                else "cache_full")

    def _preempt(self, slot: int, req: Request) -> None:
        """Release the slot (and its pages), park the row and send the
        request back to the queue after an exponential tick backoff; its
        generated tokens fold into the re-prefill at readmission."""
        req.n_preemptions += 1
        self.scheduler.release(slot)
        if self.paged:
            self.allocator.free_slot(slot)
        self._positions[slot] = self._park      # park: no cache writes
        self._stalled.discard(slot)
        req.status = RequestStatus.QUEUED
        self.stats["preempted"] += 1
        self.stats["requeued"] += 1
        backoff = 1 << min(req.n_preemptions - 1, 6)
        self._backoff.append((self._tick_no + backoff, req))

    def preempt(self, slot: int) -> None:
        """Preempt-and-requeue the request in ``slot``; raises when the
        slot is free or the request may not requeue."""
        req = self.scheduler.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is free")
        if not self._can_requeue(req):
            raise ValueError(
                f"request {req.rid} cannot requeue (preemptions "
                f"{req.n_preemptions}/{req.max_preemptions}, ctx "
                f"{req.ctx_len} vs max_prompt_len {self.max_prompt_len})")
        self._preempt(slot, req)

    def _admit(self, slot: int, req: Request) -> None:
        # the prompt plus (after a preemption) every token generated so far
        ctx = list(req.prompt) + [int(t) for t in req.generated]
        clen = len(ctx)
        toks = np.zeros((1, self.max_prompt_len), np.int32)
        toks[0, :clen] = np.asarray(ctx, np.int32)
        lengths = self._dev(np.asarray([clen], np.int32))
        t0 = time.perf_counter()
        if self.paged:
            self.allocator.alloc_slot(slot, clen)
            last, self._cache = self._prefill(
                self.params, self._cache, self._slot_template,
                self._dev(toks), lengths,
                self._dev(self.allocator.phys_row(slot)))
        else:
            last, slot_cache = self._prefill(
                self.params, self._slot_template, self._dev(toks), lengths)
            self._cache = self._insert(self._cache, slot_cache, slot)
        tok = int(sampler_mod.sample(last, generator=self._gen,
                                     **self._sample_args)[0])
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_dispatches"] += 1
        now = time.time()
        if req.t_first_token is None:       # readmissions keep the mark
            req.t_first_token = now
        req.generated.append(tok)
        self.stats["tokens_out"] += 1
        self._tokens[slot] = tok
        self._positions[slot] = clen
        self._maybe_finish(slot, req, tok, now)

    def _ensure_blocks(self) -> None:
        """Map each active slot's next write page; stall the slots the
        pool cannot serve.  If every active slot stalls, preempt and
        requeue the lowest-priority stalled request holding the most
        pages, choosing among the requeueable ones first (eviction only
        when none may requeue), and retry the rest."""
        self._stalled = set()
        active = self.scheduler.active()
        for slot, _ in active:
            if not self.allocator.ensure(slot, int(self._positions[slot])):
                self._stalled.add(slot)
        if self._stalled and len(self._stalled) == len(active):
            stalled = [(s, r) for s, r in active if s in self._stalled]
            requeueable = [(s, r) for s, r in stalled
                           if self._can_requeue(r)]
            slot, req = max(requeueable or stalled, key=lambda sr: (
                -sr[1].priority, self.allocator.blocks_held(sr[0])))
            if requeueable:
                self._preempt(slot, req)
            else:
                self.stats["preempted"] += 1
                self._finish(slot, req, self._evict_reason(req),
                             time.time())
                self._stalled.discard(slot)
            for slot2 in sorted(self._stalled):
                if self.allocator.ensure(slot2, int(self._positions[slot2])):
                    self._stalled.discard(slot2)

    def _maybe_finish(self, slot: int, req: Request, last_token: int,
                      now: float) -> None:
        reason = None
        if req.eos_id is not None and last_token == req.eos_id:
            reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            reason = "length"
        elif self._positions[slot] >= self.max_len:
            reason = "cache_full"   # no room to write the next token
        if reason is not None:
            self._finish(slot, req, reason, now)

    def _finish(self, slot: int, req: Request, reason: str,
                now: float) -> None:
        req.status = RequestStatus.FINISHED
        req.finish_reason = reason
        req.t_finish = now
        self.scheduler.release(slot)
        if self.paged:
            self.allocator.free_slot(slot)
        self._positions[slot] = self._park      # park: no cache writes
        self.stats["finished"] += 1
