"""Paged block KV cache: host-side allocator + block tables (a copy of
:mod:`repro.serving.blocks`).

Why: ACDC makes the projections nearly free, so at serving time the
dominant allocation is the KV cache — and the dense layout pays worst-case
memory: every slot owns a ``max_len`` slab even when most requests are
short.  Paging splits the cache into fixed-size blocks of ``block_size``
token positions drawn from ONE global pool, so a 10-token request holds
one block while a 500-token request holds 32, and the pool is sized for
the *mix*, not ``n_slots * max_len``.

Layout contract (shared with ``repro_torch.models.attention``):

* The device pool is ``(n_layers, n_blocks + 1, block_size, Hkv, Dh)`` per
  K and V (:func:`repro_torch.models.attention.init_kv_cache_paged`).  Physical
  page ``n_blocks`` is the **write sink** ("trash"): decode writes from
  parked or stalled slots land there and are never read back.  The
  allocator only hands out ids ``0 .. n_blocks - 1``.
* The block table is a static ``(n_slots, max_blocks_per_slot)`` int32
  array; entry ``[slot, i]`` is the physical page holding the slot's token
  positions ``[i * block_size, (i + 1) * block_size)``, or ``-1`` when
  unmapped.  The table lives on the host (the allocator mutates it in
  place) and is shipped to the device each tick as a tiny int32 array.
* Stale page contents are never zeroed: the decode scatter writes with
  ``set`` (not add) and the causal mask hides every position beyond the
  slot's write frontier, so a freed page can be remapped as-is.

Admission contract: a request may only be admitted when
``blocks_for(prompt_len + 1)`` pages are free — its prompt plus room for
the first decode token, so admission can never strand a request that has
nowhere to write token one.  Decode growth allocates lazily: the engine
calls :meth:`BlockAllocator.ensure` before each tick; when the pool is dry
the slot *stalls* (parks for the tick, generating nothing) rather than
corrupting another slot's pages, and resumes once an eviction frees pages.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import trace


class BlockAllocator:
    """Fixed-size block pool with a global free list and per-slot tables.

    ``fault`` (a :class:`repro_torch.serving.faults.FaultPlan`, default
    None = no-op) lets chaos tests make capacity checks and page mapping
    report a dry pool even when pages are free — injected *before* any
    page is handed out, so the allocator's own invariants (checkable any
    time via :meth:`audit`) hold under any plan.
    """

    def __init__(self, n_blocks: int, block_size: int, n_slots: int,
                 max_blocks_per_slot: int, fault: Optional[object] = None):
        if n_blocks < 1 or block_size < 1:
            raise ValueError("need at least one block of at least one token")
        if max_blocks_per_slot < 1:
            raise ValueError("need at least one block per slot")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.n_slots = n_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.fault = fault
        #: physical index of the write-sink page (pool allocates one extra)
        self.trash = n_blocks
        # LIFO free list: recently freed pages are remapped first, which
        # keeps the working set of hot pages small
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._held: set = set()
        self.table = np.full((n_slots, max_blocks_per_slot), -1, np.int32)
        self.peak_in_use = 0

    # -- capacity queries --------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._held)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_admit(self, prompt_len: int) -> bool:
        """Enough free pages for the prompt plus the first decode token?"""
        if self.fault is not None and self.fault.alloc_fail():
            return False
        need = min(self.blocks_for(prompt_len + 1), self.max_blocks_per_slot)
        return self.n_free >= need

    def blocks_held(self, slot: int) -> int:
        return int((self.table[slot] >= 0).sum())

    def _release(self, slot: int, idx: int) -> None:
        """Unmap table entry ``idx`` of ``slot`` and return its page to
        the free list (single home for the release bookkeeping)."""
        blk = int(self.table[slot, idx])
        self.table[slot, idx] = -1
        self._held.discard(blk)
        self._free.append(blk)

    # -- allocation --------------------------------------------------------

    def _pop(self) -> int:
        blk = self._free.pop()
        self._held.add(blk)
        self.peak_in_use = max(self.peak_in_use, len(self._held))
        return blk

    def alloc_slot(self, slot: int, prompt_len: int) -> None:
        """Map the admission's pages: prompt + first decode token."""
        if (self.table[slot] >= 0).any():
            raise ValueError(f"slot {slot} still holds blocks")
        need = min(self.blocks_for(prompt_len + 1), self.max_blocks_per_slot)
        if need > self.n_free:
            raise ValueError(
                f"slot {slot}: need {need} blocks, {self.n_free} free "
                "(admission must be gated on can_admit)")
        for i in range(need):
            self.table[slot, i] = self._pop()

    def ensure(self, slot: int, position: int) -> bool:
        """Make sure the page covering ``position`` is mapped.

        Returns False when the position needs a fresh page and the pool is
        dry — the caller must stall the slot for this tick.  Positions at
        or beyond the virtual row length are parked writes that the device
        routes to the trash page; they need no mapping.
        """
        return self.ensure_range(slot, position, 1)

    def ensure_range(self, slot: int, start: int, count: int) -> bool:
        """Map every page covering positions ``[start, start + count)``
        — the speculative verify window writes ``k + 1`` positions in one
        program.  All-or-nothing: on a dry pool, pages mapped by THIS call
        are returned and False comes back (the caller stalls the slot;
        a partially-mapped window would verify against trash).  Positions
        beyond the virtual row length are trash-routed and need no map.
        """
        if self.fault is not None and self.fault.alloc_fail():
            return False    # injected dry pool: caller stalls the slot
        newly: List[int] = []
        for pos in range(start, start + count):
            if pos >= self.max_blocks_per_slot * self.block_size:
                break
            idx = pos // self.block_size
            if self.table[slot, idx] >= 0:
                continue
            if not self._free:
                for idx2 in newly:
                    self._release(slot, idx2)
                return False
            self.table[slot, idx] = self._pop()
            newly.append(idx)
        return True

    def trim_slot(self, slot: int, n_tokens: int) -> int:
        """Return over-mapped tail pages to the pool — speculative-decode
        rollback: after a verify that mapped ``k + 1`` positions commits
        only ``n_tokens`` total for the slot, pages beyond the first
        ``ceil(n_tokens / block_size)`` hold nothing but rejected-tail
        junk.  Returns the number of pages freed.
        """
        keep = self.blocks_for(max(n_tokens, 1))
        freed = 0
        for idx in range(keep, self.max_blocks_per_slot):
            if self.table[slot, idx] < 0:
                continue
            self._release(slot, idx)
            freed += 1
        return freed

    # -- release -----------------------------------------------------------

    def free_slot(self, slot: int) -> None:
        row = self.table[slot]
        idxs = [i for i in range(self.max_blocks_per_slot) if row[i] >= 0]
        if not idxs:
            raise ValueError(f"slot {slot} holds no blocks (double free?)")
        for idx in idxs:
            blk = int(row[idx])
            if blk not in self._held:
                raise ValueError(f"block {blk} double-freed (slot {slot})")
            self._release(slot, idx)

    # -- invariants --------------------------------------------------------

    def audit(self) -> Dict[str, int]:
        """Full-pool consistency check; raises AssertionError on the first
        violation, returns a summary when clean.

        Invariants (the ones every release path — evict, preempt-requeue,
        ``trim_slot``, all-stalled deadlock eviction, ``ensure_range``
        rollback — must preserve, asserted after every chaos run):

        * the free list holds no duplicates and no held page;
        * free + held partition exactly the ``n_blocks`` real pages
          (no leaks out of the pool, no phantom pages into it);
        * every mapped table entry is a real held page, mapped exactly
          once across the whole table (no double-maps, no stale maps of
          freed pages), and the trash page is never mapped;
        * every held page is mapped somewhere (held-but-unmapped would be
          a leak: unreachable until process exit).
        """
        free = list(self._free)
        if len(free) != len(set(free)):
            raise AssertionError("duplicate pages in the free list")
        freeset = set(free)
        if freeset & self._held:
            raise AssertionError(
                f"pages both free and held: {sorted(freeset & self._held)}")
        universe = set(range(self.n_blocks))
        if freeset | self._held != universe:
            raise AssertionError(
                f"pages leaked from the pool: "
                f"{sorted(universe - freeset - self._held)}")
        mapped = [int(b) for b in self.table.ravel() if b >= 0]
        if len(mapped) != len(set(mapped)):
            dup = sorted(b for b in set(mapped) if mapped.count(b) > 1)
            raise AssertionError(f"pages double-mapped: {dup}")
        bad = [b for b in mapped if b >= self.n_blocks or b < 0]
        if bad:
            raise AssertionError(f"table maps non-pool pages: {sorted(bad)}")
        if set(mapped) != self._held:
            raise AssertionError(
                f"table/held mismatch: stale maps "
                f"{sorted(set(mapped) - self._held)}, leaked holds "
                f"{sorted(self._held - set(mapped))}")
        summary = {"free": len(free), "held": len(self._held),
                   "mapped": len(mapped)}
        trace.instant_global("allocator", "audit", **summary)
        return summary

    # -- device view -------------------------------------------------------

    def phys_row(self, slot: int) -> np.ndarray:
        """Table row with unmapped entries routed to the trash page —
        the layout the prefill page-scatter writes through."""
        row = self.table[slot]
        return np.where(row >= 0, row, self.trash).astype(np.int32)
