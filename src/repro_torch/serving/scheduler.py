"""Deadline-aware slot scheduler for continuous batching (a copy of
:mod:`repro.serving.scheduler`).

The engine owns a fixed-shape cache with ``n_slots`` batch rows; this class
owns the mapping requests -> slots.  Admission order is
**earliest-deadline-first**: queued requests sort by absolute deadline
(``t_submit + deadline_s``; no deadline sorts last), then by priority
(higher first), then by arrival order — so with no deadlines or priorities
set the policy degrades to the original FIFO exactly.  Finished requests
release their slot immediately, so under a steady arrival stream the batch
stays full — the whole point of continuous over static batching: no slot
idles while a long request drains.

With a paged KV cache the engine passes ``admit_ok`` (an allocator
capacity check).  A capacity-blocked queue head does not block the whole
queue: admission tries the first ``window`` candidates (default 4) in
urgency order and admits the first whose prompt fits the free pool, so
one large request waiting for pages cannot head-of-line-starve a stream
of small ones.  Queue order is otherwise preserved — the skipped head
stays the most urgent candidate and is retried on every admission pass.

**Aging** bounds the skipped head's wait (the seed's lookahead had none,
so on a saturated pool where small requests kept arriving and fitting, a
large head could starve forever): every pass that admits past a blocked
head increments its ``sched_skips``; once that exceeds ``age_limit`` the
scheduler admits *nobody else* — freed capacity accrues until the head
fits, force-admitting it ahead of smaller late arrivals.  ``window=1``
restores strict FIFO blocking (and makes aging moot).

Preempted requests re-enter through :meth:`submit` with their original
``seq`` intact, so a requeued request keeps its arrival-order seniority
and its (unchanged) deadline urgency.  :meth:`expire` sweeps queued
requests past their deadline out of the queue so the engine can finish
them as timeouts without burning a prefill on them.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

from repro_torch.serving.request import Request, RequestStatus


class Scheduler:
    def __init__(self, n_slots: int,
                 admit_ok: Optional[Callable[[Request], bool]] = None,
                 window: int = 4, age_limit: int = 16):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if window < 1:
            raise ValueError("need a lookahead window of at least 1")
        if age_limit < 1:
            raise ValueError("need an aging limit of at least 1")
        self.n_slots = n_slots
        self._admit_ok = admit_ok
        self.window = window
        self.age_limit = age_limit
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self._seq = 0

    # -- submission -------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Enqueue a QUEUED request.  First submission stamps the arrival
        sequence number; a preemption requeue re-enters here with ``seq``
        already set and keeps its seniority."""
        if request.status is not RequestStatus.QUEUED:
            raise ValueError(f"request {request.rid} already {request.status}")
        if request.seq is None:
            request.seq = self._seq
            self._seq += 1
        self.queue.append(request)

    # -- admission / release ---------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    @staticmethod
    def urgency(r: Request) -> Tuple[float, int, int]:
        """Sort key: earliest absolute deadline, then priority (higher
        first), then arrival order."""
        return (r.deadline_abs(), -r.priority, r.seq if r.seq is not None
                else 1 << 62)

    def most_urgent(self) -> Optional[Request]:
        """The queued request the next admission will try first."""
        return min(self.queue, key=self.urgency) if self.queue else None

    def _pick(self) -> Optional[Request]:
        """Most urgent queued request that passes ``admit_ok``, bounded by
        the ``window`` lookahead; ``None`` when nothing in the window fits
        — or when the blocked head has aged past ``age_limit``, in which
        case capacity is reserved for it (no one may jump the aged head)."""
        if not self.queue:
            return None
        cand = sorted(self.queue, key=self.urgency)
        head = cand[0]
        if self._admit_ok is None or self._admit_ok(head):
            head.sched_skips = 0
            self.queue.remove(head)
            return head
        head.sched_skips += 1
        if head.sched_skips > self.age_limit:
            return None     # aged out: freed capacity accrues to the head
        for req in cand[1:min(self.window, len(cand))]:
            if self._admit_ok(req):
                self.queue.remove(req)
                return req
        return None

    def admit(self, limit: Optional[int] = None) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue in urgency order (bounded
        capacity lookahead + head aging); returns admissions.

        ``limit`` caps the number of admissions per call — the paged
        engine admits one at a time so each admission's block allocation
        is visible to the next ``admit_ok`` capacity check.
        """
        out = []
        for slot in self.free_slots():
            if not self.queue:
                break
            if limit is not None and len(out) >= limit:
                break
            req = self._pick()
            if req is None:
                break  # nothing in the window fits the pool
            req.status = RequestStatus.ACTIVE
            req.slot = slot
            self.slots[slot] = req
            out.append((slot, req))
        return out

    def expire(self, now: float) -> List[Request]:
        """Remove and return queued requests already past their deadline —
        the engine finishes them as timeouts instead of prefilling work
        that can no longer meet its SLO."""
        expired = [r for r in self.queue if r.deadline_abs() <= now]
        for r in expired:
            self.queue.remove(r)
        return expired

    def release(self, slot: int) -> None:
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} already free")
        req.slot = None
        self.slots[slot] = None

    # -- views ------------------------------------------------------------

    def active(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
