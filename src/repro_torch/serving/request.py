"""Request lifecycle for the continuous-batching engine (a copy of
:mod:`repro.serving.request`).

A request is QUEUED on submit, ACTIVE while it owns a batch slot (from the
prefill admission until its stop condition), and FINISHED once it reaches
a terminal state.  A preempted request moves ACTIVE -> QUEUED (its pages
are freed, its generated-so-far tokens stay on the request) and is later
readmitted with those tokens folded into the re-prefill context, so the
greedy stream continues bit-identically.  ``finish_reason`` values:

* ``"eos"`` — generated the request's ``eos_id``;
* ``"length"`` — generated ``max_new_tokens``;
* ``"cache_full"`` — hit the per-slot ``max_len`` cache ceiling (or, as a
  last resort, was evicted from an all-stalled pool while too long to
  re-prefill);
* ``"timeout"`` — passed ``t_submit + deadline_s`` (queued or active);
* ``"preempted_limit"`` — exhausted its ``max_preemptions`` requeue
  budget;
* ``"rejected"`` — shed at submission by the engine's degradation ladder
  (queue bounded under overload; lowest priority goes first).

Scheduling inputs: ``deadline_s`` is a latency budget in seconds from
submission (``None`` = no deadline); admission is earliest-deadline-first
over the queue.  ``priority`` breaks ties, picks preemption victims, and
orders load shedding (higher = more important; default 0).
``max_preemptions`` bounds how many times the request may be preempted
and requeued before it is terminally evicted.

The engine mutates ``generated`` / ``status`` / the ``t_*`` marks and the
preemption bookkeeping in place; everything above the engine-managed
divider is caller-owned input.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import numpy as np


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    ACTIVE = "active"
    FINISHED = "finished"


class FinishReason:
    """The closed set of terminal ``finish_reason`` values."""

    EOS = "eos"
    LENGTH = "length"
    CACHE_FULL = "cache_full"
    TIMEOUT = "timeout"
    PREEMPTED_LIMIT = "preempted_limit"
    REJECTED = "rejected"
    ALL = (EOS, LENGTH, CACHE_FULL, TIMEOUT, PREEMPTED_LIMIT, REJECTED)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]                 # token ids, ragged lengths ok
    max_new_tokens: int = 16
    eos_id: Optional[int] = None          # None: never stops on a token
    # (1, F, D) modality-frontend embeddings for encdec/vision families
    frontend_embeds: Optional[object] = None
    deadline_s: Optional[float] = None    # latency budget from t_submit
    priority: int = 0                     # higher = more important
    max_preemptions: int = 4              # requeue budget before eviction

    # engine-managed fields
    status: RequestStatus = RequestStatus.QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    slot: Optional[int] = None
    n_preemptions: int = 0
    # scheduler bookkeeping: arrival order (stable across requeues, so a
    # preempted request keeps its seniority) and aged-head skip count
    seq: Optional[int] = None
    sched_skips: int = 0
    # wall-clock marks for time-to-first-token / latency accounting
    t_submit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def ctx_len(self) -> int:
        """Tokens a (re-)prefill must ingest: the prompt plus everything
        generated so far (non-empty only after a preemption)."""
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        return self.status is RequestStatus.FINISHED

    def deadline_abs(self) -> float:
        """Absolute deadline in wall seconds (inf when none is set or the
        request has not been submitted yet)."""
        if self.deadline_s is None or self.t_submit is None:
            return float("inf")
        return self.t_submit + self.deadline_s

    def slack(self, now: float) -> float:
        return self.deadline_abs() - now


def make_ragged_requests(vocab_size: int, n: int, max_prompt_len: int,
                         max_new_tokens: int, seed: int = 0,
                         vary_budget: bool = False,
                         deadline_range: Optional[Tuple[float, float]] = None,
                         deadline_frac: float = 0.5,
                         n_priorities: int = 1) -> List[Request]:
    """Deterministic ragged-length synthetic request stream.

    Shared by the serve launcher and bench_serve so A/B runs and the
    benchmark exercise the same workload.  Prompt lengths draw uniformly
    from [max_prompt_len/4, max_prompt_len]; ``vary_budget`` also draws
    ``max_new_tokens`` from [max/2, max].  ``deadline_range=(lo, hi)``
    gives a uniform ``deadline_s`` to a ``deadline_frac`` fraction of
    requests, and ``n_priorities > 1`` draws ``priority`` uniformly from
    ``[0, n_priorities)`` — the overload bench's SLO mix.
    """
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        plen = int(rs.randint(max(max_prompt_len // 4, 1),
                              max_prompt_len + 1))
        budget = max_new_tokens
        if vary_budget:
            budget = int(rs.randint(max(max_new_tokens // 2, 1),
                                    max_new_tokens + 1))
        deadline = None
        if deadline_range is not None and rs.rand() < deadline_frac:
            lo, hi = deadline_range
            deadline = float(lo + (hi - lo) * rs.rand())
        prio = int(rs.randint(0, n_priorities)) if n_priorities > 1 else 0
        out.append(Request(
            rid=i, prompt=rs.randint(0, vocab_size, size=plen).tolist(),
            max_new_tokens=budget, deadline_s=deadline, priority=prio))
    return out
