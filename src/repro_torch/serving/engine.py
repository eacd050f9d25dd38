"""Continuous-batching serving engine (port of :mod:`repro.serving.engine`).

The engine owns a fixed-shape cache with ``n_slots`` batch rows and runs a
tick loop:

1. **admit** — while a slot is free and requests are queued, the most
   urgent request (earliest deadline, then priority, then arrival order;
   :mod:`repro_torch.serving.scheduler`) runs ONE batch-1 prefill of its
   context right-padded to ``max_prompt_len`` (a request's
   ``frontend_embeds`` replacing its first positions, or, for the encdec
   family, which refuses a request without them, the audio frames its
   encoder reads), its KV is written into the slot's cache row (dense) or
   pages (paged), its recurrent SSM/conv state (mamba2, zamba2) or its
   cross K/V and frame count (encdec) into the slot's row, and the first
   token is sampled (the time-to-first-token mark);
2. **decode** — one decode step advances every active slot by one token;
   free slots ride along parked at the row length, where the cache write
   lands nowhere (dense) or in the trash page (paged);
3. **evict** — requests that hit EOS, their ``max_new_tokens`` budget,
   the cache ceiling or their deadline release their slot at once.

Paged mode (``paged=True``; refused for a family whose decode state is
not length-proportional, the ssm one) draws ``block_size``-token pages
from one pool (:class:`repro_torch.serving.blocks.BlockAllocator`,
default size = dense parity): admission is gated on free pages for the
context plus one token, decode maps pages lazily, and a slot whose next
page cannot be mapped stalls (parks for the tick).

**Preemption with recompute**: when every active slot is stalled, or a
deadline demands the capacity, the victim's pages are released and the
request is requeued after ``1 << min(n - 1, 6)`` ticks of backoff; it is
re-prefilled over its prompt plus the tokens generated so far, so a
greedy stream continues unchanged.  Past its ``max_preemptions`` budget
it finishes as ``preempted_limit``.  The same path heals corrupt decode
output: every sampled id outside ``[0, vocab_size)`` is requeued, never
committed.

**Deadlines**: queued requests past their deadline finish as
``timeout`` without a prefill, active ones are evicted on expiry, and a
queued request about to miss its deadline may preempt the active request
with the most slack.

**Graceful degradation**: a tick-latency watchdog
(:class:`repro_torch.dist.elastic.StragglerMonitor`) plus pool-pressure and
queue-depth signals step a reversible ladder down, and back up after
sustained calm: shrink ``spec_k`` (``spec_half``), then disable
speculation (``spec_off``), then bound the admission queue at
``queue_bound`` and shed the lowest-priority arrivals (``shed``,
``finish_reason="rejected"``).  Without speculation the ladder is
``full``, ``shed``.  Ladder moves change no greedy token stream in
exact arithmetic: speculation commits the target's own greedy tokens at
any k, including 0, and every KV write SETS its row (the reference's
dense decode adds into it, so its streams can change when it steps to
``spec_off`` after rejections; ROADMAP.md §3).  In floating point the
streams are equal where the verify and the decode round alike (the same
``scaled_matmul`` regime); in fp32 they held equal in every run of
``chip_smoke.py`` so far, where the regimes differ too.  In bf16 at full
width the verify's M = slots (k + 1) rows take the tensor-core regime
where decode's M = slots take the weight stream, and a stream can depart
at a near-tied argmax or further (PERF.md §6).

**Speculative decoding** (``spec_k > 0``) replaces the one-token decode
tick with draft -> verify -> accept/rollback: a cheap draft
(:mod:`repro_torch.spec.draft`, by default the target's own cascades cut
to ``max(1, sell_k // 2)`` layers) proposes ``spec_k`` tokens a slot, ONE
verify pass of the target scores them
(:func:`repro_torch.dist.steps.make_verify_step`; paged, through the
paged-attention kernel at T = ``spec_k + 1``), and each slot advances by
its accepted length.  Greedy streams equal the non-speculative engine's
wherever the two round alike (see the ladder above).

Fault injection (``fault=FaultPlan(...)``,
:mod:`repro_torch.serving.faults`) and observability (``obs=``,
:mod:`repro_torch.obs`: the metrics registry behind ``stats``, span
tracing, profiler ranges and windows) are the reference's, each a single
``None`` check when off.  With a ``clock``, every duration and timestamp
comes from it, so a virtual-clock run is deterministic.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.dist import steps as steps_mod
from repro_torch.dist.elastic import StragglerMonitor
from repro_torch.obs import Observability
from repro_torch.obs.metrics import StatsView
from repro_torch.serving import sampler as sampler_mod
from repro_torch.serving.blocks import BlockAllocator
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.scheduler import Scheduler

#: ``Engine.stats`` key -> (registry metric name, kind), the reference's
#: table.  Kinds: ``counter`` (int-valued), ``seconds`` (float counter),
#: ``gauge``, ``derived`` (computed at read/snapshot time, never stored).
#: The glossary lives in ``repro_torch/obs/__init__.py``.
STATS_METRICS = {
    "prefill_dispatches": ("serve_prefill_dispatches_total", "counter"),
    "decode_ticks": ("serve_decode_ticks_total", "counter"),
    "tokens_out": ("serve_tokens_out_total", "counter"),
    "finished": ("serve_finished_total", "counter"),
    "preempted": ("serve_preempted_total", "counter"),
    "requeued": ("serve_requeued_total", "counter"),
    "timeout": ("serve_timeout_total", "counter"),
    "rejected": ("serve_rejected_total", "counter"),
    "deadline_preempts": ("serve_deadline_preempts_total", "counter"),
    "corrupt_ticks": ("serve_corrupt_ticks_total", "counter"),
    "stalled_slot_ticks": ("serve_stalled_slot_ticks_total", "counter"),
    "degrade_level": ("serve_degrade_level", "gauge"),
    "degrade_down": ("serve_degrade_down_total", "counter"),
    "degrade_up": ("serve_degrade_up_total", "counter"),
    "prefill_s": ("serve_prefill_seconds_total", "seconds"),
    "decode_s": ("serve_decode_seconds_total", "seconds"),
    "drafted": ("serve_spec_drafted_total", "counter"),
    "accepted": ("serve_spec_accepted_total", "counter"),
    "acceptance_rate": ("serve_acceptance_rate", "derived"),
    "attn_gather_bytes": ("serve_attn_gather_bytes_total", "counter"),
    "attn_kernel_bytes": ("serve_attn_kernel_bytes_total", "counter"),
}


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
        admit_window: int = 4,
        age_limit: int = 16,
        spec_k: int = 0,
        draft=None,
        draft_depth: Optional[int] = None,
        draft_skip_layers: int = 0,
        clock: Optional[Callable[[], float]] = None,
        fault: Optional[FaultPlan] = None,
        obs: Optional[Observability] = None,
        deadline_margin_s: float = 0.05,
        queue_bound: Optional[int] = None,
        degrade_down_after: int = 3,
        degrade_up_after: int = 12,
    ):
        if model.prefill is None or model.decode_step is None:
            raise ValueError(f"family {cfg.family!r} cannot serve")
        if paged and (model.init_cache_paged is None
                      or model.decode_step_paged is None):
            raise ValueError(
                f"family {cfg.family!r} has no paged KV cache (its decode "
                "state is not length-proportional); serve it dense")
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 disables)")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.max_prompt_len = max_prompt_len or max_len // 2
        self.paged = paged
        self._clock = clock if clock is not None else time.time
        # duration source: wall time by default, the INJECTED clock when
        # one is supplied, so a virtual-clock run has deterministic
        # tick/prefill/decode timings (trace and snapshot replays match)
        self._timer = clock if clock is not None else time.perf_counter
        self._fault = fault
        self.deadline_margin_s = deadline_margin_s
        self.queue_bound = queue_bound if queue_bound is not None \
            else 4 * n_slots
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
                                            self.max_blocks, fault=fault)
            # capacity check on ctx_len: a requeued request re-prefills its
            # prompt PLUS generated-so-far tokens
            self.scheduler = Scheduler(
                n_slots,
                admit_ok=lambda r: self.allocator.can_admit(r.ctx_len),
                window=admit_window, age_limit=age_limit)
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
            self.scheduler = Scheduler(n_slots, age_limit=age_limit)
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
        # observability: the registry is ALWAYS live (it backs ``stats``);
        # tracing / export / profiling are optional, each a single None
        # check when off.  A bundle must not be shared between engines:
        # the get-or-create registry would silently merge their stats.
        self.obs = obs if obs is not None else Observability.off()
        self._tracer = self.obs.tracer
        if self._tracer is not None and self._tracer.clock is None:
            self._tracer.clock = self._clock  # adopt the engine clock
        if self.obs.window is not None and self.obs.window.device is None:
            self.obs.window.device = self.device
        self._obs_tick = self.obs.tick_hook()
        self._prof = self.obs.prof
        self.stats = self._build_stats()
        reg = self.obs.registry
        self._h_ttft = reg.histogram(
            "serve_ttft_seconds", "submit -> first token latency")
        self._h_tpot = reg.histogram(
            "serve_tpot_seconds",
            "per-output-token decode latency: (t_finish - ttft)/(n-1)")
        self._h_tick = reg.histogram(
            "serve_tick_seconds", "engine tick wall latency")
        self.wall_clock_exceeded = False
        # preempted requests wait out a backoff in ticks before they
        # re-enter the queue: (eligible tick, request)
        self._backoff: List[Tuple[int, Request]] = []
        self._tick_no = 0

        self.spec_k = spec_k
        self.spec_k_eff = spec_k
        self.draft = None
        if spec_k:
            self._init_spec(spec_k, draft, draft_depth, draft_skip_layers,
                            sample, temperature, top_k, top_p)

        # graceful-degradation ladder: reversible step-downs, cheapest
        # first (shrinking speculation costs acceptance, never tokens),
        # shedding strictly last
        self._levels = ["full"]
        if spec_k >= 2:
            self._levels.append("spec_half")
        if spec_k >= 1:
            self._levels.append("spec_off")
        self._levels.append("shed")
        self._level = 0
        self._hot = 0
        self._calm = 0
        self.degrade_down_after = degrade_down_after
        self.degrade_up_after = degrade_up_after
        self._watchdog = StragglerMonitor(alpha=0.2, factor=3.0, warmup=3,
                                          adapt_after=5)

    def _init_spec(self, spec_k, draft, draft_depth, draft_skip_layers,
                   sample, temperature, top_k, top_p) -> None:
        cfg = self.cfg
        self._verify = steps_mod.make_verify_step(
            self.model, cfg, sample=sample, temperature=temperature,
            top_k=top_k, top_p=top_p, paged=self.paged, park=self._park)
        if draft is None:
            # the paper's own draft: the target's cascades truncated to
            # half depth (sections 3-4)
            from repro_torch.spec.draft import TruncatedCascadeDraft

            depth = (draft_depth if draft_depth is not None
                     else max(1, cfg.sell_k // 2))
            draft = TruncatedCascadeDraft(cfg, self.params, depth=depth,
                                          skip_layers=draft_skip_layers)
        self.draft = draft
        self.draft.prepare(self.n_slots, self.max_len, spec_k, sample,
                           temperature, top_k, top_p)

    # -- accounting --------------------------------------------------------

    def _build_stats(self) -> StatsView:
        """Bind every ``stats`` key to its registry metric
        (``STATS_METRICS``); ``acceptance_rate`` is derived from the
        drafted/accepted counters at read time."""
        reg = self.obs.registry
        view = StatsView()
        for key, (name, kind) in STATS_METRICS.items():
            if kind == "counter":
                m = reg.counter(name)
                view.bind(key, lambda m=m: int(m.value), m.set)
            elif kind == "seconds":
                m = reg.counter(name)
                view.bind(key, lambda m=m: float(m.value), m.set)
            elif kind == "gauge":
                m = reg.gauge(name)
                view.bind(key, lambda m=m: int(m.value), m.set)
        drafted = reg.counter(STATS_METRICS["drafted"][0])
        accepted = reg.counter(STATS_METRICS["accepted"][0])
        rate = reg.derived_gauge(
            STATS_METRICS["acceptance_rate"][0],
            lambda: (accepted.value / drafted.value) if drafted.value
            else 0.0,
            "accepted/drafted, computed at snapshot time (never stale)")
        view.bind("acceptance_rate", rate)
        return view

    @property
    def cache_bytes(self) -> int:
        """Bytes held by the decode cache (dense slabs or the page pool),
        plus the draft's dense slot cache in speculative mode."""
        total = sum(t.numel() * t.element_size()
                    for t in self._cache.values())
        if self.draft is not None:
            total += self.draft.cache_bytes
        return total

    def _attn_bytes_tick(self, pos: np.ndarray) -> None:
        """Analytic attention K/V traffic of one paged decode or verify
        tick (a model, not a measurement), the reference's:
        ``attn_gather_bytes`` is what a gather of every slot's whole
        virtual row reads, ``attn_kernel_bytes`` what the streaming kernel
        reads (each live row's mapped prefix; parked and stalled rows cost
        nothing)."""
        gather = kernel = 0
        for name, pages in self._cache.items():
            if "pages" not in name:
                continue
            n_layers, bs = pages.shape[0], pages.shape[2]
            tok_bytes = int(np.prod(pages.shape[3:])) * pages.element_size()
            gather += n_layers * self.n_slots * self._virtual * tok_bytes
            for p in pos:
                p = int(p)
                if p < self._virtual:
                    kernel += n_layers * (-(-p // bs) * bs) * tok_bytes
        self.stats["attn_gather_bytes"] += gather
        self.stats["attn_kernel_bytes"] += kernel

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
        if request.deadline_s is not None and request.deadline_s <= 0:
            raise ValueError(
                f"request {request.rid}: deadline_s must be positive")
        if self.cfg.family == "encdec":
            # without frames the cross K/V would stay all zero: the request
            # would "succeed" while conditioning on a null encoder
            fe = request.frontend_embeds
            if fe is None:
                raise ValueError(f"request {request.rid}: encdec family "
                                 "needs frontend_embeds")
            room = self._slot_template["xk"].shape[2]
            if fe.shape[1] > room:
                raise ValueError(
                    f"request {request.rid}: {fe.shape[1]} frames > the "
                    f"cross cache's {room} a slot")
        now = self._clock()
        request.t_submit = now
        tr = self._tracer
        if tr is not None:
            tr.req_phase(request.rid, "queued")
        # the ladder's last rung: the admission queue is bounded and the
        # lowest-priority request (newest on ties) is shed
        if (self._levels[self._level] == "shed"
                and len(self.scheduler.queue) >= self.queue_bound):
            victim = min(
                [request] + list(self.scheduler.queue),
                key=lambda r: (r.priority,
                               -(r.seq if r.seq is not None else 1 << 62)))
            if victim is not request:
                self.scheduler.queue.remove(victim)
            victim.status = RequestStatus.FINISHED
            victim.finish_reason = "rejected"
            victim.t_finish = now
            self.stats["rejected"] += 1
            self.stats["finished"] += 1
            if tr is not None:
                tr.req_terminal(victim.rid, "rejected",
                                shed_for=request.rid)
            if victim is request:
                return
        self.scheduler.submit(request)

    # -- tick loop --------------------------------------------------------

    def _release_backoff(self) -> None:
        """Re-enter preempted requests whose backoff has elapsed."""
        if not self._backoff:
            return
        ready = [r for t, r in self._backoff if t <= self._tick_no]
        self._backoff = [(t, r) for t, r in self._backoff
                         if t > self._tick_no]
        for req in ready:
            self.scheduler.submit(req)
            if self._tracer is not None:
                self._tracer.req_phase(req.rid, "queued", requeue=True)

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

    def _admit_and_map(self) -> None:
        """Backoff release + admission + deadline preemption + (paged)
        mapping of this tick's write window (1 position, k+1 when
        speculative)."""
        self._release_backoff()
        self._admit_pass()
        if self._deadline_preempt(self._clock()):
            self._admit_pass()
        if self.paged:
            self._ensure_blocks(need=(self.spec_k_eff or 0) + 1)

    def tick(self) -> int:
        """Deadline sweep + admit + one decode (or speculative) step;
        returns the number of active slots."""
        tick_no = self._tick_no
        self._tick_no += 1
        if self._obs_tick is not None:    # exporter cadence + profile
            self._obs_tick(tick_no)       # window; None when neither set
        self._expire_deadlines(self._clock())
        t0 = self._timer()
        if self.spec_k_eff:
            n = self._tick_spec(tick_no)
        else:
            n = self._tick_decode(tick_no)
        dt = self._timer() - t0
        if self._fault is not None:
            extra = self._fault.extra_tick_s(tick_no)
            if extra and self._tracer is not None:
                self._tracer.instant("engine", "fault:slow_tick",
                                     tick=tick_no, extra_s=extra)
            dt += extra
        self._h_tick.observe(dt)
        self._observe_pressure(dt, tick_no)
        return n

    def _tick_decode(self, tick_no: int) -> int:
        self._admit_and_map()
        active = self.scheduler.active()
        if not active:
            return 0
        t0 = self._timer()
        with self._prof.annotate("decode"):
            if self.paged:
                pos = self._positions.copy()
                for slot in self._stalled:
                    pos[slot] = self._park  # no write, no token this tick
                self._attn_bytes_tick(pos)
                tok, self._cache = self._decode(
                    self.params, self._cache, self._dev(self._tokens),
                    self._dev(pos), self._dev(self.allocator.table),
                    self._gen)
            else:
                tok, self._cache = self._decode(
                    self.params, self._cache, self._dev(self._tokens),
                    self._dev(self._positions), self._gen)
            tok_np = tok.cpu().numpy()
        self.stats["decode_s"] += self._timer() - t0
        self.stats["decode_ticks"] += 1
        self.stats["stalled_slot_ticks"] += len(self._stalled)
        if self._fault is not None and self._fault.logits_corrupt(tick_no):
            # simulated NaN/inf logits: every sampled id is garbage
            tok_np = np.full_like(tok_np, -1)
            self.stats["corrupt_ticks"] += 1
            if self._tracer is not None:
                self._tracer.instant("engine", "fault:corrupt_logits",
                                     tick=tick_no)
        now = self._clock()
        for slot, req in active:
            if slot in self._stalled:
                continue
            t = int(tok_np[slot])
            if not 0 <= t < self.cfg.vocab_size:
                # corrupt decode output: heal by recompute (requeue and
                # re-prefill) rather than commit a garbage token
                self._heal_or_kill(slot, req, now)
                continue
            req.generated.append(t)
            self.stats["tokens_out"] += 1
            self._positions[slot] += 1
            self._tokens[slot] = t
            self._maybe_finish(slot, req, t, now)
        return len(active)

    def _tick_spec(self, tick_no: int) -> int:
        """One speculative tick: draft k, verify once, advance each slot
        by its accepted length, roll back the rest."""
        k = self.spec_k_eff
        self._admit_and_map()
        active = self.scheduler.active()
        if not active:
            return 0
        pos = self._positions.copy()
        for slot in self._stalled:
            pos[slot] = self._park  # no writes, no tokens this tick
        if self.paged:
            self._attn_bytes_tick(pos)

        t0 = self._timer()
        tokens, pos_dev = self._dev(self._tokens), self._dev(pos)
        with self._prof.annotate("draft"):
            drafts, draft_logits = self.draft.propose(tokens, pos_dev,
                                                      self._gen)
        tok_mat = torch.cat([tokens[:, None], drafts.to(tokens.dtype)],
                            dim=1)
        with self._prof.annotate("verify"):
            if self.paged:
                acc, out, self._cache = self._verify(
                    self.params, self._cache, tok_mat, drafts, draft_logits,
                    pos_dev, self._dev(self.allocator.table), self._gen)
            else:
                acc, out, self._cache = self._verify(
                    self.params, self._cache, tok_mat, drafts, draft_logits,
                    pos_dev, self._gen)
            got = torch.cat([acc[:, None], out], dim=1).cpu().numpy()
        acc_np, out_np = got[:, 0], got[:, 1:]
        self.stats["decode_s"] += self._timer() - t0
        self.stats["decode_ticks"] += 1
        self.stats["stalled_slot_ticks"] += len(self._stalled)
        corrupt = (self._fault is not None
                   and self._fault.logits_corrupt(tick_no))
        if corrupt:
            self.stats["corrupt_ticks"] += 1
            if self._tracer is not None:
                self._tracer.instant("engine", "fault:corrupt_logits",
                                     tick=tick_no)

        now = self._clock()
        n_adv = np.zeros((self.n_slots,), np.int32)
        for slot, req in active:
            if slot in self._stalled:
                continue
            if corrupt:
                # simulated NaN/inf verify logits: commit nothing for the
                # slot, heal by recompute (requeue -> re-prefill)
                self._heal_or_kill(slot, req, now)
                continue
            n = int(acc_np[slot])
            self.stats["drafted"] += k
            self.stats["accepted"] += n
            # commit the accepted drafts plus the correction/bonus token,
            # applying the stop rules in stream order so EOS, budget and
            # ceiling cut the stream where the non-speculative engine would
            for i in range(n + 1):
                t = int(out_np[slot, i])
                if not 0 <= t < self.cfg.vocab_size:
                    self._heal_or_kill(slot, req, now)
                    break
                req.generated.append(t)
                self.stats["tokens_out"] += 1
                self._positions[slot] += 1
                self._tokens[slot] = t
                n_adv[slot] += 1
                self._maybe_finish(slot, req, t, now)
                if req.done:
                    break
        self.draft.commit(n_adv)
        if self.paged:
            # rollback: return verify-window pages beyond each surviving
            # slot's committed frontier; +1 keeps the page the NEXT tick
            # writes first, so the admission pass cannot snatch it back
            for slot, req in active:
                if (req.status is RequestStatus.ACTIVE
                        and slot not in self._stalled):
                    self.allocator.trim_slot(
                        slot, int(self._positions[slot]) + 1)
        return len(active)

    @property
    def has_work(self) -> bool:
        """Queued, active, or backoff-parked work remains."""
        return self.scheduler.has_work or bool(self._backoff)

    def run(self, requests: Sequence[Request],
            max_ticks: Optional[int] = None,
            wall_clock_limit_s: Optional[float] = None) -> List[Request]:
        """Submit everything, tick until drained, return the requests.

        ``wall_clock_limit_s`` bounds the real time spent in the loop: the
        run then stops with partial results (``wall_clock_exceeded`` set,
        unfinished requests left as they are).  ``max_ticks`` bounds the
        tick count and raises, as a logic-error guard.
        """
        for r in requests:
            self.submit(r)
        ticks = 0
        t0 = time.perf_counter()
        while self.has_work:
            if (wall_clock_limit_s is not None
                    and time.perf_counter() - t0 > wall_clock_limit_s):
                self.wall_clock_exceeded = True
                break
            if max_ticks is not None and ticks >= max_ticks:
                raise RuntimeError(f"engine not drained after {ticks} ticks")
            self.tick()
            ticks += 1
        return list(requests)

    # -- deadlines / preemption -------------------------------------------

    def _expire_deadlines(self, now: float) -> None:
        """Sweep queued and active requests past their deadline to
        ``finish_reason="timeout"``."""
        for req in self.scheduler.expire(now):
            req.status = RequestStatus.FINISHED
            req.finish_reason = "timeout"
            req.t_finish = now
            self.stats["timeout"] += 1
            self.stats["finished"] += 1
            if self._tracer is not None:
                self._tracer.req_terminal(req.rid, "timeout", queued=True)
        for slot, req in self.scheduler.active():
            if now >= req.deadline_abs():
                self.stats["timeout"] += 1
                self._finish(slot, req, "timeout", now)

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
        if self._tracer is not None:
            self._tracer.req_instant(req.rid, "preempt", slot=slot,
                                     n_preemptions=req.n_preemptions)
            self._tracer.req_phase(req.rid, "backoff", ticks=backoff)

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

    def _heal_or_kill(self, slot: int, req: Request, now: float) -> None:
        """Corrupt decode output for this slot: requeue-with-recompute if
        the budget allows, terminal eviction otherwise."""
        if self._can_requeue(req):
            self._preempt(slot, req)
        else:
            self.stats["preempted"] += 1
            self._finish(slot, req, self._evict_reason(req), now)

    def _deadline_preempt(self, now: float) -> bool:
        """A queued request about to miss its deadline may evict-with-
        requeue the active request with the most slack: at most one a
        tick, and only a requeueable victim strictly less urgent."""
        starving = self.scheduler.most_urgent()
        if starving is None or starving.deadline_s is None:
            return False
        slack = starving.slack(now)
        if slack > self.deadline_margin_s:
            return False
        cands = [(s, r) for s, r in self.scheduler.active()
                 if self._can_requeue(r) and r.slack(now) > slack]
        if not cands:
            return False
        slot, req = max(
            cands,
            key=lambda sr: (sr[1].slack(now), -sr[1].priority,
                            self.allocator.blocks_held(sr[0])
                            if self.paged else 0))
        self.stats["deadline_preempts"] += 1
        if self._tracer is not None:
            self._tracer.instant("engine", "deadline_preempt",
                                 victim=req.rid, starving=starving.rid)
        self._preempt(slot, req)
        return True

    # -- degradation ladder ------------------------------------------------

    @property
    def degrade_level(self) -> str:
        """Current ladder rung name (``full`` when healthy)."""
        return self._levels[self._level]

    def _observe_pressure(self, dt: float, tick_no: int) -> None:
        """Feed the tick-latency watchdog and the pool/queue pressure
        signals; step the ladder down after ``degrade_down_after``
        consecutive hot ticks, back up after ``degrade_up_after``
        consecutive calm ones."""
        straggler = self._watchdog.observe(tick_no, dt)
        if straggler and self._tracer is not None:
            self._tracer.instant("engine", "straggler", tick=tick_no,
                                 dt_s=dt)
        pool_dry = (self.paged and bool(self._stalled)
                    and self.allocator.n_free == 0)
        queue_over = len(self.scheduler.queue) > self.queue_bound
        if straggler or pool_dry or queue_over:
            self._hot += 1
            self._calm = 0
            if (self._hot >= self.degrade_down_after
                    and self._level < len(self._levels) - 1):
                self._set_level(self._level + 1)
                self._hot = 0
        else:
            self._calm += 1
            self._hot = 0
            if self._calm >= self.degrade_up_after and self._level > 0:
                self._set_level(self._level - 1)
                self._calm = 0

    def _set_level(self, level: int) -> None:
        """Apply one reversible ladder transition: a level only changes
        the speculation depth (greedy streams are the same at any k,
        including 0) or gates NEW admissions (shedding), so tokens already
        streaming never change."""
        if level > self._level:
            self.stats["degrade_down"] += 1
        else:
            self.stats["degrade_up"] += 1
        if self._tracer is not None:
            self._tracer.instant(
                "engine", "ladder",
                src=self._levels[self._level], dst=self._levels[level],
                direction="down" if level > self._level else "up")
        self._level = level
        self.stats["degrade_level"] = level
        k_eff = {"full": self.spec_k,
                 "spec_half": max(1, self.spec_k // 2),
                 "spec_off": 0,
                 "shed": 0}[self._levels[level]]
        if self.spec_k and k_eff != self.spec_k_eff:
            self.spec_k_eff = k_eff
            if k_eff and self.draft is not None:
                self.draft.set_k(k_eff)
        # the per-tick cost legitimately changed with the level: re-seed
        # the watchdog baseline instead of flagging every healthy tick
        self._watchdog.reset()

    # -- internals --------------------------------------------------------

    def _admit(self, slot: int, req: Request) -> None:
        # the prompt plus (after a preemption) every token generated so far
        ctx = list(req.prompt) + [int(t) for t in req.generated]
        clen = len(ctx)
        toks = np.zeros((1, self.max_prompt_len), np.int32)
        toks[0, :clen] = np.asarray(ctx, np.int32)
        lengths = self._dev(np.asarray([clen], np.int32))
        fe = req.frontend_embeds
        if fe is not None:
            fe = torch.as_tensor(fe).to(self.device)
        if self._tracer is not None:
            self._tracer.req_phase(req.rid, "prefill", slot=slot,
                                   ctx_len=clen)
        t0 = self._timer()
        with self._prof.annotate("prefill"):
            if self.paged:
                self.allocator.alloc_slot(slot, clen)
                last, self._cache = self._prefill(
                    self.params, self._cache, self._slot_template,
                    self._dev(toks), lengths,
                    self._dev(self.allocator.phys_row(slot)), slot, fe)
            else:
                last, slot_cache = self._prefill(
                    self.params, self._slot_template, self._dev(toks),
                    lengths, fe)
                self._cache = self._insert(self._cache, slot_cache, slot)
            tok = int(sampler_mod.sample(last, generator=self._gen,
                                         **self._sample_args)[0])
            if self.draft is not None:
                # the draft mirrors the slot layout: its own prefill fills
                # its cache row, so drafting starts from the same context
                self.draft.prefill(slot, self._dev(toks), lengths, fe)
        self.stats["prefill_s"] += self._timer() - t0
        self.stats["prefill_dispatches"] += 1
        now = self._clock()
        if req.t_first_token is None:       # readmissions keep the mark
            req.t_first_token = now
            if req.t_submit is not None:
                self._h_ttft.observe(now - req.t_submit)
        if self._tracer is not None:
            self._tracer.req_phase(req.rid, "decode", slot=slot)
        req.generated.append(tok)
        self.stats["tokens_out"] += 1
        self._tokens[slot] = tok
        self._positions[slot] = clen
        self._maybe_finish(slot, req, tok, now)

    def _ensure_blocks(self, need: int = 1) -> None:
        """Map each active slot's write window (``need`` positions from
        its frontier); stall the slots the pool cannot serve.  If every
        active slot stalls, preempt and requeue the lowest-priority
        stalled request holding the most pages, choosing among the
        requeueable ones first (eviction only when none may requeue), and
        retry the rest."""
        self._stalled = set()
        active = self.scheduler.active()
        for slot, _ in active:
            forced = (self._fault is not None
                      and self._fault.spurious_stall(slot))
            if forced and self._tracer is not None:
                self._tracer.instant("engine", "fault:spurious_stall",
                                     slot=slot)
            if forced or not self.allocator.ensure_range(
                    slot, int(self._positions[slot]), need):
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
                             self._clock())
                self._stalled.discard(slot)
            for slot2 in sorted(self._stalled):
                if self.allocator.ensure_range(
                        slot2, int(self._positions[slot2]), need):
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
        n = len(req.generated)
        if req.t_first_token is not None and n > 1:
            self._h_tpot.observe(
                max(now - req.t_first_token, 0.0) / (n - 1))
        if self._tracer is not None:
            self._tracer.req_terminal(req.rid, reason, tokens=n)
