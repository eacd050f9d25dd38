"""Unified observability: metrics registry, span tracing, profiler hooks
(port of :mod:`repro.obs`, on ``torch.profiler``).

Three pieces, one bundle (:class:`Observability`), threaded through the
serving engine, the kernels' dispatch counters, and both launchers:

* :mod:`repro_torch.obs.metrics` — typed, labeled Counter / Gauge / Histogram
  registry with ``snapshot()`` / merge / JSON-lines export / Prometheus
  text exposition.  ``Engine.stats`` is a
  :class:`~repro_torch.obs.metrics.StatsView` over a per-engine registry, and
  the kernel dispatch-counter globals are dict-shims over the
  process-global ``REGISTRY`` — one implementation behind every
  existing name.
* :mod:`repro_torch.obs.trace` — per-request lifecycle span tracing over an
  injectable monotonic clock (virtual-clock compatible), exported as
  Chrome/Perfetto trace-event JSON.
* :mod:`repro_torch.obs.prof` — ``torch.profiler.record_function``
  ranges around the engine's prefill/decode dispatches and an on-demand
  capture window (``--profile-ticks A:B``) that writes a Chrome trace, a
  ``key_averages()`` table and a digest (device busy share, kernels per
  tick, top kernels by device time).

The noop fast path (default)
----------------------------
Observability is OFF by default and must cost nothing measurable:

* the engine always owns a registry (it IS ``Engine.stats`` — counters
  were always on), so "off" only disables the optional surfaces;
* every trace-emission site in the engine is guarded by one
  ``self._tracer is not None`` check (bound once in ``__init__``);
* ``Prof.annotate`` returns one shared ``contextlib.nullcontext`` —
  no allocation, no torch call;
* the per-tick exporter/profile-window hook is ``None`` when neither is
  configured, so the tick loop pays a single attribute test.

``tests/test_torch_obs.py`` pins this down twice: a structural check
(engine with ``Observability.off()`` binds no tracer/exporter/hook) and a
token-identity check (greedy streams with obs on == obs off).

Metric name glossary
--------------------
Engine registry (one per :class:`~repro_torch.serving.engine.Engine`; the
``Engine.stats`` key for each lives in
``repro_torch.serving.engine.STATS_METRICS``):

==================================  =========  ================================
name                                kind       meaning
==================================  =========  ================================
serve_prefill_dispatches_total      counter    admission prefill programs run
serve_decode_ticks_total            counter    fused decode/verify ticks
serve_tokens_out_total              counter    tokens committed to requests
serve_finished_total                counter    requests reaching terminal state
serve_preempted_total               counter    preemptions (all causes)
serve_requeued_total                counter    preempt-with-requeue recoveries
serve_timeout_total                 counter    deadline expiries (queued+active)
serve_rejected_total                counter    shed by the bounded queue
serve_deadline_preempts_total       counter    preemptions forced by deadlines
serve_corrupt_ticks_total           counter    FaultPlan corrupt-logit ticks
serve_stalled_slot_ticks_total      counter    slot-ticks parked on a dry pool
serve_degrade_down_total            counter    ladder steps down
serve_degrade_up_total              counter    ladder steps up
serve_degrade_level                 gauge      current ladder rung index
serve_prefill_seconds_total         counter    wall seconds in prefill dispatch
serve_decode_seconds_total          counter    wall seconds in decode dispatch
serve_spec_drafted_total            counter    draft tokens proposed (0 until
                                               speculative decoding is ported)
serve_spec_accepted_total           counter    draft tokens accepted
serve_acceptance_rate               derived    accepted/drafted AT SNAPSHOT
                                               time (never stale)
serve_attn_gather_bytes_total       counter    analytic gather-path attn bytes
serve_attn_kernel_bytes_total       counter    analytic fused-path attn bytes
serve_ttft_seconds                  histogram  submit -> first token
serve_tpot_seconds                  histogram  per-token decode latency
                                               (finish-ttft)/(n_tokens-1)
serve_tick_seconds                  histogram  engine tick wall latency
==================================  =========  ================================

Process-global ``REGISTRY`` (kernels, training):

====================================  =========  ==============================
kernel_cascade_bwd_dispatches_total   counter    label route=reverse_sweep|
                                                 per_layer_scan (one a call)
kernel_paged_attn_dispatches_total    counter    label route=kernel|plain
straggler_flags_total                 counter    StragglerMonitor flags
train_step_loss                       gauge      last step loss
train_tokens_per_s                    gauge      last step token throughput
train_grad_compressed_bytes           gauge      int8 wire bytes per step
train_grad_raw_bytes                  gauge      fp32 equivalent per step
train_cascade_diag_norm               gauge      labels param=a|d, cascade=
                                                 <path>; per-cascade ||.||_2
train_step_seconds                    histogram  step wall time
====================================  =========  ==============================

Span / event name glossary (:mod:`repro_torch.obs.trace`)
---------------------------------------------------------
Request tracks (``req <rid>``) — phase spans: ``queued``, ``prefill``,
``decode``, ``backoff`` (post-preemption wait); instants: ``preempt``
(args: cause), exactly one ``terminal:<finish_reason>`` per request
(``finish_reason`` one of
:data:`repro_torch.serving.request.FinishReason.ALL`).
Engine track (``engine``) — instants: ``ladder`` (args: from/to rung,
direction), ``deadline_preempt``, ``straggler``, ``fault:corrupt_logits``,
``fault:spurious_stall``, ``fault:slow_tick``.  Global-hook tracks:
``allocator`` (``audit``), ``train`` (``straggler``).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    CounterDict,
    Gauge,
    Histogram,
    JsonlExporter,
    Registry,
    StatsView,
    merge_snapshots,
)
from repro_torch.obs.prof import Prof, ProfileWindow  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    SpanTracer,
    instant_global,
    set_global_tracer,
)

__all__ = [
    "Observability", "Registry", "REGISTRY", "Counter", "Gauge",
    "Histogram", "CounterDict", "StatsView", "JsonlExporter",
    "merge_snapshots", "SpanTracer", "set_global_tracer",
    "instant_global", "Prof", "ProfileWindow",
]


class Observability:
    """The bundle an :class:`~repro_torch.serving.engine.Engine` consumes.

    ``registry`` is ALWAYS live — it backs ``Engine.stats``.  ``tracer`` / ``exporter`` / ``window`` /
    ``prof`` are optional; each None is the documented noop path (see
    the package docstring).
    """

    def __init__(self, registry: Optional[Registry] = None,
                 tracer: Optional[SpanTracer] = None,
                 exporter: Optional[JsonlExporter] = None,
                 prof: Optional[Prof] = None,
                 window: Optional[ProfileWindow] = None):
        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer
        self.exporter = exporter
        self.prof = prof if prof is not None else Prof(enabled=False)
        self.window = window

    @classmethod
    def off(cls) -> "Observability":
        """Default bundle: live registry, everything else noop."""
        return cls()

    @property
    def enabled(self) -> bool:
        """True when any optional surface is active."""
        return (self.tracer is not None or self.exporter is not None
                or self.window is not None or self.prof.enabled)

    def tick_hook(self):
        """Per-tick callback for the engine loop, or None when neither
        the exporter nor a profile window is configured — the engine
        stores the None and the tick loop pays one attribute test."""
        if self.exporter is None and self.window is None:
            return None

        def hook(tick_no: int) -> None:
            if self.window is not None:
                self.window.on_tick(tick_no)
            if self.exporter is not None:
                self.exporter.maybe_export(tick_no)

        return hook

    def close(self, tick: Optional[int] = None) -> None:
        """Flush everything: stop an in-flight profile window, close
        open trace spans, write a final metrics snapshot."""
        if self.window is not None:
            self.window.stop()
        if self.tracer is not None:
            self.tracer.close_all()
        if self.exporter is not None:
            self.exporter.close(tick)
