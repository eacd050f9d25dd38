"""Continuous-batching serving (port of :mod:`repro.serving`): the
engine, its deadline-aware slot scheduler, the paged block allocator,
requests, the sampler and the fault plan.  ``Engine.stats`` keys and
their registry metrics are listed in
``repro_torch.serving.engine.STATS_METRICS``; the latency histograms
(``serve_ttft_seconds``, ``serve_tpot_seconds``, ``serve_tick_seconds``)
are read off the engine's registry (``eng.obs.registry.get(name)``)."""

from repro_torch.serving.blocks import BlockAllocator  # noqa: F401
from repro_torch.serving.engine import Engine  # noqa: F401
from repro_torch.serving.faults import FaultPlan  # noqa: F401
from repro_torch.serving.request import (  # noqa: F401
    FinishReason,
    Request,
    RequestStatus,
    make_ragged_requests,
)
from repro_torch.serving.sampler import (  # noqa: F401
    apply_top_k,
    apply_top_p,
    sample,
)
from repro_torch.serving.scheduler import Scheduler  # noqa: F401

__all__ = ["Engine", "Request", "RequestStatus", "FinishReason",
           "FaultPlan", "Scheduler", "BlockAllocator",
           "make_ragged_requests",
           "apply_top_k", "apply_top_p", "sample"]
