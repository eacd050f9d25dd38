"""Continuous-batching serving (port of :mod:`repro.serving`): the
engine, its FIFO slot scheduler, the paged block allocator, requests and
the sampler."""

from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, RequestStatus

__all__ = ["Engine", "Request", "RequestStatus"]
