"""Serving: the continuous-batching engine over the contiguous KV layout."""

from repro_torch.serving.engine import ServingEngine, scatter_slot_cache
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.serving.slots import SlotAllocator
from repro_torch.serving.trace import latency_summary, synthetic_trace

__all__ = ["ServingEngine", "scatter_slot_cache", "Request", "RequestQueue",
           "SlotAllocator", "latency_summary", "synthetic_trace"]
