"""Serving: the continuous-batching engine (fixed shapes, slot-granular).

Engine v2: a paged KV layout (``cache_layout="paged"``: a page pool and
per-slot block tables, see ``paged`` and ``slots``), a prefill bucket
ladder, the decode step captured once as a CUDA graph on the GPU, and a
threaded producer/consumer driver loop (``ServingEngine.run_threaded``).
"""

from repro_torch.serving.engine import (JetThread, ServingEngine,
                                        scatter_slot_cache)
from repro_torch.serving.paged import (check_paged_geometry, gather_caches,
                                       init_paged_caches, scatter_decode,
                                       scatter_prefill)
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.serving.slots import (RESERVED_BLOCKS, SENTINEL_BLOCK,
                                       TRASH_BLOCK, BlockAllocator,
                                       SlotAllocator)
from repro_torch.serving.trace import latency_summary, synthetic_trace

__all__ = ["ServingEngine", "JetThread", "scatter_slot_cache", "Request",
           "RequestQueue", "SlotAllocator", "BlockAllocator",
           "SENTINEL_BLOCK", "TRASH_BLOCK", "RESERVED_BLOCKS",
           "check_paged_geometry", "init_paged_caches", "gather_caches",
           "scatter_prefill", "scatter_decode", "latency_summary",
           "synthetic_trace"]
