"""Continuous-batching LM serving on a placement-aware paged KV cache
(twin of ``repro/serving``).

Modules:
  * ``kv_cache``     — free-list page allocator, per-request page tables,
                       the pooled K/V tensors, access-count traffic, and
                       physical page reordering under a placement.
  * ``scheduler``    — FIFO admit / completion-evict scheduler with
                       page-exhaustion backpressure (pure bookkeeping).
  * ``paged_decode`` — one batched decode step that reads/writes K/V
                       through page tables with per-request positions;
                       logits match ``models.transformer.decode_step``.
  * ``engine``       — the stream loop tying the three together, with
                       request-level metrics (TTFT, p50/p99 latency,
                       tokens/s) and the drift re-placement policy.
"""
from repro_torch.serving.engine import EngineConfig, ServeReport, ServingEngine
from repro_torch.serving.kv_cache import (PageAllocator, PagedKVCache,
                                          PagePoolExhausted)
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["EngineConfig", "PageAllocator", "PagedKVCache",
           "PagePoolExhausted", "Request", "Scheduler", "ServeReport",
           "ServingEngine"]
