"""Continuous-batching serving for the port (counterpart of
paddle_tpu/serving): the engine, its request scheduler and the paged
KV block allocator."""

from .block_allocator import PageBlockAllocator
from .engine import ServingEngine
from .scheduler import Request, Scheduler

__all__ = ["ServingEngine", "Request", "Scheduler", "PageBlockAllocator"]
