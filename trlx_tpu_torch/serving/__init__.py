"""Continuous-batching serving engine over paged KV block pools."""

from trlx_tpu_torch.serving.allocator import PagedBlockAllocator, SeqBlocks
from trlx_tpu_torch.serving.client import GenerationClient
from trlx_tpu_torch.serving.engine import ServingEngine
from trlx_tpu_torch.serving.scheduler import InflightScheduler, Request

__all__ = [
    "GenerationClient",
    "InflightScheduler",
    "PagedBlockAllocator",
    "Request",
    "SeqBlocks",
    "ServingEngine",
]
