"""Serving: continuous batching over a paged KV cache (the batched paged
path of ``repro.serving``) and, for the ssm family, over per-slot
contiguous caches."""
from repro_torch.serving.cache import OutOfPages, PagePool, pages_needed
from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["OutOfPages", "PagePool", "pages_needed", "Request",
           "ServeEngine"]
