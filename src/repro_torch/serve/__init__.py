"""Serving engine: continuous batching + paged KV cache (port of repro/serve).

Public surface:
  ServeConfig / Request / Completion  (serve.api)   — typed request/response
  Engine: submit() / poll() / run_until_drained()   (serve.engine)
  BlockAllocator / OutOfBlocks                      (serve.kv_cache)

The legacy ``repro_torch.launch.serve.Server`` wraps Engine as a deprecated shim.
"""
from repro_torch.serve.api import Completion, Request, ServeConfig, make_request
from repro_torch.serve.engine import Engine, generate_batch
from repro_torch.serve.kv_cache import BlockAllocator, OutOfBlocks

__all__ = [
    "BlockAllocator", "Completion", "Engine", "OutOfBlocks", "Request",
    "ServeConfig", "generate_batch", "make_request",
]
