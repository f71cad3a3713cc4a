"""Serving: continuous-batching inference (``ModelServer``), generation over
a paged KV cache (``GenerationServer``), and the front door
(``ModelRegistry`` behind ``HttpFrontend``: JSON predict, SSE token
streaming, ``/v1/models``, ``/healthz``, ``/readyz``)."""
from .batcher import (AdmissionQueue, Batcher, DeadlineExceeded, GenRequest,
                      Request, RequestCancelled, ServerClosed,
                      ServerOverloaded, ServingError)
from .buckets import Bucketer, NoBucketError
from .frontend import HttpFrontend
from .kv_cache import SCRATCH_BLOCK, BlockKVCache, BlockTable
from .registry import ModelEntry, ModelRegistry, UnknownModel
from .server import GenerationServer, ModelServer

__all__ = ["ModelServer", "GenerationServer", "Bucketer", "Request",
           "GenRequest", "AdmissionQueue", "Batcher", "BlockKVCache",
           "BlockTable", "SCRATCH_BLOCK", "ServingError", "ServerClosed",
           "ServerOverloaded", "DeadlineExceeded", "RequestCancelled",
           "NoBucketError", "HttpFrontend", "ModelRegistry", "ModelEntry",
           "UnknownModel"]
