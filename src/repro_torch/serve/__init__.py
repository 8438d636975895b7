"""Continuous-batching serving of the dense Boolean LM on one device."""
from . import reasons
from .engine import ServeEngine, pack_weights, resolve_device
from .paged_cache import (PageAllocator, commit_prefill, paged_pool_init,
                          pages_for)
from .sampling import sample_tokens
from .scheduler import (TERMINAL, Request, RequestStatus, SamplingParams,
                        Scheduler, ShedError)
from .session import RequestHandle, ServeSession
