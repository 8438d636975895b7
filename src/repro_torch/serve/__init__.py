"""Continuous-batching serving of the dense Boolean LM on one device."""
from . import reasons
from .engine import ServeEngine, pack_weights, resolve_device
from .paged_cache import (CachePool, PageAllocator, commit_prefill,
                          fork_page, paged_pool_init, pages_for)
from .prefix_cache import Hit, IndexCorruption, PrefixCache
from .sampling import PRNGKey, logits_all_finite, sample_tokens
from .scheduler import (TERMINAL, Request, RequestStatus, SamplingParams,
                        Scheduler, ShedError)
from .session import RequestHandle, ServeSession
