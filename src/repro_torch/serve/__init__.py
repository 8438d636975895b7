"""Continuous-batching serving of the Boolean LMs on one device, with
overload control, a host swap tier, fault injection and chaos soaks."""
from . import reasons
from .chaos import DEFAULT_RATES, FaultSchedule, SoakReport, soak_session
from .engine import ServeEngine, pack_weights, resolve_device
from .faults import FaultInjector, InjectedFault, corrupt_prefix_index
from .paged_cache import (CachePool, PageAllocator, commit_prefill,
                          fork_page, paged_pool_init, pages_for)
from .prefix_cache import Hit, IndexCorruption, PrefixCache
from .sampling import PRNGKey, logits_all_finite, sample_tokens
from .scheduler import (TERMINAL, Request, RequestStatus, SamplingParams,
                        Scheduler, ShedError)
from .session import RequestHandle, ServeSession
from .swap import (HostBudgetExceeded, SwapBridge, SwapManager, SwapRecord,
                   decode_slot, encode_slot)
