from .blocked_allocator import BlockedAllocator
from .kv_cache import BlockedKVCache, KVCacheConfig
from .page_heat import PageHeatTracker
from .prefix_cache import RadixPrefixCache
from .ragged_wrapper import RaggedBatch, RaggedBatchWrapper
from .sequence_descriptor import DSSequenceDescriptor, DSStateManager

__all__ = ["BlockedAllocator", "BlockedKVCache", "KVCacheConfig",
           "PageHeatTracker", "RadixPrefixCache", "RaggedBatch",
           "RaggedBatchWrapper", "DSSequenceDescriptor", "DSStateManager"]
