from .blocked_allocator import BlockedAllocator
from .kv_cache import BlockedKVCache, KVCacheConfig
from .ragged_wrapper import RaggedBatch, RaggedBatchWrapper
from .sequence_descriptor import DSSequenceDescriptor, DSStateManager

__all__ = ["BlockedAllocator", "BlockedKVCache", "KVCacheConfig",
           "RaggedBatch", "RaggedBatchWrapper", "DSSequenceDescriptor",
           "DSStateManager"]
