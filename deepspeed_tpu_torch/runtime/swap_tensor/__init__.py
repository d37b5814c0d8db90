"""Host-memory tiers of the port (counterpart of
``deepspeed_tpu/runtime/swap_tensor``): ``host_tier.HostPageTier``, the
host store of spilled KV pages, and ``HostOffloadPrefetcher``;
``streamed_update.StreamedUpdate``, the optimizer update over state in
host memory; ``partitioned_param_swapper.AsyncTensorSwapper``, tensors
swapped to files."""
