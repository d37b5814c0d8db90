"""Host-memory tiers of the port (counterpart of
``deepspeed_tpu/runtime/swap_tensor``): ``host_tier.HostPageTier``, the
host store of spilled KV pages. The optimizer's host offload
(``HostOffloadPrefetcher``) and the parameter swapper are ROADMAP M6."""
