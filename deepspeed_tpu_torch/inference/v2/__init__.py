"""Ragged serving engine of the PyTorch port (counterpart of
``deepspeed_tpu/inference/v2``): ``engine_v2`` (InferenceEngineV2,
ContinuousBatcher), ``model_runner`` (the ragged forward and the fused
decode loop), ``kernels`` (the CUDA paged-attention kernels and their plain
versions), ``ragged`` (allocator, batch metadata, paged KV cache) and
``kv_ship`` (a sequence's KV exported, framed as DSKV1 in float32 or on
the int8 wire, and imported into another engine's page geometry)."""
