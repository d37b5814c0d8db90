"""Ragged serving engine of the PyTorch port (counterpart of
``deepspeed_tpu/inference/v2``): ``engine_v2`` (InferenceEngineV2,
ContinuousBatcher, the speculative verify windows), ``model_runner`` (the
ragged forwards of the llama and the universal families, the fused decode
loop, the verify step), ``kernels`` (the CUDA paged-attention kernels and
their plain versions), ``ragged`` (refcounting allocator, batch metadata,
paged KV cache, radix prefix cache, page heat, host-tier KV swap),
``kv_ship`` (a sequence's KV exported, framed as DSKV1 in float32 or on
the int8 wire, and imported into another engine's page geometry),
``speculative`` (the n-gram and draft-model drafters, the loop of
verify windows) and ``engine_factory`` (an engine serving a training
checkpoint's parameters)."""
