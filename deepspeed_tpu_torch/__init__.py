"""DeepSpeed-TPU's PyTorch/CUDA port.

A second package beside ``deepspeed_tpu`` (the JAX reference, which it
never imports). This slice serves the Llama-family ``CausalLM`` through
``InferenceEngineV2.generate`` on an NVIDIA H100, with hand-written CUDA
paged-attention kernels under ``csrc/``. Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
from .inference.v2.engine_v2 import (
    InferenceEngineV2,
    RaggedInferenceEngineConfig,
)
from .models.transformer import CausalLM, TransformerConfig

__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig",
           "TransformerConfig", "CausalLM"]
