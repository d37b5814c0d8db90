"""DeepSpeed-TPU's PyTorch/CUDA port.

A second package beside ``deepspeed_tpu`` (the JAX reference, which it
never imports). It serves the Llama-family ``CausalLM`` through
``InferenceEngineV2.generate`` and trains it through :func:`initialize` →
``DeepSpeedEngine.train_batch`` on an NVIDIA H100, on one process or on a
data-parallel ``torch.distributed`` world (``deepspeed_tpu_torch.comm``),
with hand-written CUDA kernels under ``csrc/``. Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
from typing import Any, Dict, Optional, Union

from .inference.v2.engine_v2 import (
    InferenceEngineV2,
    RaggedInferenceEngineConfig,
)
from .models.transformer import CausalLM, TransformerConfig
from .runtime.config import DeepSpeedConfig
from .runtime.engine import DeepSpeedEngine
from .runtime.topology import get_topology


def initialize(model: Any = None, model_parameters: Optional[Dict] = None,
               config: Union[str, Dict, DeepSpeedConfig, None] = None,
               lr_scheduler: Any = None, device=None, topology=None):
    """Create a training engine (the JAX ``deepspeed_tpu.initialize``).

    ``model`` is a ``CausalLM`` (or anything with
    ``loss_fn(params, batch, rng)``, or such a callable);
    ``model_parameters`` a dict of dotted name → tensor, by default the
    model's own parameters. ``device=None`` means CUDA, which must be
    present. ``topology`` (``runtime.topology.MeshTopology``) defaults to
    the process's, built over the world ``comm.init_distributed`` joined
    (one process without it); the batch sizes are solved against its data
    extent. → ``(engine, optimizer, None, lr_scheduler)``."""
    if topology is None:
        topology = get_topology()
    raw = config.raw if isinstance(config, DeepSpeedConfig) else config
    if not isinstance(config, DeepSpeedConfig) \
            or config._topology is not topology:
        config = DeepSpeedConfig(raw, topology=topology)
    engine = DeepSpeedEngine(model, config, model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, device=device,
                             topology=topology)
    return engine, engine.optimizer, None, engine.lr_scheduler


__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig",
           "TransformerConfig", "CausalLM", "DeepSpeedConfig",
           "DeepSpeedEngine", "initialize"]
