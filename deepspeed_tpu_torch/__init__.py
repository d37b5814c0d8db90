"""DeepSpeed-TPU's PyTorch/CUDA port.

A second package beside ``deepspeed_tpu`` (the JAX reference, which it
never imports). It serves the Llama-family ``CausalLM`` (and the
universal families' ``models.families.UniversalCausalLM``) through
``InferenceEngineV2.generate``, greedily or speculatively
(``inference.v2.speculative``), and trains it through :func:`initialize` →
``DeepSpeedEngine.train_batch`` on an NVIDIA H100, on one process (ZeRO
stages 0-3, the optimizer state optionally in host memory) or on a
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


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Optional[Dict] = None,
               training_data: Any = None, lr_scheduler: Any = None,
               collate_fn: Any = None,
               config: Union[str, Dict, DeepSpeedConfig, None] = None,
               config_params: Union[str, Dict, None] = None,
               topology=None, device=None):
    """Create a training engine (the JAX ``deepspeed_tpu.initialize``,
    same argument order).

    ``model`` is a ``CausalLM`` (or anything with
    ``loss_fn(params, batch, rng)``, or such a callable);
    ``model_parameters`` a dict of dotted name → tensor, by default the
    model's own parameters. The config is ``config``, else
    ``config_params``, else ``args.deepspeed_config`` (a dict, a JSON
    path or a ``DeepSpeedConfig``); ``args.deepspeed_config`` together
    with another config raises, as in the reference. ``device=None`` means
    CUDA, which must be present. ``topology``
    (``runtime.topology.MeshTopology``) defaults to the process's, built
    over the world ``comm.init_distributed`` joined (one process without
    it); the batch sizes are solved against its data extent.

    ``optimizer``, when given, is a client optimizer: a factory
    ``f(masters) -> torch.optim.Optimizer`` that the engine calls over its
    float32 masters (a list in parameter order) and steps in its own
    order (unscale, clip, zero non-finite values, ``step()``; the config's
    scheduler, if any, sets each param group's lr first). It replaces the
    config's ``optimizer`` block, as the JAX package's optax client does.

    Not offered: ``training_data`` / ``collate_fn`` (ROADMAP M10), and a
    MoE model (``num_experts > 1``: MoE training, ROADMAP M9). →
    ``(engine, optimizer, None, lr_scheduler)``."""
    if getattr(getattr(model, "config", None), "num_experts", 1) > 1:
        raise NotImplementedError(
            "MoE training is not ported yet (ROADMAP M9); a MoE model "
            "serves through InferenceEngineV2")
    if training_data is not None or collate_fn is not None:
        raise NotImplementedError(
            "training_data / collate_fn (the engine's data loader) are not "
            "ported yet (ROADMAP M10)")
    config = config if config is not None else config_params
    if args is not None and getattr(args, "deepspeed_config", None):
        if config is not None:
            raise ValueError(
                "Not sure how to proceed: both args.deepspeed_config and the "
                "config argument were given (reference semantics: pass one)")
        config = args.deepspeed_config
    if topology is None:
        topology = get_topology()
    raw = config.raw if isinstance(config, DeepSpeedConfig) else config
    if not isinstance(config, DeepSpeedConfig) \
            or config._topology is not topology:
        config = DeepSpeedConfig(raw, topology=topology)
    engine = DeepSpeedEngine(model, config, model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, device=device,
                             topology=topology, optimizer=optimizer)
    return engine, engine.optimizer, None, engine.lr_scheduler


__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig",
           "TransformerConfig", "CausalLM", "DeepSpeedConfig",
           "DeepSpeedEngine", "initialize"]
