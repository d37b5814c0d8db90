"""Ragged serving engine of the PyTorch port (counterpart of
``deepspeed_tpu/inference/v2``).

The serving entry points are exported here. The submodules:

  * ``engine_v2``   — InferenceEngineV2 (``put``, fused decode windows,
    speculative verify windows, the decode HBM roofline of every drained
    window) and ContinuousBatcher (a closed set of requests);
  * ``lifecycle``   — LifecycleScheduler, the open-world serving layer:
    bounded admission and overload shedding, deadlines and TTFT timeouts,
    cancellation, KV-pressure preemption (recompute or host-tier swap),
    the decode watchdog (NaN isolation, hang incidents), verify windows,
    ``kv_import`` continuations and ``prefill_only`` exports, drain;
  * ``server``      — ServingServer, its HTTP front end (``POST
    /v1/generate`` blocking or SSE, ``POST /v1/prefill``, ``/healthz``,
    ``/metrics``, graceful drain on SIGTERM;
    ``python -m deepspeed_tpu_torch.inference.v2.server``);
  * ``model_runner`` — the ragged forwards of the llama and the universal
    families, the fused decode loop, the verify step;
  * ``kernels``     — the CUDA paged-attention kernels and their plain
    versions;
  * ``ragged``      — refcounting allocator, batch metadata, paged KV
    cache, radix prefix cache, page heat, host-tier KV swap;
  * ``kv_ship``     — a sequence's KV exported, framed as DSKV1 in float32
    or on the int8 wire, and imported into another engine's page geometry;
  * ``speculative`` — SpeculativeConfig and make_drafter, the n-gram and
    draft-model drafters, the loop of verify windows;
  * ``engine_factory`` — an engine serving a training checkpoint's
    parameters.
"""
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from .lifecycle import (TERMINAL_STATES, AdmissionVerdict, LifecycleScheduler,
                        RequestState, ServeRequest)
from .speculative import SpeculativeConfig, make_drafter

__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig",
           "LifecycleScheduler", "ServeRequest", "RequestState",
           "AdmissionVerdict", "TERMINAL_STATES", "ServingServer",
           "SpeculativeConfig", "make_drafter"]


def __getattr__(name):
    # ``server`` loads on first use, so that ``python -m
    # deepspeed_tpu_torch.inference.v2.server`` runs a module the package
    # has not imported already
    if name == "ServingServer":
        from .server import ServingServer

        return ServingServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
