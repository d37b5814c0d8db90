"""Serving engines built from saved weights (counterpart of
``deepspeed_tpu/inference/v2/engine_factory.py``).

:func:`build_engine_from_ds_checkpoint` is the train-to-serve hand-off on
one device: the parameters of a checkpoint tag the port's
``save_checkpoint`` wrote (a universal directory, ``checkpoint/
ds_to_universal.py``), cast to the serving dtype, optimizer state never
read. Resharding onto a mesh is ROADMAP M6; loading HuggingFace weights
is M10.
"""
from __future__ import annotations

import os
from typing import Optional

from ...checkpoint.ds_to_universal import INDEX_FILE, load_universal
from ...checkpoint.universal.layout import param_name
from ...models.transformer import leaf_dtype
from ...utils.logging import logger
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig


def build_engine_from_ds_checkpoint(ckpt_dir: str, model,
                                    engine_config: Optional[
                                        RaggedInferenceEngineConfig] = None,
                                    tag: Optional[str] = None, dtype=None,
                                    device=None) -> InferenceEngineV2:
    """Serve the parameters of a training checkpoint.

    ``model`` is a ``CausalLM`` or ``UniversalCausalLM`` whose class and
    config the checkpoint fits; a new model of that class is built from
    the checkpoint's parameters (``model``'s own tensors are not touched).
    ``tag=None`` takes the committed ``latest``, falling back to the
    newest valid committed tag as a training resume does; a
    ``ckpt_dir`` holding ``index.json`` (a universal directory the JAX
    package's ``convert`` wrote) is read itself. A tag is verified
    against its integrity manifest first. Only the ``param`` leaves are
    read, cast to the serving dtype: ``dtype``, which a new engine
    config takes, or the given ``engine_config``'s (a MoE router stays
    float32)."""
    from ...runtime.checkpoint_engine.numpy_checkpoint_engine import \
        NumpyCheckpointEngine
    from ...runtime.fault.manifest import verify_checkpoint

    if tag is None and os.path.exists(os.path.join(ckpt_dir, INDEX_FILE)):
        src = ckpt_dir
    else:
        if tag is None:
            tag = NumpyCheckpointEngine(ckpt_dir).latest_tag()
            if tag is None:
                raise FileNotFoundError(
                    f"{ckpt_dir}: no valid committed checkpoint tag")
        src = os.path.join(ckpt_dir, str(tag))
        verify_checkpoint(src)      # raises CheckpointCorruptError
    config = engine_config or RaggedInferenceEngineConfig(
        max_ctx=model.config.max_seq_len,
        **({} if dtype is None else {"dtype": dtype}))
    dtype = config.dtype
    state = {}
    for name, t in load_universal(src).items():
        name = param_name(name)
        state[name] = t.to(leaf_dtype(name, dtype))
    served = type(model)(model.config, state)
    logger.info(f"serving {src}: {served.num_params() / 1e6:.0f} M params "
                f"in {dtype}")
    return InferenceEngineV2(served, config, device=device)
