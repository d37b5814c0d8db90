"""ZeRO for the PyTorch port (counterpart of ``deepspeed_tpu/runtime/zero``):
the ``zero_optimization`` block (``config.py``) and Twin-Flow's split of
the optimizer state (``twin_flow.py``). Stages 1-3 run on one device,
where the JAX package's sharding plan leaves every array replicated; the
sharding of a world of ranks is ROADMAP M6."""
