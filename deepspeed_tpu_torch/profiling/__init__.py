"""Profiling for the PyTorch port (counterpart of
``deepspeed_tpu/profiling``): ``roofline`` (the card's peak numbers) and
``serving_roofline`` (the decode window's analytic HBM roofline, which the
serving engine records and the lifecycle scheduler reads for its drain
predictions). The rest of the JAX package's profiling (the flops profiler,
the module tree, straggler detection, trace parsing) is ROADMAP M11."""
