"""Checkpoint conversion for the port (counterpart of
``deepspeed_tpu/checkpoint``): the universal layout's naming
(:mod:`.universal.layout`), the universal directory reader and exporter
(:mod:`.ds_to_universal`) and the float32 state-dict export
(:mod:`.zero_to_fp32`)."""
