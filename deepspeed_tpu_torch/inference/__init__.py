"""Serving for the PyTorch port: ``v2`` (the ragged engine and KV
shipping) and ``quantization`` (weight-only int8/int4 quantized
parameters)."""
