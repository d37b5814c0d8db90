"""Group-wise int8/int4 quantization (K8a, K8b, K9a, K9b, K10a and its
residual variant, K10b) for the port (counterpart of ``deepspeed_tpu/ops/quantizer``)."""
from .quantizer import (
    Quantizer,
    dequantize_int4,
    dequantize_int8,
    dequantize_int8_reference,
    get_quant_fns,
    quant_pack_wire,
    quant_pack_wire_reference,
    quantize_int4,
    quantize_int8,
    quantize_int8_reference,
    unpack_dequant_mean,
    unpack_dequant_mean_reference,
    unpack_dequant_wire,
    unpack_dequant_wire_reference,
    wire_residual,
    wire_residual_reference,
    wire_width,
)

__all__ = ["Quantizer", "dequantize_int4", "dequantize_int8",
           "dequantize_int8_reference", "get_quant_fns", "quant_pack_wire",
           "quant_pack_wire_reference", "quantize_int4", "quantize_int8",
           "quantize_int8_reference", "unpack_dequant_mean",
           "unpack_dequant_mean_reference", "unpack_dequant_wire",
           "unpack_dequant_wire_reference", "wire_residual",
           "wire_residual_reference", "wire_width"]
