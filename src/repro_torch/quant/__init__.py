"""Quantized optimizer state of the port (counterpart of repro/quant/):
the flat int8 codec of the standalone 8-bit Adam, the axis-blocked int8
moment and packed int4 projector codecs (``codec.py``) and the per-leaf
storage policy (``policy.py``)."""
from repro_torch.quant.codec import (
    BLOCK,
    QBLOCK,
    SR_SALT_M,
    SR_SALT_V,
    dequant4_axis_state,
    dequant_axis_state,
    dequant_state,
    dequantize,
    dequantize4_axis,
    dequantize_axis,
    dynamic_codebook,
    int4_codebook,
    is_axis4_qstate,
    is_qstate,
    quant4_axis_state,
    quant_axis_state,
    quant_state,
    quantize,
    quantize4_axis,
    quantize_axis,
    sr_uniform,
)
from repro_torch.quant.policy import MIN_QUANT_SIZE, QuantPolicy

__all__ = [
    "BLOCK",
    "QBLOCK",
    "SR_SALT_M",
    "SR_SALT_V",
    "MIN_QUANT_SIZE",
    "QuantPolicy",
    "dequant4_axis_state",
    "dequant_axis_state",
    "dequant_state",
    "dequantize",
    "dequantize4_axis",
    "dequantize_axis",
    "dynamic_codebook",
    "int4_codebook",
    "is_axis4_qstate",
    "is_qstate",
    "quant4_axis_state",
    "quant_axis_state",
    "quant_state",
    "quantize",
    "quantize4_axis",
    "quantize_axis",
    "sr_uniform",
]
