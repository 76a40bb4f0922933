"""The flat INT8 codec of the standalone 8-bit Adam, re-exported (port of
repro/optim/quant8.py, a shim over the codec module): the dynamic-exponent
codebook over 256-element blocks of a flattened leaf. New code imports
``repro_torch.quant`` directly."""
from repro_torch.quant.codec import (  # noqa: F401
    BLOCK,
    dequant_state,
    dequantize,
    dynamic_codebook,
    quant_state,
    quantize,
)

__all__ = ["BLOCK", "dynamic_codebook", "quantize", "dequantize", "quant_state", "dequant_state"]
