from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    attention_plain,
    flash_attention,
    merge_partials,
    prefill_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    attention_bwd_dkv,
    attention_bwd_dq,
    attention_bwd_plain,
    flash_attention_bwd,
)
from exploring_flash_attention_tpu_torch.ops.attention_int8 import (
    attention_int8_plain,
    flash_attention_int8,
)
from exploring_flash_attention_tpu_torch.ops.attention_kvquant import (
    attention_kvquant_plain,
    flash_attention_kvquant,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
    flash_attention_v1,
    flash_attention_v1_causal_partial,
    flash_attention_v1_window_partial,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1_dtiled import (
    attention_dtiled_plain,
    flash_attention_v1_dtiled,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial,
    flash_attention_v2,
    splitkv_combine,
    splitkv_combine_plain,
)
from exploring_flash_attention_tpu_torch.ops.quant import (
    QuantizedTensor,
    dequantize,
    quantize_fp8,
    quantize_int8,
    quantized_from_numpy,
)

__all__ = [
    "attention_bwd_dkv",
    "attention_bwd_dq",
    "attention_bwd_plain",
    "attention_dtiled_plain",
    "attention_int8_plain",
    "attention_kvquant_plain",
    "attention_partial_local",
    "attention_plain",
    "dequantize",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_int8",
    "flash_attention_kvquant",
    "flash_attention_splitkv_partial",
    "flash_attention_v1",
    "flash_attention_v1_causal_partial",
    "flash_attention_v1_dtiled",
    "flash_attention_v1_window_partial",
    "flash_attention_v2",
    "merge_partials",
    "prefill_attention",
    "quantize_fp8",
    "quantize_int8",
    "quantized_from_numpy",
    "QuantizedTensor",
    "splitkv_combine",
    "splitkv_combine_plain",
]
