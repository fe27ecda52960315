from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    attention_plain,
    flash_attention,
    prefill_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    attention_bwd_dkv,
    attention_bwd_dq,
    attention_bwd_plain,
    flash_attention_bwd,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
    flash_attention_v1,
    flash_attention_v1_causal_partial,
    flash_attention_v1_window_partial,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    splitkv_combine,
    splitkv_combine_plain,
)

__all__ = [
    "attention_bwd_dkv",
    "attention_bwd_dq",
    "attention_bwd_plain",
    "attention_partial_local",
    "attention_plain",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_v1",
    "flash_attention_v1_causal_partial",
    "flash_attention_v1_window_partial",
    "prefill_attention",
    "splitkv_combine",
    "splitkv_combine_plain",
]
