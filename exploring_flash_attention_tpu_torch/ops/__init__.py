from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    causal_attention_plain,
    flash_attention,
    prefill_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    attention_bwd_dkv,
    attention_bwd_dq,
    attention_bwd_plain,
    flash_attention_bwd,
)

__all__ = [
    "attention_bwd_dkv",
    "attention_bwd_dq",
    "attention_bwd_plain",
    "attention_partial_local",
    "causal_attention_plain",
    "flash_attention",
    "flash_attention_bwd",
    "prefill_attention",
]
