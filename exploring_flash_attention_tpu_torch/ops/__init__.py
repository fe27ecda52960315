from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    causal_attention_plain,
    flash_attention,
    prefill_attention,
)

__all__ = [
    "attention_partial_local",
    "causal_attention_plain",
    "flash_attention",
    "prefill_attention",
]
