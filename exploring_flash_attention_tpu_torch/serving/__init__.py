from exploring_flash_attention_tpu_torch.serving.decode import (
    decode_split,
    paged_decode_attention,
    paged_decode_partials,
    paged_decode_partials_plain,
    paged_decode_plain,
    paged_extend_attention,
    paged_extend_plain,
    ticket_buffer,
)
from exploring_flash_attention_tpu_torch.serving.kv_cache import (
    PageAllocator,
    PagedKVCache,
    append_chunks,
    append_prompts,
    append_tokens,
    gather_kv,
    make_cache,
)

__all__ = [
    "PageAllocator",
    "PagedKVCache",
    "append_chunks",
    "append_prompts",
    "append_tokens",
    "decode_split",
    "gather_kv",
    "make_cache",
    "paged_decode_attention",
    "paged_decode_partials",
    "paged_decode_partials_plain",
    "paged_decode_plain",
    "paged_extend_attention",
    "paged_extend_plain",
    "ticket_buffer",
]
