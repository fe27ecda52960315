from exploring_flash_attention_tpu_torch.serving.decode import (
    paged_decode_attention,
    paged_decode_plain,
    paged_extend_attention,
    paged_extend_plain,
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
    "gather_kv",
    "make_cache",
    "paged_decode_attention",
    "paged_decode_plain",
    "paged_extend_attention",
    "paged_extend_plain",
]
