from exploring_flash_attention_tpu_torch.serving.decode import (
    decode_split,
    paged_decode_attention,
    paged_decode_partials,
    paged_decode_partials_plain,
    paged_decode_plain,
    paged_extend_attention,
    paged_extend_plain,
    reserve_tickets,
    ticket_buffer,
)
from exploring_flash_attention_tpu_torch.serving.kv_cache import (
    PageAllocator,
    PagedKVCache,
    append_chunks,
    append_prompt,
    append_prompts,
    append_tokens,
    gather_kv,
    make_cache,
    set_seq_lens,
)
from exploring_flash_attention_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "PageAllocator",
    "PagedKVCache",
    "Request",
    "append_chunks",
    "append_prompt",
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
    "reserve_tickets",
    "set_seq_lens",
    "ticket_buffer",
]
