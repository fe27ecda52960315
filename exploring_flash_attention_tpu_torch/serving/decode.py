"""Paged attention of the port over the INT8 KV cache: decode on kernel
H6-decode, chunked-prefill extend on kernel H6-extend.

Counterpart of ``serving/decode.py`` in the JAX package:

- :func:`paged_decode_attention`: one new token per sequence attends over
  that sequence's paged INT8 history;
- :func:`paged_extend_attention`: C new tokens per sequence, already
  appended to the cache, attend causally over the whole history (the
  multi-turn path).  Decode is its C = 1 case.

The INT8 dequant folds into the softmax as in the JAX kernels:
``S = (q K^T) * scale * k_scale[col]`` and ``P * v_scale[col]`` before
``P V``.  The JAX signatures' ``interpret``, ``n_buf`` and ``q_strip`` are
TPU knobs and are not taken.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.serving.kv_cache import PagedKVCache

EXTEND_KV_TILE = 64            # H6-extend's key tile: page_size % 64 == 0


def paged_extend_plain(q: torch.Tensor, cache: PagedKVCache,
                       seq_slots: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of H6-extend in f32 math: o f32 [B, C, Hq, d].

    Gathers every mapped page of each slot.  ``seq_lens`` already counts
    the chunk, so chunk row i sits at position ``seq_lens - C + i`` and sees
    the columns up to it; a row that sees nothing gives zeros."""
    b, c, hq, d = q.shape
    hkv, ps = cache.num_kv_heads, cache.page_size
    group = hq // hkv
    slots = seq_slots.long()
    table = cache.page_table[slots].long()                 # [B, P]
    lens = cache.seq_lens[slots].long()                    # [B]
    n_cols = table.shape[1] * ps

    def per_head(x):             # [B, P, Hkv, ps, ...] -> [B, Hkv, P*ps, ...]
        return x.transpose(1, 2).reshape(b, hkv, n_cols, *x.shape[4:])

    kv = cache.kv_pages[table].float()                     # [B,P,2,H,ps,d]
    sc = cache.kv_scales[table][:, :, :, :, 0, :]          # [B,P,2,H,ps]
    k, v = per_head(kv[:, :, 0]), per_head(kv[:, :, 1])
    k_scale, v_scale = per_head(sc[:, :, 0]), per_head(sc[:, :, 1])

    # rows [B, Hkv, C*G]: row r is chunk position r // G, q head kh*G + r % G
    qg = q.float().reshape(b, c, hkv, group, d).transpose(1, 2).reshape(
        b, hkv, c * group, d)
    s = torch.einsum("bhrd,bhtd->bhrt", qg, k) * scale * k_scale[:, :, None]
    row_pos = (lens[:, None] - c
               + torch.arange(c * group, device=q.device) // group)  # [B, R]
    col = torch.arange(n_cols, device=q.device)
    s = s.masked_fill((col > row_pos[:, :, None])[:, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrt,bhtd->bhrd", p * v_scale[:, :, None], v)
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(b, hkv, c, group, d).transpose(1, 2).reshape(b, c, hq, d)


def paged_decode_plain(q: torch.Tensor, cache: PagedKVCache,
                       seq_slots: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of H6-decode in f32 math: o f32 [B, Hq, d],
    the C = 1 case of :func:`paged_extend_plain`.  Columns at or past the
    slot's ``seq_lens`` are masked; an empty sequence gives zeros."""
    return paged_extend_plain(q[:, None], cache, seq_slots, scale)[:, 0]


def _check_paged_inputs(name: str, q: torch.Tensor, cache: PagedKVCache,
                        seq_slots: torch.Tensor) -> None:
    """What both paged kernels take: bf16 q with d in {64, 128} and at most
    8 q heads per KV head, the cache's dtypes, one CUDA device, contiguous
    tensors.  Raises otherwise."""
    tensors = (q, cache.kv_pages, cache.kv_scales, cache.page_table,
               cache.seq_lens, seq_slots)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(f"{name}: q, the cache and the slots must share one "
                         "CUDA device")
    if (q.dtype != torch.bfloat16 or cache.kv_pages.dtype != torch.int8
            or cache.kv_scales.dtype != torch.float32
            or any(t.dtype != torch.int32 for t in tensors[3:])):
        raise TypeError(f"{name} takes bf16 q, int8 pages, f32 scales and "
                        "int32 page table, lengths and slots")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    d, hq, hkv = q.shape[-1], q.shape[-2], cache.num_kv_heads
    if (d not in (64, 128) or cache.head_dim != d or hq // hkv > 8
            or seq_slots.shape != (q.shape[0],)):
        raise ValueError(f"{name} takes d in (64, 128) and at most 8 q heads "
                         f"per KV head; got q {tuple(q.shape)}, cache "
                         f"d={cache.head_dim}, Hkv={hkv}, slots "
                         f"{tuple(seq_slots.shape)}")


def paged_decode_attention(
    q: torch.Tensor,               # [B, Hq, d] one token per sequence
    cache: PagedKVCache,
    seq_slots: torch.Tensor,       # int32 [B] cache slot per batch row
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Batched single-token decode over the paged INT8 cache: [B, Hq, d] in
    q.dtype.

    CPU tensors take :func:`paged_decode_plain`.  CUDA tensors launch kernel
    H6-decode (``csrc/paged_decode.cu``), which takes bf16 q with d in
    {64, 128} and at most 8 q heads per KV head, or raise.
    ``paged_decode_attention.launches`` counts kernel launches."""
    if window is not None:
        raise NotImplementedError("windowed decode is not ported yet")
    b, hq, d = q.shape
    hkv = cache.num_kv_heads
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_plain(q, cache, seq_slots, scale).to(q.dtype)
    _check_paged_inputs("H6-decode", q, cache, seq_slots)
    o = torch.empty_like(q)
    err = kernels.library().eft_paged_decode(
        q.data_ptr(), cache.kv_pages.data_ptr(), cache.kv_scales.data_ptr(),
        cache.page_table.data_ptr(), cache.seq_lens.data_ptr(),
        seq_slots.data_ptr(), o.data_ptr(), b, hq, hkv, d, cache.page_size,
        cache.max_pages_per_seq, cache.page_table.shape[0], scale,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H6-decode")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0


def paged_extend_attention(
    q: torch.Tensor,               # [B, C, Hq, d] C new tokens per sequence
    cache: PagedKVCache,
    seq_slots: torch.Tensor,       # int32 [B] cache slot per batch row
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: each sequence's C newest tokens, already
    appended to the cache (``append_chunks``), attend causally over the
    sequence's whole paged history.  Returns [B, C, Hq, d] in q.dtype.

    CPU tensors take :func:`paged_extend_plain`.  CUDA tensors launch kernel
    H6-extend (``csrc/paged_extend.cu``), which takes bf16 q with d in
    {64, 128}, at most 8 q heads per KV head and a page size that is a
    multiple of 64, or raise.  ``paged_extend_attention.launches`` counts
    kernel launches."""
    if window is not None:
        raise NotImplementedError("windowed extend is not ported yet")
    b, c, hq, d = q.shape
    hkv = cache.num_kv_heads
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_extend_plain(q, cache, seq_slots, scale).to(q.dtype)
    _check_paged_inputs("H6-extend", q, cache, seq_slots)
    if c == 0 or cache.page_size % EXTEND_KV_TILE:
        raise ValueError(f"H6-extend takes C > 0 and a page size that is a "
                         f"multiple of {EXTEND_KV_TILE}; got C={c}, "
                         f"page_size={cache.page_size}")
    o = torch.empty_like(q)
    err = kernels.library().eft_paged_extend(
        q.data_ptr(), cache.kv_pages.data_ptr(), cache.kv_scales.data_ptr(),
        cache.page_table.data_ptr(), cache.seq_lens.data_ptr(),
        seq_slots.data_ptr(), o.data_ptr(), b, c, hq, hkv, d,
        cache.page_size, cache.max_pages_per_seq, cache.page_table.shape[0],
        scale, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H6-extend")
    paged_extend_attention.launches += 1
    return o


paged_extend_attention.launches = 0
