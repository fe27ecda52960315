"""Paged attention of the port over the INT8 KV cache: decode on kernel
H6-decode, chunked-prefill extend on kernel H6-extend.

Counterpart of ``serving/decode.py`` in the JAX package:

- :func:`paged_decode_attention`: one new token per sequence attends over
  that sequence's paged INT8 history;
- :func:`paged_extend_attention`: C new tokens per sequence, already
  appended to the cache, attend causally over the whole history (the
  multi-turn path).  Decode is its C = 1 case.

Both take the JAX functions' sliding ``window``: a token at position
``pos`` sees the columns ``pos - window + 1 .. pos`` (its own included),
and pages wholly before every row's band are never read.

The INT8 dequant folds into the softmax as in the JAX kernels:
``S = (q K^T) * scale * k_scale[col]`` and ``P * v_scale[col]`` before
``P V``.  The JAX signatures' ``interpret``, ``n_buf`` and ``q_strip`` are
TPU knobs and are not taken.

On the card, decode is split-KV (the FlashDecoding form) in one launch:
each block of H6-decode writes one f32 partial (O normalized over a run
of pages, and its natural-log LSE) per (sequence, KV head, split), and
the last block of each (sequence, KV head) to finish, found by an atomic
ticket, merges them into O as H2 (``ops/attention_v2_splitkv.py``)
would.  :func:`decode_split` plans the runs on the host, from the
cache's shape and the SM count only (no read of ``seq_lens``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.configs import cdiv
from exploring_flash_attention_tpu_torch.ops.attention import (
    SERVING_HEAD_DIM_RULE,
    kernel_dtype,
    kernel_head_dim,
)
from exploring_flash_attention_tpu_torch.serving.kv_cache import (
    PagedKVCache,
    check_page_size,
)

DECODE_BLOCKS_PER_SM = 2        # H6-decode blocks an SM holds at once


def decode_chunks(group: int, d: int) -> int:
    """H6-decode's blocks per (sequence, KV head, run): its GQA group cut
    into chunks of at most 8 q heads (4 at d > 128 and 2 at d > 256, whose
    O columns take twice and four times the registers), each chunk a block
    with its own ticket (``csrc/paged_decode.cu``)."""
    return cdiv(group, 2 if d > 256 else 4 if d > 128 else 8)


def _check_window(window: Optional[int]) -> None:
    if window is not None and not 1 <= window < 2 ** 31:
        raise ValueError(f"window must be in [1, 2^31), got {window}")


def _visible_scores(q: torch.Tensor, cache: PagedKVCache,
                    seq_slots: torch.Tensor, scale: float,
                    window: Optional[int]):
    """The plain versions' shared part: S [B, Hkv, C*G, P*ps] f32 with the
    hidden columns at -inf, the V rows scaled per column [B, Hkv, P*ps, d]
    and the rows' positions [B, C*G].

    Row r of a KV head is chunk position r // G and q head kh*G + r % G;
    ``seq_lens`` already counts the chunk, so chunk row i sits at position
    ``seq_lens - C + i`` and sees the columns up to it (and, with a
    window, from ``pos - window + 1`` on)."""
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

    qg = q.float().reshape(b, c, hkv, group, d).transpose(1, 2).reshape(
        b, hkv, c * group, d)
    s = torch.einsum("bhrd,bhtd->bhrt", qg, k) * scale * k_scale[:, :, None]
    row_pos = (lens[:, None] - c
               + torch.arange(c * group, device=q.device) // group)  # [B, R]
    col = torch.arange(n_cols, device=q.device)
    hidden = col > row_pos[:, :, None]
    if window is not None:
        hidden |= col < row_pos[:, :, None] - window + 1
    s = s.masked_fill(hidden[:, None], float("-inf"))
    return s, v * v_scale[..., None], row_pos


def paged_extend_plain(q: torch.Tensor, cache: PagedKVCache,
                       seq_slots: torch.Tensor, scale: float,
                       window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of H6-extend in f32 math: o f32 [B, C, Hq, d].

    Gathers every mapped page of each slot.  Chunk row i sits at position
    ``seq_lens - C + i`` and sees the columns up to it, the last
    ``window`` of them with a window; a row that sees nothing gives
    zeros; l sums the unscaled p."""
    b, c, hq, d = q.shape
    hkv = cache.num_kv_heads
    s, v, _ = _visible_scores(q, cache, seq_slots, scale, window)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrt,bhtd->bhrd", p, v)
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(b, hkv, c, hq // hkv, d).transpose(1, 2).reshape(
        b, c, hq, d)


def paged_decode_plain(q: torch.Tensor, cache: PagedKVCache,
                       seq_slots: torch.Tensor, scale: float,
                       window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of H6-decode and its merge in f32 math: o f32
    [B, Hq, d], the C = 1 case of :func:`paged_extend_plain`.  Columns at
    or past the slot's ``seq_lens`` (and before its band) are masked; an
    empty sequence gives zeros."""
    return paged_extend_plain(q[:, None], cache, seq_slots, scale,
                              window)[:, 0]


def decode_split(cache: PagedKVCache, batch: int, window: Optional[int],
                 n_sms: int, chunks: int = 1) -> Tuple[int, int]:
    """H6-decode's split over the SMs: ``(n_split, pages_per_split)``.

    A sequence's visible pages are at most ``cache.max_pages_per_seq``, or
    ``cdiv(window, page_size) + 1`` under a window (the band's first page
    may be partly before it).  They are cut into ``n_split`` runs of
    ``pages_per_split`` pages from the first in-band page on, with
    ``n_split`` as large as lets the ``batch * Hkv * chunks * n_split``
    blocks (``chunks`` of :func:`decode_chunks` per KV head) stay resident
    together (``DECODE_BLOCKS_PER_SM`` per SM), and at least 1.  Nothing
    here reads ``seq_lens``, so the plan costs no host sync."""
    span = cache.max_pages_per_seq
    if window is not None:
        span = min(span, cdiv(window, cache.page_size) + 1)
    span = max(span, 1)
    fit = (DECODE_BLOCKS_PER_SM * n_sms) // max(
        batch * cache.num_kv_heads * chunks, 1)
    per = cdiv(span, max(1, min(span, fit)))
    return cdiv(span, per), per


def paged_decode_partials_plain(q: torch.Tensor, cache: PagedKVCache,
                                seq_slots: torch.Tensor, scale: float,
                                window: Optional[int], n_split: int,
                                pages_per_split: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of H6-decode alone, in f32 math: the split's
    partials (o f32 [B, Hq, n_split, 1, d] normalized over each run, lse
    f32 [B, Hq, n_split, 1], natural log, scale included).

    Run k of a sequence holds its pages ``j0 + k * pages_per_split`` up to
    the next run's, ``j0`` the page of its first visible column; a run
    that sees nothing gives the merge identity (0, -inf).  Their merge
    (``splitkv_combine_plain``) is :func:`paged_decode_plain`."""
    b, hq, d = q.shape
    ps = cache.page_size
    s, v, row_pos = _visible_scores(q[:, None], cache, seq_slots, scale,
                                    window)
    first = row_pos[:, :1] + 1 - (window or 2 ** 62)      # [B, 1]
    j0 = first.clamp_min(0) // ps
    col = torch.arange(s.shape[-1], device=q.device)
    run = (col // ps - j0) // pages_per_split              # [B, cols]
    o_part, lse_part = [], []
    for k in range(n_split):
        sk = s.masked_fill((run != k)[:, None, None], float("-inf"))
        lse = torch.logsumexp(sk, dim=-1, keepdim=True)    # [B, Hkv, G, 1]
        shift = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
        o_part.append(torch.einsum("bhrt,bhtd->bhrd", torch.exp(sk - shift),
                                   v))
        lse_part.append(lse[..., 0])
    o = torch.stack(o_part, dim=3).reshape(b, hq, n_split, 1, d)
    return o, torch.stack(lse_part, dim=3).reshape(b, hq, n_split, 1)


def _check_paged_inputs(name: str, q: torch.Tensor, cache: PagedKVCache,
                        seq_slots: torch.Tensor,
                        window: Optional[int]) -> None:
    """What both paged kernels take: bf16 or f32 q
    (``ops.attention.kernel_dtype``) with ``SERVING_HEAD_DIM_RULE`` (the
    cache's d, at both dtypes), any GQA group, a page size
    that is a multiple of 128 below 2^15
    (``kv_cache.check_page_size``), the cache's dtypes, one CUDA device,
    contiguous 16-byte aligned tensors.  Raises otherwise."""
    tensors = (q, cache.kv_pages, cache.kv_scales, cache.page_table,
               cache.seq_lens, seq_slots)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(f"{name}: q, the cache and the slots must share one "
                         "CUDA device")
    kernel_dtype(name, q)
    if (cache.kv_pages.dtype != torch.int8
            or cache.kv_scales.dtype != torch.float32
            or any(t.dtype != torch.int32 for t in tensors[3:])):
        raise TypeError(f"{name} takes int8 pages, f32 scales and int32 "
                        "page table, lengths and slots")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         "aligned")
    d, hq, hkv = q.shape[-1], q.shape[-2], cache.num_kv_heads
    if (not kernel_head_dim(d) or cache.head_dim != d or hq % hkv
            or seq_slots.shape != (q.shape[0],)):
        raise ValueError(f"{name} takes {SERVING_HEAD_DIM_RULE}, the "
                         f"cache's d, and Hq % Hkv == 0; got q "
                         f"{tuple(q.shape)}, cache d={cache.head_dim}, "
                         f"Hkv={hkv}, slots "
                         f"{tuple(seq_slots.shape)}")
    try:
        check_page_size(cache.page_size)
    except ValueError as exc:
        raise ValueError(f"{name} takes page sizes that are a multiple of "
                         f"128 below 2^15: {exc}") from None
    _check_window(window)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS = {}                   # device index -> zeroed int32 tickets


def ticket_buffer(device: torch.device) -> Optional[torch.Tensor]:
    """The fused H6-decode's tickets on ``device`` (one int32 per batch
    row, KV head and group chunk, :func:`decode_chunks`; zero between
    launches), or None before its first launch or :func:`reserve_tickets`
    there."""
    return _TICKETS.get(device.index)


def reserve_tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed tickets on ``device``: the kept buffer, or a
    new zeroed one in its place when it is too small.  A CUDA graph that
    holds H6-decode keeps the raw pointer of the buffer in place when it
    was captured, so its capture reserves the batch's tickets first and
    the graph keeps a reference to that buffer (``graphs.StepGraph``): a
    later, larger batch swaps in a new buffer and the old one lives on
    with the graph.  Each buffer returns to zero after every launch, so
    the graphs and the eager calls that share one stay correct as long as
    they run in order on one stream."""
    buf = _TICKETS.get(device.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"H6-decode needs {n} tickets during a CUDA graph capture, "
                "but fewer are reserved: call reserve_tickets before the "
                "capture")
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKETS[device.index] = buf
    return buf


def _launch_decode(q: torch.Tensor, cache: PagedKVCache,
                   seq_slots: torch.Tensor, scale: float,
                   window: Optional[int], fused: bool):
    """One launch of H6-decode on q's device: the f32 partials (o [B, Hq,
    n_split, 1, d], lse [B, Hq, n_split, 1]; None when ``fused`` with one
    run, which writes O directly) and, with ``fused``, the merged o [B, Hq,
    d] in q's dtype (else None)."""
    _check_paged_inputs("H6-decode", q, cache, seq_slots, window)
    b, hq, d = q.shape
    hkv = cache.num_kv_heads
    chunks = decode_chunks(hq // hkv, d)
    n_split, per = decode_split(cache, b, window, _sm_count(q.device.index),
                                chunks)
    o_part = lse = o = tickets = None
    if not fused or n_split > 1:
        o_part = torch.empty((b, hq, n_split, 1, d), dtype=torch.float32,
                             device=q.device)
        lse = torch.empty((b, hq, n_split, 1), dtype=torch.float32,
                          device=q.device)
    if fused:
        o = torch.empty_like(q)
        tickets = reserve_tickets(q.device, b * hkv * chunks)
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    err = kernels.library().eft_paged_decode(
        q.data_ptr(), cache.kv_pages.data_ptr(), cache.kv_scales.data_ptr(),
        cache.page_table.data_ptr(), cache.seq_lens.data_ptr(),
        seq_slots.data_ptr(), ptr(o_part), ptr(lse), ptr(o), ptr(tickets),
        b, hq, hkv, d, cache.page_size, cache.max_pages_per_seq,
        cache.page_table.shape[0], window or 0, n_split, per, int(fused),
        scale, int(q.dtype == torch.float32), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H6-decode")
    paged_decode_partials.launches += 1
    return o_part, lse, o


def paged_decode_partials(
    q: torch.Tensor,               # [B, Hq, d] one token per sequence
    cache: PagedKVCache,
    seq_slots: torch.Tensor,       # int32 [B] cache slot per batch row
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """H6-decode alone: the split's partials, (o f32 [B, Hq, n_split, 1, d],
    lse f32 [B, Hq, n_split, 1]), with the split of :func:`decode_split`
    (132 SMs for CPU tensors).  They are what :func:`paged_decode_attention`
    merges inside the same kernel.

    CPU tensors take :func:`paged_decode_partials_plain`.  CUDA tensors
    launch kernel H6-decode (``csrc/paged_decode.cu``) once, without its
    merge, or raise.  ``paged_decode_partials.launches`` counts the
    launches of H6-decode, with or without the merge."""
    b, hq, d = q.shape
    if hq % cache.num_kv_heads:
        raise ValueError(f"q heads {hq} not divisible by kv heads "
                         f"{cache.num_kv_heads}")
    _check_window(window)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        split = decode_split(cache, b, window, 132,
                             decode_chunks(hq // cache.num_kv_heads, d))
        return paged_decode_partials_plain(q, cache, seq_slots, scale,
                                           window, *split)
    o_part, lse, _ = _launch_decode(q, cache, seq_slots, scale, window,
                                    fused=False)
    return o_part, lse


paged_decode_partials.launches = 0


def paged_decode_attention(
    q: torch.Tensor,               # [B, Hq, d] one token per sequence
    cache: PagedKVCache,
    seq_slots: torch.Tensor,       # int32 [B] cache slot per batch row
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Batched single-token decode over the paged INT8 cache: [B, Hq, d] in
    q.dtype.  ``window``: each new token attends only to the last
    ``window`` cache positions (its own included); pages wholly before the
    band are never read.

    CPU tensors take :func:`paged_decode_plain`.  CUDA tensors launch
    kernel H6-decode once, with its merge (counted in
    ``paged_decode_partials.launches``), or raise: it takes bf16 or f32 q
    (f32 O, f32 arithmetic throughout) with
    ``ops.attention.SERVING_HEAD_DIM_RULE`` at both dtypes, any GQA group
    and page sizes that are a multiple of 128 below 2^15.
    The f32 partials' workspace and O are allocated per call; the tickets
    (:func:`ticket_buffer`) are kept per device, zero between launches, and
    belong to one stream: the port launches on the current stream only, and
    two launches in flight at once on two streams would share them."""
    hq, d = q.shape[1:]
    if hq % cache.num_kv_heads:
        raise ValueError(f"q heads {hq} not divisible by kv heads "
                         f"{cache.num_kv_heads}")
    _check_window(window)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_plain(q, cache, seq_slots, scale,
                                  window).to(q.dtype)
    return _launch_decode(q, cache, seq_slots, scale, window, fused=True)[2]


def paged_extend_attention(
    q: torch.Tensor,               # [B, C, Hq, d] C new tokens per sequence
    cache: PagedKVCache,
    seq_slots: torch.Tensor,       # int32 [B] cache slot per batch row
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: each sequence's C newest tokens, already
    appended to the cache (``append_chunks``), attend causally over the
    sequence's paged history, the last ``window`` positions of it with a
    window.  Returns [B, C, Hq, d] in q.dtype.

    CPU tensors take :func:`paged_extend_plain`.  CUDA tensors launch kernel
    H6-extend (``csrc/paged_extend.cu``), which takes bf16 q or f32 q
    (bf16x3 on wgmma against the exact codes, f32 O) with
    ``ops.attention.SERVING_HEAD_DIM_RULE`` at both dtypes (past d 256 on
    ``csrc/paged_extend_wide.cu``, at f32 ``csrc/paged_extend_wide_f32.cu``),
    any GQA group and page sizes that are a multiple of 128 below 2^15, or
    raise.  ``paged_extend_attention.launches`` counts kernel launches."""
    b, c, hq, d = q.shape
    hkv = cache.num_kv_heads
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    _check_window(window)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_extend_plain(q, cache, seq_slots, scale,
                                  window).to(q.dtype)
    _check_paged_inputs("H6-extend", q, cache, seq_slots, window)
    if not 0 < c * (hq // hkv) < 2 ** 31 - 128:
        raise ValueError(f"H6-extend takes 0 < C * G < 2^31 - 128; got C={c}")
    o = torch.empty_like(q)
    err = kernels.library().eft_paged_extend(
        q.data_ptr(), cache.kv_pages.data_ptr(), cache.kv_scales.data_ptr(),
        cache.page_table.data_ptr(), cache.seq_lens.data_ptr(),
        seq_slots.data_ptr(), o.data_ptr(), b, c, hq, hkv, d,
        cache.page_size, cache.max_pages_per_seq, cache.page_table.shape[0],
        cache.kv_pages.shape[0], window or 0, scale,
        int(q.dtype == torch.float32), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H6-extend")
    paged_extend_attention.launches += 1
    return o


paged_extend_attention.launches = 0
