"""INT8 paged KV-cache of the port.

Counterpart of ``serving/kv_cache.py`` in the JAX package.  Tokens live in
fixed-size pages found through a per-sequence page table, stored INT8 with
one f32 scale per (token, head) (absmax over d):

    kv_pages  : int8  [n_pages, 2, Hkv, page_size, d]   (0 = K, 1 = V)
    kv_scales : f32   [n_pages, 2, Hkv, 1, page_size]
    page_table: int32 [max_seqs, max_pages_per_seq]
    seq_lens  : int32 [max_seqs]

The JAX package packs several heads into one 128-lane row when d < 128,
because the TPU's page copies need a 128-wide last dimension.  The port
never packs: at d = 128 the two layouts are the same bits, and at d < 128
caches are compared through :func:`gather_kv`.

Unlike the JAX package's functional updates, the append functions and
:func:`set_seq_lens` write the cache's tensors in place: a decode step
then costs no copy of the cache.  Writes to out-of-range slots are
dropped, as the JAX package's ``mode="drop"`` scatters drop them, without
a host sync.  Page management (:class:`PageAllocator`) is host-side
Python.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from exploring_flash_attention_tpu_torch.configs import cdiv

INT8_MAX = 127.0
# page sizes the JAX package takes: a multiple of its 128 lanes
# (serving/kv_cache.py:101-102) below the 15-bit token count of its decode
# kernel's metadata (serving/decode.py:772); H6-decode and H6-extend take
# every one of them
PAGE_LANES = 128
MAX_PAGE_SIZE = 2 ** 15 - PAGE_LANES


@dataclasses.dataclass
class PagedKVCache:
    kv_pages: torch.Tensor       # int8 [n_pages, 2, Hkv, page_size, d]
    kv_scales: torch.Tensor      # f32  [n_pages, 2, Hkv, 1, page_size]
    page_table: torch.Tensor     # int32 [max_seqs, max_pages]
    seq_lens: torch.Tensor       # int32 [max_seqs]
    page_size: int

    @property
    def num_kv_heads(self) -> int:
        return self.kv_pages.shape[2]

    @property
    def head_dim(self) -> int:
        return self.kv_pages.shape[4]

    @property
    def max_pages_per_seq(self) -> int:
        return self.page_table.shape[1]


def make_cache(
    num_kv_heads: int,
    head_dim: int,
    n_pages: int,
    page_size: int = 128,
    max_seqs: int = 64,
    max_pages_per_seq: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> PagedKVCache:
    check_page_size(page_size)
    max_pages_per_seq = max_pages_per_seq or n_pages
    return PagedKVCache(
        kv_pages=torch.zeros(
            (n_pages, 2, num_kv_heads, page_size, head_dim),
            dtype=torch.int8, device=device),
        kv_scales=torch.zeros(
            (n_pages, 2, num_kv_heads, 1, page_size),
            dtype=torch.float32, device=device),
        page_table=torch.zeros((max_seqs, max_pages_per_seq),
                               dtype=torch.int32, device=device),
        seq_lens=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
        page_size=page_size,
    )


def check_page_size(page_size: int) -> None:
    """Raise ``ValueError`` unless ``page_size`` is one the JAX package's
    cache and decode take: a positive multiple of 128 below 2^15."""
    if page_size <= 0 or page_size % PAGE_LANES:
        raise ValueError(f"page_size must be a multiple of {PAGE_LANES} "
                         f"(lane width), got {page_size}")
    if page_size > MAX_PAGE_SIZE:
        raise ValueError(f"page_size must fit the 15-bit ntok meta field "
                         f"(below 2^15), got {page_size}")


class PageAllocator:
    """Host-side free-list page allocator."""

    def __init__(self, n_pages: int):
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self.n_pages = n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"out of KV pages: want {n}, have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        self._free.extend(pages)


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (row over d) symmetric int8.  x: [..., d] f32/bf16 ->
    (int8 [..., d], f32 scale [...])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / INT8_MAX
    q = torch.round(xf / scale[..., None]).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def _drop_out_of_range(seq_ids: torch.Tensor, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Row bookkeeping of the writes that drop rows whose slot is out of
    range, as the JAX package's ``mode="drop"`` scatters do, with no host
    sync (so a CUDA graph can hold it) and no race.

    Returns ``(safe, valid, src, keep)``: ``safe`` the slot ids clamped to
    [0, n) (int64), ``valid`` whether each row's slot is in range, ``src``
    the row whose write each row repeats and ``keep`` whether that row is
    valid.  A dropped row repeats the first valid row's write, bit for
    bit, so the two never race for one target with different values; when
    no row is valid, every row repeats row 0 (``keep`` False), whose
    caller writes back what its target holds."""
    ids = seq_ids.long()
    safe = ids.clamp(0, n - 1)
    valid = safe == ids
    rows = torch.arange(ids.shape[0], device=ids.device)
    src = torch.where(valid, rows, valid.to(torch.int32).argmax())
    return safe, valid, src, valid[src]


def append_tokens(
    cache: PagedKVCache,
    seq_ids: torch.Tensor,       # int [B] cache slots being written
    k_new: torch.Tensor,         # [B, Hkv, d] one new K row per sequence
    v_new: torch.Tensor,
) -> None:
    """Append one token per sequence in place (quantize + scatter) at each
    sequence's ``seq_lens`` position, then advance ``seq_lens``.

    The pages must already be mapped in the page table.  Rows whose
    ``seq_ids`` are out of range (negative, or ``max_seqs`` and past) are
    dropped: no page write, no length bump.  The scheduler's fixed-capacity
    step pads its batch with such rows.  The valid slots must be distinct.
    No step waits on the host, so a CUDA graph can hold the call."""
    safe, valid, src, keep = _drop_out_of_range(seq_ids,
                                                cache.seq_lens.shape[0])
    slot = safe[src]                    # the slot each row's write goes to
    pos = cache.seq_lens[slot]
    page_idx = (pos // cache.page_size).clamp_max(cache.max_pages_per_seq - 1)
    page_ids = cache.page_table[slot, page_idx]
    offset = pos % cache.page_size
    kv, sc = _quantize_rows(torch.stack([k_new, v_new], dim=1)[src])
    # with no valid row, every row writes back what its target holds
    kv = torch.where(keep[:, None, None, None], kv,
                     cache.kv_pages[page_ids, :, :, offset, :])
    sc = torch.where(keep[:, None, None], sc,
                     cache.kv_scales[page_ids, :, :, 0, offset])
    # pages[page_ids[b], :, h, offset[b], :] = kv[b, :, h, :]
    cache.kv_pages[page_ids, :, :, offset, :] = kv
    cache.kv_scales[page_ids, :, :, 0, offset] = sc
    cache.seq_lens.scatter_add_(0, safe, valid.to(cache.seq_lens.dtype))


def append_chunks(
    cache: PagedKVCache,
    seq_ids: torch.Tensor,       # int [B] cache slots being written
    k_new: torch.Tensor,         # [B, C, Hkv, d] C new K rows per sequence
    v_new: torch.Tensor,
) -> None:
    """Append C tokens per sequence in place at each sequence's current
    ``seq_lens`` (any offset, not only a page boundary), then advance
    ``seq_lens`` by C: :func:`append_tokens` over a chunk, the multi-turn
    cache write.  Only the C rows are written, so the rows already in a
    partly filled page survive.  The pages must already be mapped; rows
    past the slot's last mapped page write into that page, as in
    :func:`append_tokens` (the JAX package's gather clamps the page index
    the same way).
    (``append_tokens`` does not call this with C = 1: the position arange
    would add kernel launches to every decode step.)"""
    ids = seq_ids.long()
    c = k_new.shape[1]
    pos = cache.seq_lens[ids].long()[:, None] + torch.arange(
        c, device=k_new.device)                                 # [B, C]
    page_idx = (pos // cache.page_size).clamp_max(cache.max_pages_per_seq - 1)
    page_ids = cache.page_table[ids[:, None], page_idx].long()
    offset = pos % cache.page_size
    kq, ks = _quantize_rows(k_new)                      # [B,C,H,d], [B,C,H]
    vq, vs = _quantize_rows(v_new)
    # pages[page_ids[b, i], :, h, offset[b, i], :] = kv[b, i, :, h, :]
    cache.kv_pages[page_ids, :, :, offset, :] = torch.stack([kq, vq], dim=2)
    cache.kv_scales[page_ids, :, :, 0, offset] = torch.stack([ks, vs], dim=2)
    cache.seq_lens[ids] += c


def append_prompt(
    cache: PagedKVCache,
    seq_id: int,
    k_prompt: torch.Tensor,      # [L, Hkv, d]
    v_prompt: torch.Tensor,
    start: Optional[int] = None,
    page_ids: Optional[List[int]] = None,
) -> None:
    """Append one sequence's prompt K/V in place (the prefill path), as a
    host loop over pages: each page's rows are quantized and written with
    one update, then ``seq_lens[seq_id]`` becomes ``start + L``.

    ``start`` (the write position) defaults to ``seq_lens[seq_id]``, read
    from the device; it must lie on a page boundary, or this raises
    ``ValueError``.  ``page_ids`` (the slot's mapped pages, on the host)
    spare the page-table reads; by default they come from the table."""
    l = k_prompt.shape[0]
    ps = cache.page_size
    if start is None:
        start = int(cache.seq_lens[seq_id])
    if start % ps != 0:
        raise ValueError("prompt append must start on a page boundary")
    for p0 in range(0, l, ps):
        n = min(ps, l - p0)
        pidx = (start + p0) // ps
        page_id = (page_ids[pidx] if page_ids is not None
                   else int(cache.page_table[seq_id, pidx]))
        kq, ks = _quantize_rows(k_prompt[p0:p0 + n])        # [n,H,d], [n,H]
        vq, vs = _quantize_rows(v_prompt[p0:p0 + n])
        cache.kv_pages[page_id, :, :, :n] = torch.stack(
            [kq.transpose(0, 1), vq.transpose(0, 1)])       # [2, H, n, d]
        cache.kv_scales[page_id, :, :, 0, :n] = torch.stack(
            [ks.transpose(0, 1), vs.transpose(0, 1)])       # [2, H, n]
    cache.seq_lens[seq_id] = start + l


def append_prompts(
    cache: PagedKVCache,
    seq_ids: torch.Tensor,       # int [B] cache slots (page tables mapped)
    k_prompts: torch.Tensor,     # [B, L, Hkv, d], the same L for the batch
    v_prompts: torch.Tensor,
    page_ids: Optional[torch.Tensor] = None,     # int [B, cdiv(L, ps)]
) -> None:
    """Batched prefill append in place: quantize and scatter every
    sequence's prompt K/V.  Sequences must be empty (prompts start at
    position 0); a ragged last page is zero-padded (the decode kernel masks
    past ``seq_lens``).  ``page_ids``, the destination pages, when the
    caller (the scheduler's allocator) already knows them; by default they
    come from the page table.  Rows whose ``seq_ids`` are out of range get
    no length (their pages, given or looked up, are still written)."""
    b, l, hkv, d = k_prompts.shape
    ps = cache.page_size
    npg = cdiv(l, ps)
    pad = npg * ps - l

    def prep(x):
        xq, xs = _quantize_rows(x)                  # [B,L,H,d], [B,L,H]
        if pad:
            xq = torch.nn.functional.pad(xq, (0, 0, 0, 0, 0, pad))
            xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        # [B*npg, Hkv, ps, d] / [B*npg, Hkv, 1, ps]
        xq = xq.reshape(b, npg, ps, hkv, d).permute(0, 1, 3, 2, 4)
        xs = xs.reshape(b, npg, ps, hkv).permute(0, 1, 3, 2)
        return (xq.reshape(b * npg, hkv, ps, d),
                xs.reshape(b * npg, hkv, 1, ps))

    kq, ks = prep(k_prompts)
    vq, vs = prep(v_prompts)
    if page_ids is None:
        page_ids = cache.page_table[
            seq_ids.long().clamp(0, cache.seq_lens.shape[0] - 1), :npg]
    page_ids = page_ids.reshape(-1).long()
    cache.kv_pages[page_ids] = torch.stack([kq, vq], dim=1)
    cache.kv_scales[page_ids] = torch.stack([ks, vs], dim=1)
    _set_lens(cache, seq_ids, torch.full_like(seq_ids, l))


def _set_lens(cache: PagedKVCache, seq_ids: torch.Tensor,
              new_lens: torch.Tensor) -> None:
    safe, _, src, keep = _drop_out_of_range(seq_ids,
                                            cache.seq_lens.shape[0])
    slot = safe[src]
    cache.seq_lens[slot] = torch.where(
        keep, new_lens.to(cache.seq_lens.dtype)[src], cache.seq_lens[slot])


def set_seq_lens(
    cache: PagedKVCache,
    seq_ids: torch.Tensor,       # int [B] cache slots
    new_lens: torch.Tensor,      # int [B]
) -> None:
    """Set per-sequence lengths in place (the speculative-decoding
    rollback: rejected draft tokens stay in their pages but the kernels
    mask past ``seq_lens``, and the next append overwrites them).  Pages
    stay mapped.  Out-of-range ``seq_ids`` are dropped."""
    _set_lens(cache, seq_ids, torch.as_tensor(new_lens,
                                              device=cache.seq_lens.device))


def gather_kv(cache: PagedKVCache, seq_id: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized contiguous f32 [Hkv, L, d] K/V of one sequence: the
    reference path of the tests (the kernels never materialize this)."""
    l = int(cache.seq_lens[seq_id])
    n_pages = cdiv(l, cache.page_size)
    ids = cache.page_table[seq_id, :n_pages].long()
    kv = cache.kv_pages[ids].float()                # [np, 2, H, ps, d]
    sc = cache.kv_scales[ids]                       # [np, 2, H, 1, ps]
    kv = kv * sc.transpose(3, 4)
    npg, _, h, ps, d = kv.shape
    kv = kv.permute(1, 2, 0, 3, 4).reshape(2, h, npg * ps, d)[:, :, :l]
    return kv[0], kv[1]
