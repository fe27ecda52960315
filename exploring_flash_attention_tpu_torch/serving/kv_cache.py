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

Unlike the JAX package's functional updates, the append functions write
the cache's tensors in place: a decode step then costs no copy of the
cache.  Page management (:class:`PageAllocator`) is host-side Python.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from exploring_flash_attention_tpu_torch.configs import cdiv

INT8_MAX = 127.0


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
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
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


def append_tokens(
    cache: PagedKVCache,
    seq_ids: torch.Tensor,       # int [B] cache slots being written
    k_new: torch.Tensor,         # [B, Hkv, d] one new K row per sequence
    v_new: torch.Tensor,
) -> None:
    """Append one token per sequence in place (quantize + scatter) at each
    sequence's ``seq_lens`` position, then advance ``seq_lens``.

    The pages must already be mapped in the page table and ``seq_ids``
    must be distinct valid slots (the JAX version's drop-out-of-range mode
    serves its scheduler, which is not ported)."""
    ids = seq_ids.long()
    pos = cache.seq_lens[ids].long()                            # [B]
    page_ids = cache.page_table[ids, pos // cache.page_size].long()
    offset = pos % cache.page_size
    kq, ks = _quantize_rows(k_new)                              # [B,H,d],[B,H]
    vq, vs = _quantize_rows(v_new)
    # pages[page_ids[b], :, h, offset[b], :] = kv[b, :, h, :]
    cache.kv_pages[page_ids, :, :, offset, :] = torch.stack([kq, vq], dim=1)
    cache.kv_scales[page_ids, :, :, 0, offset] = torch.stack([ks, vs], dim=1)
    cache.seq_lens[ids] += 1


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
    partly filled page survive.  The pages must already be mapped.
    (``append_tokens`` does not call this with C = 1: the position arange
    would add kernel launches to every decode step.)"""
    ids = seq_ids.long()
    c = k_new.shape[1]
    pos = cache.seq_lens[ids].long()[:, None] + torch.arange(
        c, device=k_new.device)                                 # [B, C]
    page_ids = cache.page_table[ids[:, None], pos // cache.page_size].long()
    offset = pos % cache.page_size
    kq, ks = _quantize_rows(k_new)                      # [B,C,H,d], [B,C,H]
    vq, vs = _quantize_rows(v_new)
    # pages[page_ids[b, i], :, h, offset[b, i], :] = kv[b, i, :, h, :]
    cache.kv_pages[page_ids, :, :, offset, :] = torch.stack([kq, vq], dim=2)
    cache.kv_scales[page_ids, :, :, 0, offset] = torch.stack([ks, vs], dim=2)
    cache.seq_lens[ids] += c


def append_prompts(
    cache: PagedKVCache,
    seq_ids: torch.Tensor,       # int [B] cache slots (page tables mapped)
    k_prompts: torch.Tensor,     # [B, L, Hkv, d], the same L for the batch
    v_prompts: torch.Tensor,
) -> None:
    """Batched prefill append in place: quantize and scatter every
    sequence's prompt K/V.  Sequences must be empty (prompts start at
    position 0); a ragged last page is zero-padded (the decode kernel masks
    past ``seq_lens``)."""
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
    ids = seq_ids.long()
    page_ids = cache.page_table[ids, :npg].reshape(-1).long()
    cache.kv_pages[page_ids] = torch.stack([kq, vq], dim=1)
    cache.kv_scales[page_ids] = torch.stack([ks, vs], dim=1)
    cache.seq_lens[ids] = l


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
