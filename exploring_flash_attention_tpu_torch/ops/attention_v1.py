"""The dense attention forward of the port, ``flash_attention_v1``, and its
LSE partials, on kernel H1.

Counterpart of ``ops/attention_v1.py`` in the JAX package:
``flash_attention_v1`` (``:1563``), ``flash_attention_v1_causal_partial``
(``:842``) and ``flash_attention_v1_window_partial`` (``:1055``).  The JAX
module picks among seven TPU kernels (B1–B7) and, for a long non-causal
KV, the split-KV pair (span partials, B8 or B9, merged by B10), by VMEM
budget, head dim and mask.  Here a call is one launch of H1; a non-causal
call whose Q tiles would leave the card's SMs short of blocks runs H1 over
KV spans and merges them with H2 (:func:`split_kv_span`).  Of the
``TileConfig`` H1 reads ``block_q`` (its Q tile: 64 rows when ``block_q
<= 64``, else 128) and ``softmax`` (``"bound"``: the Cauchy-Schwarz row
shift, ``ops/attention.py``).  Layouts are the JAX package's: q ``[B, Hq,
Lq, d]``, k/v ``[B, Hkv, Lkv, d]``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from exploring_flash_attention_tpu_torch.configs import TileConfig, cdiv
from exploring_flash_attention_tpu_torch.ops.attention import (
    H1_KV_TILE,
    attention_partial_local,
    h1_q_rows,
    prefill_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    splitkv_combine,
)

# H1 keeps one block resident per SM (384 threads and 224 KB of shared
# memory at d=128, csrc/prefill_attention.cu) and an H100 has 132 SMs: one
# wave of blocks.
RESIDENT_BLOCKS = 132
MIN_SPAN = 512                  # keys per span at the least: 4 K/V tiles


def split_kv_span(b: int, hq: int, lq: int, lkv: int,
                  q_rows: int = 128) -> Optional[int]:
    """The KV span (keys, whole tiles) a non-causal call runs H1 with, or
    None for one span.  Where the (batch*head, Q tile) blocks, at H1's Q
    tile of ``q_rows``, fill less than half of one wave of
    :data:`RESIDENT_BLOCKS`, the KV is cut into as many spans as keep the
    blocks within that wave, each of at least :data:`MIN_SPAN` keys: at
    B=1, H=8, Lq=1024, Lkv=8192 and 128-row tiles, 2 spans and 128 blocks
    instead of 64.  A second, partly filled wave costs a whole block's
    time, so more spans than fit one wave are slower (PERF.md)."""
    nkb = min(RESIDENT_BLOCKS // (b * hq * cdiv(lq, q_rows)),
              lkv // MIN_SPAN)
    if nkb < 2:
        return None
    return cdiv(cdiv(lkv, nkb), H1_KV_TILE) * H1_KV_TILE


def flash_attention_v1(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    config: TileConfig = TileConfig(),
    scale: Optional[float] = None,
    causal: bool = False,
    out_dtype: Optional[torch.dtype] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention forward: o [B, Hq, Lq, d] in ``out_dtype`` or
    q.dtype.

    GQA: k/v may carry fewer heads (Hq % Hkv == 0).  ``causal`` uses the
    decode convention (the q rows are the last Lq positions).  ``window``
    is the sliding-window width, inclusive of the row's own position; it
    needs ``causal`` and is at least 1, and a window of Lkv or more is plain
    causal.  The default scale is ``1/sqrt(d)``.  A non-causal call with a
    :func:`split_kv_span` runs H1 once over the spans and H2 once to merge
    them; every other call is one H1 launch.

    ``config.block_q`` picks H1's Q tile (64 rows when ``<= 64``, else
    128; the result is the same).  ``config.softmax="bound"`` runs H1's
    bound form, after :func:`~ops.attention.bound_kmax`'s torch ops, on
    every route: where the JAX package warns and runs its exact kernels
    (its windowed one-pass and long-KV split routes,
    ``ops/attention_v1.py:1654,1684``), H1 is one kernel and honours it.
    Its max error against the f64 oracle is about twice exact's at bf16
    (the top weight is no longer exactly 1.0).  The other fields are the
    JAX package's TPU knobs and are not read."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    if (k.shape != (b, hkv, lkv, d) or v.shape != (b, hkv, lkv, d)
            or hq % hkv != 0):
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_rows = h1_q_rows(config)
    span = None if causal else split_kv_span(b, hq, lq, lkv, q_rows)
    if span is None:
        return prefill_attention(q, k, v, scale, lkv - lq, causal, window,
                                 out_dtype=out_dtype, with_lse=False,
                                 q_rows=q_rows, softmax=config.softmax)[0]
    o_part, lse = prefill_attention(
        q, k, v, scale, lkv - lq, False, window, kv_span=span,
        out_dtype=torch.promote_types(q.dtype, torch.float32),
        q_rows=q_rows, softmax=config.softmax)
    return splitkv_combine(o_part, lse, out_dtype=out_dtype or q.dtype)


def flash_attention_v1_causal_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    static_positions: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal partial forward over the whole KV: (o [B,H,Lq,d] f32
    normalized, lse [B,H,Lq] f32 natural log), at the positions
    ``(q_pos0, kv_pos0)`` (the decode convention by default): the causal
    route of :func:`attention_partial_local`."""
    return attention_partial_local(q, k, v, scale=scale, causal=True,
                                   static_positions=static_positions)


def flash_attention_v1_window_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    scale: Optional[float] = None,
    row_off: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sliding-window partial forward over the whole KV: (o [B,H,Lq,d] f32
    normalized, lse [B,H,Lq] f32 natural log).

    Row ``j`` sits at position ``Lkv - Lq + row_off + j``.  With
    ``row_off = Lq`` the rows lie past the KV span (the suffix band of the
    JAX package's sequence-parallel window path); a row whose band misses
    every key gives (0, -inf), the merge identity."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return prefill_attention(
        q, k, v, scale, k.shape[2] - q.shape[2] + row_off, True, window,
        out_dtype=torch.float32)
