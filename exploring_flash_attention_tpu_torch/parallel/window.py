"""Sliding-window attention x sequence parallelism: one hop to the left
neighbour instead of a ring, on ``torch.distributed``.

Counterpart of ``parallel/window.py`` in the JAX package (``:82-193``).  A
causal window of ``w`` keys (the query's own included) lets a shard's
queries see only (a) its own keys and (b) the last ``w - 1`` keys of the
shard to its left, so the ring's ``sp - 1`` hops shrink to one hop of a
tail of ``t`` keys (``w - 1`` rounded up to 128, at most L_local):

- the local partial: H1's band over the shard's own keys (each row's band
  clipped at local position 0);
- the tail partial: H1's band in suffix form (``row_off``: the q rows sit
  right after the tail) over the neighbour's tail; only the first ``t``
  rows can see it, the others are the merge identity (0, -inf);
- the two merge by their LSE.

Shard 0 has no left neighbour (the exchange is a shift, not a ring): its
tail partial is left out.  The backward runs H3 once over [tail; local]
with q row 0 at position ``t`` (static positions, the band pruning all
work outside the window), then sends the tail's (dK, dV) back one hop to
the neighbour, which adds them to its last ``t`` keys.  Shard 0 runs it
over its own keys alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    merge_partials,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    flash_attention_bwd,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
    flash_attention_v1_window_partial,
)

TAIL_ALIGN = 128                # the tail is whole 128-key tiles of H1


def _tail_len(window: int, l_local: int) -> int:
    """The neighbour tail's length: the ``window - 1`` positions a shard's
    first rows can see, rounded up to whole tiles, at most the shard."""
    return min(-(-(window - 1) // TAIL_ALIGN) * TAIL_ALIGN, l_local)


def _validate(l_local: int, window: int) -> None:
    if window > l_local:
        raise NotImplementedError(
            f"sp window attention needs window <= L_local (one-hop tail "
            f"exchange); got window={window}, L_local={l_local}: use "
            f"fewer sp shards or ring attention (window=None)")


def _shift(x: Optional[torch.Tensor], like: torch.Tensor, group,
           step: int) -> Optional[torch.Tensor]:
    """Every rank ``r`` sends ``x`` to ``r + step`` (if that rank exists)
    and returns what ``r - step`` sent it, or None at the edge (a shift,
    not a ring).  ``like`` gives the received tensor's shape and dtype."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    ops, recv = [], None
    if 0 <= my + step < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, my + step), group))
    if 0 <= my - step < n:
        recv = torch.empty_like(like)
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, my - step), group))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    return recv


def _tail(k_l, v_l, group, t):
    """The left neighbour's last ``t`` keys and values, stacked [2, ...]
    (None on shard 0)."""
    kv = torch.stack([k_l[:, :, -t:], v_l[:, :, -t:]])
    return _shift(kv, kv, group, 1)


def _sp_window_forward(q_l, k_l, v_l, group, window, scale):
    l_local = q_l.shape[2]
    _validate(l_local, window)
    t = _tail_len(window, l_local)
    tail = _tail(k_l, v_l, group, t)
    o, lse = attention_partial_local(q_l, k_l, v_l, scale, causal=True,
                                     window=window)
    if tail is None:                    # shard 0: no left neighbour
        return o, lse
    o_b, lse_b = flash_attention_v1_window_partial(
        q_l[:, :, :t].contiguous(), tail[0], tail[1], window, scale,
        row_off=t)                      # q row 0 sits right after the tail
    o_t, lse_t = merge_partials(o[:, :, :t], lse[:, :, :t], o_b, lse_b)
    return (torch.cat([o_t, o[:, :, t:]], dim=2),
            torch.cat([lse_t, lse[:, :, t:]], dim=2))


def _sp_window_backward(q_l, k_l, v_l, out, g, lse, group, window, scale):
    l_local = q_l.shape[2]
    t = _tail_len(window, l_local)
    tail = _tail(k_l, v_l, group, t)    # recomputed, not saved
    if tail is None:
        dq, dk, dv = flash_attention_bwd(q_l, k_l, v_l, out, g, lse, scale,
                                         causal=True, window=window)
        d_tail = None
    else:
        k_cat = torch.cat([tail[0], k_l], dim=2)
        v_cat = torch.cat([tail[1], v_l], dim=2)
        dq, dk_cat, dv_cat = flash_attention_bwd(
            q_l, k_cat, v_cat, out, g, lse, scale, causal=True,
            static_positions=(t, 0), window=window)
        dk, dv = dk_cat[:, :, t:], dv_cat[:, :, t:]
        d_tail = torch.stack([dk_cat[:, :, :t], dv_cat[:, :, :t]])
    # the tail's gradients go back one hop, right to left; the last shard
    # receives none (its tail never left home)
    back = _shift(d_tail, torch.stack([dk[:, :, -t:], dv[:, :, -t:]]),
                  group, -1)
    if back is not None:
        dk = torch.cat([dk[:, :, :-t], dk[:, :, -t:] + back[0]], dim=2)
        dv = torch.cat([dv[:, :, :-t], dv[:, :, -t:] + back[1]], dim=2)
    return dq, dk.contiguous(), dv.contiguous()


class _SpWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, window, scale):
        o, lse = _sp_window_forward(q, k, v, group, window, scale)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = (group, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _sp_window_backward(q, k, v, out, g.contiguous(), lse,
                                         *ctx.window)
        return dq, dk, dv, None, None, None


def sp_window_attention(
    q_l: torch.Tensor,             # [B, Hq, L_local, d]  (this shard)
    k_l: torch.Tensor,             # [B, Hkv, L_local, d]
    v_l: torch.Tensor,
    group,
    window: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable causal sliding-window attention over an sp-sharded
    sequence, called by every rank of ``group`` on its own shard: this
    shard's output in q's dtype.  One hop forward, two backward; O(L_local
    * window) work a rank.  ``window`` must not exceed L_local
    (``NotImplementedError``).  GQA: k/v may carry fewer heads."""
    if scale is None:
        scale = 1.0 / math.sqrt(q_l.shape[3])
    return _SpWindowAttention.apply(q_l.contiguous(), k_l.contiguous(),
                                    v_l.contiguous(), group, window, scale)
