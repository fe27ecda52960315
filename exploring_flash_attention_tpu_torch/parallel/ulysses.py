"""Ulysses (all-to-all) sequence-parallel attention on ``torch.distributed``.

Counterpart of ``parallel/ulysses.py`` in the JAX package.  Two
``all_to_all_single`` calls re-shard the problem so that each rank
computes a whole attention over part of the heads:

    [B, H, L/sp, d]  --all-to-all-->  [B, H/sp, L, d]
    flash_attention at full length (kernel H1, and H3 backward)
    [B, H/sp, L, d]  --all-to-all-->  [B, H, L/sp, d]

The softmax is never split, so the result is that of one-device attention
over the gathered heads.  Heads must divide over the ``sp`` group (Hq and
Hkv alike).  Each all-to-all's backward is the other one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from exploring_flash_attention_tpu_torch.ops.attention import flash_attention
from exploring_flash_attention_tpu_torch.parallel.mesh import (
    axis_size,
    shard,
)


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, H, L/n, d] on each rank -> [B, H/n, L, d]: rank r keeps head
    group r and gathers every rank's sequence block, in rank order."""
    b, h, l, d = x.shape
    send = x.reshape(b, n, h // n, l, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)             # [n (sequence block), ...]
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * l, d)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse: [B, H/n, L, d] -> [B, H, L/n, d]."""
    b, hn, length, d = x.shape
    l = length // n
    send = x.reshape(b, hn, n, l, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)             # [n (head group), ...]
    dist.all_to_all_single(recv, send, group=group)
    return recv.transpose(0, 1).reshape(b, n * hn, l, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _seq_to_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group, ctx.n), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _heads_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group, ctx.n), None, None


def _check_heads(h: int, h_kv: int, sp: int) -> None:
    if h % sp or h_kv % sp:
        raise ValueError(
            f"ulysses needs head counts divisible by the sp axis: "
            f"H={h}, H_kv={h_kv}, sp={sp}")


def ulysses_flash_attention(
    q_l: torch.Tensor,             # [B, Hq, Lq/sp, d]  (this shard)
    k_l: torch.Tensor,             # [B, Hkv, Lkv/sp, d]
    v_l: torch.Tensor,
    group,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Shard-local Ulysses attention over ``group`` (the ``sp`` axis),
    called by every rank on its own sequence block: this block's output
    [B, Hq, Lq/sp, d].  q and k/v may carry different lengths (cross
    attention: each side gathers its own).  Differentiable."""
    sp = dist.get_world_size(group)
    _check_heads(q_l.shape[1], k_l.shape[1], sp)
    if sp == 1:
        return flash_attention(q_l, k_l, v_l, scale=scale, causal=causal)
    qh, kh, vh = (_SeqToHeads.apply(x.contiguous(), group, sp)
                  for x in (q_l, k_l, v_l))
    o = flash_attention(qh, kh, vh, scale=scale, causal=causal)
    return _HeadsToSeq.apply(o.contiguous(), group, sp)


def ulysses_attention(
    q: torch.Tensor,               # [B, Hq, L, d]  (every rank: all of it)
    k: torch.Tensor,               # [B, Hkv, L, d]
    v: torch.Tensor,
    mesh,
    axis_name: str = "sp",
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """All-to-all attention on whole tensors: each rank cuts its sequence
    block over ``axis_name`` and returns its block of the output, as the
    JAX package's ``ulysses_attention`` leaves its output sharded.  Head
    counts that do not divide over the axis raise ``ValueError``."""
    _check_heads(q.shape[1], k.shape[1], axis_size(mesh, axis_name))
    return ulysses_flash_attention(
        *(shard(x, mesh, axis_name, 2) for x in (q, k, v)),
        mesh.get_group(axis_name), scale, causal)
