"""Ring attention over the sequence axis, differentiable, on
``torch.distributed``.

Counterpart of ``parallel/ring.py`` in the JAX package.  Each rank of the
``sp`` group holds one Q shard and one K/V shard of a sequence; the K/V
shards travel around the ring (``batch_isend_irecv`` to the next rank,
from the previous one) while every rank folds each visiting shard's
normalized partial into its running (O, LSE) with the associative merge
(``merge_partials``).  After ``sp`` hops every Q shard has seen every K/V
shard, and memory per rank stays O(L_local) in both passes.

The backward is JAX's reverse ring (``:149-202``): K/V rotate again,
together with their f32 (dK, dV) accumulators, and every rank adds its
Q shard's contribution to the shard in hand before it moves on; after
``sp`` hops each shard is home with every rank's contribution.  dQ adds
up in f32 on its own rank.  Each hop's gradients come from H3 in the
dtype of K and V, as JAX's ``flash_attention_bwd`` returns them (the GQA
group summed in f32, then rounded, ``ops/attention_bwd.py:670-676``); the
ring adds them in f32.

Causal hops run at traced positions ``(my * Lq_local, src * Lkv_local)``:
one int32 pair per hop in device memory (:func:`ring_offsets`), which H1
and H3 read themselves.  A hop whose keys all lie in the rank's future
(``src > my``) sees nothing: H1 gives (0, -inf), the merge identity, and
H3 zeros.  Each hop's transfer of the next shard starts before the hop's
compute, as JAX starts its ``ppermute``.  The per-hop math
(:func:`ring_hop_forward`, :func:`ring_hop_backward`) does no
communication, so one process can run every rank's hops by hand.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from exploring_flash_attention_tpu_torch.configs import TileConfig
from exploring_flash_attention_tpu_torch.ops.attention import (
    h1_q_rows,
    merge_partials,
    prefill_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    masked_attention_bwd,
)
from exploring_flash_attention_tpu_torch.parallel.mesh import (
    shard,
)


def ring_offsets(my: int, n: int, lq_local: int, lkv_local: int,
                 device: torch.device) -> torch.Tensor:
    """Hop ``s``'s positions ``(my * Lq_local, src * Lkv_local)``, ``src =
    (my - s) mod n``, as int32 [n, 2] on ``device``: row ``s`` is the
    traced pair H1 and H3 read at hop ``s``.  Built on the device."""
    src = torch.remainder(my - torch.arange(n, device=device), n)
    q_pos = torch.full((n,), my * lq_local, device=device)
    return torch.stack([q_pos, src * lkv_local], dim=1).to(torch.int32)


def ring_hop_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     offs: Optional[torch.Tensor],
                     o: Optional[torch.Tensor], lse: Optional[torch.Tensor],
                     scale: float, causal: bool, q_rows: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop's forward, no communication: the partial (f32 O, LSE) of q
    over this K/V shard (H1 at its Q tile of ``q_rows``, causal at the
    traced pair ``offs``, or without a mask), merged into the running (o,
    lse) unless they are None."""
    o_p, lse_p = prefill_attention(q, k, v, scale,
                                   offs if causal else 0, causal,
                                   out_dtype=torch.float32, q_rows=q_rows)
    if o is None:
        return o_p, lse_p
    return merge_partials(o, lse, o_p, lse_p)


def ring_hop_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      delta: Optional[torch.Tensor],
                      offs: Optional[torch.Tensor], scale: float,
                      causal: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One hop's gradients, no communication: (dq, dk, dv) of q against this
    K/V shard under the ring's global ``out`` and ``lse`` (H3-dkv and H3-dq,
    causal at the traced pair ``offs``, or without a mask), with ``delta``
    (rowsum(dO∘O), f32) reduced once by the caller."""
    return masked_attention_bwd(q, k, v, out, do, lse, scale, causal,
                                offs if causal else 0, None, delta=delta)


class _Exchange:
    """One hop of the ring: send ``x`` to the next rank of ``group`` and
    receive the previous rank's into a new tensor; :meth:`wait` returns
    it."""

    def __init__(self, x: torch.Tensor, group, my: int, n: int):
        self.recv = torch.empty_like(x)
        nxt = dist.get_global_rank(group, (my + 1) % n)
        prv = dist.get_global_rank(group, (my - 1) % n)
        self.reqs: List = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, nxt, group),
            dist.P2POp(dist.irecv, self.recv, prv, group)])

    def wait(self) -> torch.Tensor:
        for r in self.reqs:
            r.wait()
        return self.recv


def _ring_forward(q, k, v, group, scale, causal, q_rows):
    n, my = dist.get_world_size(group), dist.get_rank(group)
    offs = (ring_offsets(my, n, q.shape[2], k.shape[2], q.device)
            if causal else [None] * n)
    kv = torch.stack([k, v]) if n > 1 else (k, v)  # one message a hop
    o = lse = None
    for s in range(n):
        nxt = _Exchange(kv, group, my, n) if s < n - 1 else None
        o, lse = ring_hop_forward(q, kv[0], kv[1], offs[s], o, lse, scale,
                                  causal, q_rows)
        if nxt is not None:
            kv = nxt.wait()
    return o, lse


def _ring_backward(q, k, v, out, do, lse, group, scale, causal):
    n, my = dist.get_world_size(group), dist.get_rank(group)
    offs = (ring_offsets(my, n, q.shape[2], k.shape[2], q.device)
            if causal else [None] * n)
    do = do.to(q.dtype).contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    kv = torch.stack([k, v]) if n > 1 else (k, v)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2, *k.shape), dtype=torch.float32, device=q.device)
    for s in range(n):
        nxt = _Exchange(kv, group, my, n) if s < n - 1 else None
        dq_p, dk_p, dv_p = ring_hop_backward(q, kv[0], kv[1], out, do, lse,
                                             delta, offs[s], scale, causal)
        dq += dq_p.float()
        dkv[0] += dk_p.float()
        dkv[1] += dv_p.float()
        if n > 1:                       # the gradients follow their shard
            dkv = _Exchange(dkv, group, my, n).wait()
        if nxt is not None:
            kv = nxt.wait()
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, causal, q_rows):
        o, lse = _ring_forward(q, k, v, group, scale, causal, q_rows)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, scale, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, g, lse, *ctx.ring)
        return dq, dk, dv, None, None, None, None


def ring_flash_attention(
    q_l: torch.Tensor,             # [B, Hq, Lq_local, d]  (this shard)
    k_l: torch.Tensor,             # [B, Hkv, Lkv_local, d]
    v_l: torch.Tensor,
    group,
    config: TileConfig = TileConfig(),
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Differentiable ring attention over ``group`` (the ``sp`` axis's
    ``ProcessGroup``), called by every rank of it on its own shards: this
    shard's output [B, Hq, Lq_local, d] in q's dtype.  Shard ``r`` holds
    positions ``[r * L_local, (r + 1) * L_local)``; ``causal`` masks by
    those global positions.  GQA: k/v may carry fewer heads.  One H1 launch
    a hop forward, one H3-dkv and one H3-dq a hop backward, ``sp`` hops.
    H1 reads ``config.block_q`` (its Q tile); H3 reads no field."""
    if scale is None:
        scale = 1.0 / math.sqrt(q_l.shape[3])
    return _RingFlashAttention.apply(q_l.contiguous(), k_l.contiguous(),
                                     v_l.contiguous(), group, scale, causal,
                                     h1_q_rows(config))


def ring_attention(
    q: torch.Tensor,               # [B, Hq, Lq, d]  (every rank: all of it)
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    mesh,
    axis_name: str = "sp",
    config: TileConfig = TileConfig(),
    scale: Optional[float] = None,
    causal: bool = False,
    batch_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
) -> torch.Tensor:
    """Ring attention on whole tensors, as the JAX package's
    ``ring_attention`` takes global arrays: each rank cuts its block (the
    sequence over ``axis_name``, and the batch and heads over
    ``batch_axis`` and ``head_axis`` when given: dp and tp on a 3-D mesh),
    runs :func:`ring_flash_attention` on it, and returns its block of the
    output, the shard JAX's sharded output holds on that device.
    Differentiable."""
    def local(x):
        x = shard(x, mesh, batch_axis, 0)
        x = shard(x, mesh, head_axis, 1)
        return shard(x, mesh, axis_name, 2)

    return ring_flash_attention(local(q), local(k), local(v),
                                mesh.get_group(axis_name), config, scale,
                                causal)
