"""Cross-rank split-KV attention: the V2 combine over ``torch.distributed``.

Counterpart of ``parallel/splitkv_xhost.py`` in the JAX package.  Q is
whole on every rank of the ``sp`` group and K/V are cut along the
sequence; each rank computes its shard's normalized partial (O, LSE) on
H1 and the combine runs as collectives instead of kernel H2:

    m   = max over ranks of lse            (all_reduce MAX)
    w   = exp(lse - m)                      (0 where lse = -inf)
    out = sum(w O) / sum(w)                 (two all_reduce SUMs)

The non-overlapped counterpart of the ring (``parallel/ring.py``); a
forward only, as the JAX package uses it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
)
from exploring_flash_attention_tpu_torch.parallel.mesh import (
    shard,
)


def splitkv_attention_xhost(
    q: torch.Tensor,               # [B, Hq, Lq, d]  (whole on every rank)
    k: torch.Tensor,               # [B, Hkv, Lkv, d] (every rank: all of it)
    v: torch.Tensor,
    mesh,
    axis_name: str = "sp",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention with K/V sequence-sharded over ``axis_name``: each rank
    takes its block of k and v, and every rank returns the whole output
    [B, Hq, Lq, d] in q's dtype (replicated over the axis, as JAX's)."""
    group = mesh.get_group(axis_name)
    o_p, lse = attention_partial_local(
        q.contiguous(), shard(k, mesh, axis_name, 2),
        shard(v, mesh, axis_name, 2), scale)
    m = lse.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    m = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.where(torch.isneginf(lse), 0.0, torch.exp(lse - m))
    num = o_p * w[..., None]
    dist.all_reduce(num, group=group)
    dist.all_reduce(w, group=group)
    return (num / torch.where(w == 0.0, 1.0, w)[..., None]).to(q.dtype)
