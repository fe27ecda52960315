"""Attention backward of the port: kernels H3-dkv and H3-dq.

Counterpart of ``ops/attention_bwd.py:flash_attention_bwd`` in the JAX
package at static or traced positions, under its three masks: none,
causal, and a causal sliding window.  The JAX package picks one of three
kernel routes by a VMEM rule (fused B11; one-pass B12 + B13; tiled B14 +
B15), and all five kernels compute the same gradient, so the port has one
route on the card (``csrc/attention_bwd.cu``)::

    P  = exp2(s·scale·log2e − lse·log2e)   (0 where masked or lse = −inf)
    dV = Pᵀ dO    dP = dO Vᵀ    dS = P∘(dP − delta)·scale
    dQ = dS K     dK = dSᵀ Q

with delta = rowsum(dO∘O) in f32, reduced by torch outside the kernels, as
the JAX package does at ``:678``.  Layouts and the mask convention are
``ops/attention.py``'s; for GQA, dK and dV are summed over each q-head
group and come back ``[B, Hkv, Lkv, d]``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.configs import TileConfig
from exploring_flash_attention_tpu_torch.ops.attention import (
    LOG2E,
    NARROW_HEAD_DIM_RULE,
    DiagOff,
    _check_cuda_inputs,
    checked_window,
    hidden_keys,
    mask_args,
    mask_diagonal,
    narrow_head_dim,
)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor, scale: float, causal: bool = True,
                        diag_off: DiagOff = 0, window: Optional[int] = None
                        ) -> Grads:
    """Plain PyTorch version of H3 in f32 math: (dq, dk, dv) in the dtypes
    of q, k and v.

    The mask is :func:`~.attention.attention_plain`'s: non-causal rows see
    every key; causal row ``i`` sees key ``j`` iff ``j <= i + diag_off``;
    a ``window`` further needs ``j >= i + diag_off - window + 1``
    (``diag_off`` an int or a traced pair, ``ops/attention.py``).  P is
    recomputed from ``lse`` as ``_recompute_p`` does in the JAX package
    (``ops/attention_bwd.py:52-100``), and a row whose LSE is -inf (it sees
    no key) gets P = 0 and dS = 0 (``:98``, ``:189``).  delta comes from the
    given ``out``.  P and dS stay f32 here.  On the card the bf16 kernels
    round both to bf16 before their products, as the TPU kernels do in q's
    dtype; the f32 kernels keep them f32 (bf16x6 pieces, f32-accurate)."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    hidden = torch.isneginf(lse)[..., None]
    band = hidden_keys(lq, lkv, causal, diag_off, window, q.device)
    if band is not None:
        hidden = hidden | band
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    arg = s * (scale * LOG2E) - lse[..., None] * LOG2E
    p = torch.exp2(arg.masked_fill(hidden, float("-inf")))
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta) * scale).masked_fill(hidden, 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)

    def fold(x):                        # per-q-head partials -> GQA sum
        return x.view(b, hkv, group, lkv, d).sum(dim=2)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def _check_bwd_inputs(name: str, q, k, v, do, lse, delta) -> None:
    dtype = _check_cuda_inputs(name, name, q, k, v, do)
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    if (k.shape != (b, hkv, lkv, d) or v.shape != k.shape
            or do.shape != q.shape or hq % hkv or not narrow_head_dim(d)
            or lq == 0 or lkv == 0):
        raise ValueError(
            f"{name} takes q/do [B,Hq,Lq,d], k/v [B,Hkv,Lkv,d] with Hq % Hkv "
            f"== 0 and {NARROW_HEAD_DIM_RULE}; got q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, do {tuple(do.shape)}")
    for stat in (lse, delta):
        if (stat.device != q.device or stat.dtype != torch.float32
                or stat.shape != (b, hq, lq) or not stat.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous f32 "
                             f"[B, Hq, Lq] on {q.device}")


def _launch_args(q, k, scale, causal, diag_off, window):
    if window is not None and window < 1:
        raise ValueError(f"a window needs window >= 1, got {window}")
    b, hq, lq, d = q.shape
    return (b, hq, k.shape[1], lq, k.shape[2], d,
            *mask_args(causal, diag_off, window, q.device), scale,
            int(q.dtype == torch.float32), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)


def attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, scale: float, causal: bool = True,
                      diag_off: DiagOff = 0, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel H3-dkv on CUDA tensors: (dk, dv) [B, Hkv, Lkv, d] in
    the inputs' dtype, each summed over its GQA group in f32 inside the
    kernel, under the mask of :func:`attention_bwd_plain`.  Takes
    contiguous bf16 or f32 q/k/v/do at any d of
    ``ops.attention.NARROW_HEAD_DIM_RULE`` (a d below its instance runs on
    zero-filled columns: bf16 on 32, 64, 128 and 256, rows of d % 8 != 0
    loaded by the producer warpgroup instead of TMA; f32 bf16x6 on 64, 128
    and 256, the last a cluster of two blocks that split the columns), and
    f32 lse/delta [B, Hq, Lq], or raises.
    ``attention_bwd_dkv.launches`` counts launches."""
    _check_bwd_inputs("H3-dkv", q, k, v, do, lse, delta)
    args = _launch_args(q, k, scale, causal, diag_off, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = kernels.library().eft_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *args)
    kernels.check_launch(err, "H3-dkv")
    attention_bwd_dkv.launches += 1
    return dk, dv


attention_bwd_dkv.launches = 0


def attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, scale: float, causal: bool = True,
                     diag_off: DiagOff = 0, window: Optional[int] = None
                     ) -> torch.Tensor:
    """Launch kernel H3-dq on CUDA tensors: dq [B, Hq, Lq, d] in the
    inputs' dtype.  Takes what :func:`attention_bwd_dkv` takes (the same
    dtypes and head dims on the same instances), or raises.
    ``attention_bwd_dq.launches`` counts launches."""
    _check_bwd_inputs("H3-dq", q, k, v, do, lse, delta)
    args = _launch_args(q, k, scale, causal, diag_off, window)
    dq = torch.empty_like(q)
    err = kernels.library().eft_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args)
    kernels.check_launch(err, "H3-dq")
    attention_bwd_dq.launches += 1
    return dq


attention_bwd_dq.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    out: torch.Tensor,             # forward output [B, Hq, Lq, d]
    do: torch.Tensor,              # its cotangent, same shape
    lse: torch.Tensor,             # [B, Hq, Lq] f32, natural log, scale in
    config: TileConfig = TileConfig(),
    scale: Optional[float] = None,
    causal: bool = False,
    positions=None,
    static_positions: Optional[Tuple[int, int]] = None,
    window: Optional[int] = None,
) -> Grads:
    """Attention backward: (dq, dk, dv) in the dtypes and shapes of q, k
    and v.

    The mask is the JAX function's: none (``causal=False``, positions
    ignored); causal at ``static_positions`` (ints), which default to the
    decode convention ``(Lkv - Lq, 0)``, or at traced ``positions`` (0-d
    integer tensors, a sequence-parallel shard's offsets: B11-B15's traced
    form, read by H3 from device memory); or a causal ``window`` at either,
    as the JAX backward takes it.  A window of Lkv or more is plain causal;
    a window without ``causal``, or both kinds of positions, raise
    ``ValueError``.

    CPU tensors take :func:`attention_bwd_plain`.  CUDA tensors take H1's
    contract (contiguous bf16 or f32, any d of
    ``ops.attention.NARROW_HEAD_DIM_RULE``, any
    GQA group, any Lq and Lkv; f32 gradients at f32 accuracy): delta is
    reduced by torch, then kernels H3-dkv and H3-dq launch, or the call
    raises (``ValueError`` naming the rule for another d, ``TypeError``
    for another dtype, before any launch).  ``config`` is taken at the JAX
    package's place and not read: H3 fixes its own tiles."""
    lq, lkv = q.shape[2], k.shape[2]
    window = checked_window(causal, window, lkv)
    diag_off = mask_diagonal(lq, lkv, causal, positions, q.device,
                             static_positions)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return masked_attention_bwd(q, k, v, out, do, lse, scale, causal,
                                diag_off, window)


def masked_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, do: torch.Tensor,
                         lse: torch.Tensor, scale: float, causal: bool,
                         diag_off: DiagOff, window: Optional[int],
                         delta: Optional[torch.Tensor] = None) -> Grads:
    """:func:`flash_attention_bwd` after its argument checks, under a mask
    given as :func:`attention_bwd_plain` takes it: the plain version for CPU
    tensors, H3-dkv and H3-dq for CUDA tensors.  ``delta`` (rowsum(dO∘O),
    f32 [B, Hq, Lq]) is reduced here unless the caller has it (the ring
    reduces it once for all its hops)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, do, lse, scale, causal,
                                   diag_off, window)
    do = do.to(q.dtype)
    if delta is None:
        delta = (do.float() * out.float()).sum(dim=-1)
    mask = (scale, causal, diag_off, window)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, delta, *mask)
    dq = attention_bwd_dq(q, k, v, do, lse, delta, *mask)
    return dq, dk, dv
