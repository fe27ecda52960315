"""Causal attention of the port: the forward on kernel H1, differentiable.

Counterparts of ``parallel/partials.py:attention_partial_local`` (the causal
static-positions route) and of ``ops/attention_vjp.py:flash_attention`` in
the JAX package, whose backward is ``ops/attention_bwd.py`` (H3).  Layouts are
the JAX package's: q ``[B, Hq, Lq, d]``, k/v ``[B, Hkv, Lkv, d]``, q head
``h`` reading KV head ``h // (Hq / Hkv)``.

Causal masking uses the decode convention: q row ``i`` sits at global
position ``q_pos0 + i`` and key ``j`` at ``kv_pos0 + j``; the default
positions ``(Lkv - Lq, 0)`` make the q rows the last Lq positions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from exploring_flash_attention_tpu_torch import kernels


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, diag_off: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of H1 in f32 math (f64 for f64 inputs): (o
    [B,H,Lq,d] normalized, lse [B,H,Lq] natural log, scale included).  Row
    ``i`` sees key ``j`` iff ``j <= i + diag_off``; a row that sees nothing
    gives (0, -inf)."""
    group = q.shape[1] // k.shape[1]
    lq, lkv = q.shape[2], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct).repeat_interleave(group, dim=1)
    vf = v.to(ct).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kf) * scale
    row = torch.arange(lq, device=q.device)[:, None]
    col = torch.arange(lkv, device=q.device)[None, :]
    s = s.masked_fill(col > row + diag_off, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    shift = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - shift[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p, vf), lse


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, diag_off: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward: (o in q.dtype, lse f32 [B, Hq, Lq]).

    CPU tensors take :func:`causal_attention_plain`.  CUDA tensors launch
    kernel H1 (``csrc/prefill_attention.cu``), which takes contiguous bf16
    q/k/v with d in {64, 128}, or raise.  ``prefill_attention.launches``
    counts kernel launches."""
    if q.device.type == "cpu":
        o, lse = causal_attention_plain(q, k, v, scale, diag_off)
        return o.to(q.dtype), lse
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    _check_cuda_inputs("H1 prefill attention", q, k, v)
    if (k.shape != (b, hkv, lkv, d) or v.shape != k.shape
            or hq % hkv or d not in (64, 128) or lq == 0 or lkv == 0):
        raise ValueError(
            f"H1 takes q [B,Hq,Lq,d], k/v [B,Hkv,Lkv,d] with Hq % Hkv == 0 "
            f"and d in (64, 128); got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    err = kernels.library().eft_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, lq, lkv, d, diag_off, scale,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H1 prefill attention")
    prefill_attention.launches += 1
    return o, lse


prefill_attention.launches = 0


def _check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")


def _require_static(positions) -> None:
    """Static positions are Python or NumPy ints, as the JAX package's
    ``ops/attention_vjp.py:65`` reads them; anything else is traced."""
    if not all(isinstance(p, (int, np.integer)) for p in positions):
        raise NotImplementedError("only static (int) positions are ported")


def _diag_offset(lq: int, lkv: int,
                 static_positions: Optional[Tuple[int, int]]) -> int:
    q_pos0, kv_pos0 = static_positions or (lkv - lq, 0)
    return int(q_pos0) - int(kv_pos0)


def _ported_diag_offset(lq: int, lkv: int, causal: bool,
                        static_positions: Optional[Tuple[int, int]],
                        window: Optional[int]) -> int:
    """The argument checks that ``flash_attention`` and
    ``flash_attention_bwd`` share; returns the static diagonal offset.

    A window of Lkv or more is plain causal, as in the JAX package; a
    narrower one raises ``NotImplementedError``, a window without ``causal``
    ``ValueError``.  Non-causal attention and traced positions raise
    ``NotImplementedError``."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < lkv:
            raise NotImplementedError("windowed attention is not ported yet")
    if not causal:
        raise NotImplementedError("non-causal attention is not ported yet")
    if static_positions is not None:
        _require_static(static_positions)
    return _diag_offset(lq, lkv, static_positions)


def attention_partial_local(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = True,
    static_positions: Optional[Tuple[int, int]] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized causal partial attention over a local KV shard:
    (o f32 [B,H,Lq,d], lse f32 [B,H,Lq]).  Only the causal route with
    static positions is ported; the kernel fixes its own tiles, so the JAX
    signature's ``config`` is not taken."""
    if not causal or window is not None:
        raise NotImplementedError(
            "only causal attention without a window is ported")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    o, lse = prefill_attention(
        q, k, v, scale, _diag_offset(q.shape[2], k.shape[2], static_positions))
    return o.float(), lse


class _FlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash_attention_static`` in the JAX package
    (``ops/attention_vjp.py:83-126``): the forward is :func:`prefill_attention`
    (H1 on the card), which saves ``(q, k, v, out, lse)`` as ``_fwd_static``
    does; the backward is ``flash_attention_bwd`` (H3-dkv and H3-dq)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, diag_off: int):
        out, lse = prefill_attention(q, k, v, scale, diag_off)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.diag_off = scale, diag_off
        return out

    @staticmethod
    def backward(ctx, do):
        # local import: ops.attention_bwd imports this module
        from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
            causal_attention_bwd,
        )
        q, k, v, out, lse = ctx.saved_tensors
        # autograd hands dO over as a permuted view (out of the
        # "bhld,hde->ble" einsum); the kernels take contiguous rows
        dq, dk, dv = causal_attention_bwd(
            q, k, v, out, do.contiguous(), lse, ctx.scale, ctx.diag_off)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    positions: Optional[Tuple[int, int]] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The JAX package's ``flash_attention``, differentiable: o in q.dtype.

    Only causal attention with static positions (Python or NumPy ints, or
    the default decode convention) is ported.  A window of Lkv or more is
    plain causal, as in the JAX package; a narrower one raises
    ``NotImplementedError`` and a window without ``causal`` ``ValueError``.
    The backward runs H3; where autograd records nothing (no grad mode, or
    no input that requires grad) the call is the forward alone."""
    diag_off = _ported_diag_offset(q.shape[2], k.shape[2], causal, positions,
                                   window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale, diag_off)
