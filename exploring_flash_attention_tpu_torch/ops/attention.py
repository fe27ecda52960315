"""Attention of the port on kernel H1: the partial, and the differentiable
call (no mask, causal or a causal window).

Counterparts of ``parallel/partials.py:attention_partial_local`` (its
static-positions routes) and ``merge_partials``, and of
``ops/attention_vjp.py:flash_attention`` in
the JAX package, whose backward is ``ops/attention_bwd.py`` (H3);
``ops/attention_v1.py`` holds ``flash_attention_v1`` on the same kernel.
Layouts are the JAX package's: q ``[B, Hq, Lq, d]``, k/v
``[B, Hkv, Lkv, d]``, q head ``h`` reading KV head ``h // (Hq / Hkv)``.

Causal and window masking use the decode convention: q row ``i`` sits at
global position ``q_pos0 + i`` and key ``j`` at ``kv_pos0 + j``; the
default positions ``(Lkv - Lq, 0)`` make the q rows the last Lq positions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from exploring_flash_attention_tpu_torch import kernels

LOG2E = math.log2(math.e)      # the kernels' exp2 basis: scale * LOG2E


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True, diag_off: int = 0,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of H1 in f32 math (f64 for f64 inputs): (o
    [B,H,Lq,d] normalized, lse [B,H,Lq] natural log, scale included).

    Non-causal rows see every key.  Causal row ``i`` sees key ``j`` iff
    ``j <= i + diag_off``; a ``window`` (causal only, inclusive) further
    needs ``j >= i + diag_off - window + 1``.  A row that sees nothing
    gives (0, -inf)."""
    group = q.shape[1] // k.shape[1]
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct).repeat_interleave(group, dim=1)
    vf = v.to(ct).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kf) * scale
    hidden = hidden_keys(q.shape[2], k.shape[2], causal, diag_off, window,
                         q.device)
    if hidden is not None:
        s = s.masked_fill(hidden, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    shift = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - shift[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p, vf), lse


def hidden_keys(lq: int, lkv: int, causal: bool, diag_off: int,
                window: Optional[int], device: torch.device
                ) -> Optional[torch.Tensor]:
    """The mask of :func:`attention_plain`: [Lq, Lkv] bool, True where q row
    ``i`` does not see key ``j``; None without a mask (non-causal)."""
    if not causal:
        return None
    last = torch.arange(lq, device=device)[:, None] + diag_off
    col = torch.arange(lkv, device=device)[None, :]
    hidden = col > last
    if window is not None:
        hidden |= col < last - window + 1
    return hidden


H1_HEAD_DIMS = (32, 64, 128)
H1_TILE = 128                   # Q rows per block and keys per K/V tile; a
                                # KV span is whole tiles
_MASK_NONE, _MASK_CAUSAL, _MASK_WINDOW = 0, 1, 2      # csrc enum Mask


def mask_args(causal: bool, diag_off: int, window: Optional[int]
              ) -> Tuple[int, int, int]:
    """(mask, diag_off, window) as the kernels' C entries take them (H1,
    H3): the csrc ``Mask`` code, and both ints checked to fit 32 bits."""
    if not all(-2 ** 31 <= int(x) < 2 ** 31 for x in (diag_off, window or 0)):
        raise ValueError(f"diag_off {diag_off} and window {window} must "
                         "fit in 32 bits")
    mask = (_MASK_NONE if not causal
            else _MASK_CAUSAL if window is None else _MASK_WINDOW)
    return mask, int(diag_off), int(window or 0)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, diag_off: int = 0, causal: bool = True,
                      window: Optional[int] = None,
                      out_dtype: Optional[torch.dtype] = None,
                      with_lse: bool = True, kv_span: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention forward: (o in ``out_dtype`` or q.dtype, lse f32
    [B, Hq, Lq] or None without ``with_lse``).  The mask is none, causal
    at ``diag_off``, or a causal ``window`` (see :func:`attention_plain`);
    a window that holds every key the causal rows see is plain causal.

    With ``kv_span`` the KV is cut into nkb = cdiv(Lkv, kv_span) spans and
    both outputs gain a span axis: o [B, Hq, nkb, Lq, d] normalized over
    each span and lse [B, Hq, nkb, Lq] of each span, the partials that
    ``splitkv_combine`` merges.  The plain path takes any positive span;
    H1 takes whole 128-key tiles.

    CPU tensors take :func:`attention_plain`.  CUDA tensors launch kernel
    H1 (``csrc/prefill_attention.cu``), once per call, or raise: it takes
    contiguous bf16 q/k/v with d in {32, 64, 128} and writes bf16 or f32
    O.  ``prefill_attention.launches`` counts kernel launches."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    out_dtype = out_dtype or q.dtype
    if window is not None:
        if not causal or window < 1:
            raise ValueError(f"a window needs causal=True and window >= 1, "
                             f"got causal={causal}, window={window}")
        if window >= lq + diag_off:     # the last row sees keys 0..window-1
            window = None
    if kv_span is not None and kv_span <= 0:
        raise ValueError(f"kv_span must be positive, got {kv_span}")
    if q.device.type == "cpu":
        if kv_span is None:
            o, lse = attention_plain(q, k, v, scale, causal, diag_off, window)
        else:
            parts = [attention_plain(q, k[:, :, s:s + kv_span],
                                     v[:, :, s:s + kv_span], scale, causal,
                                     diag_off - s, window)
                     for s in range(0, lkv, kv_span)]
            o = torch.stack([p[0] for p in parts], dim=2)
            lse = torch.stack([p[1] for p in parts], dim=2)
        return o.to(out_dtype), lse if with_lse else None
    _check_cuda_inputs("H1 attention", q, k, v)
    if (k.shape != (b, hkv, lkv, d) or v.shape != k.shape
            or hq % hkv or d not in H1_HEAD_DIMS or lq == 0 or lkv == 0):
        raise ValueError(
            f"H1 takes q [B,Hq,Lq,d], k/v [B,Hkv,Lkv,d] with Hq % Hkv == 0 "
            f"and d in {H1_HEAD_DIMS}; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"H1 writes bf16 or f32 O, not {out_dtype}")
    if kv_span is not None and kv_span % H1_TILE:
        raise ValueError(
            f"H1 takes a kv_span that is a multiple of {H1_TILE} keys (whole "
            f"K/V tiles); got kv_span={kv_span} for q {tuple(q.shape)} and "
            f"k/v {tuple(k.shape)}")
    mask = mask_args(causal, diag_off, window)
    nkb = 1 if kv_span is None else -(-lkv // kv_span)
    if nkb > 65535:
        raise ValueError(f"{nkb} KV spans exceed the grid's 65535")
    rows = (b, hq, lq) if kv_span is None else (b, hq, nkb, lq)
    o = torch.empty((*rows, d), dtype=out_dtype, device=q.device)
    lse = (torch.empty(rows, dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = kernels.library().eft_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None, b, hq, hkv, lq, lkv, d, *mask,
        int(kv_span or 0),
        int(out_dtype == torch.float32), scale, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H1 attention")
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


def _ported_mask(lq: int, lkv: int, causal: bool,
                 static_positions: Optional[Tuple[int, int]],
                 window: Optional[int]) -> Tuple[int, Optional[int]]:
    """The argument checks that ``flash_attention`` and
    ``flash_attention_bwd`` share, as the JAX package makes them
    (``ops/attention_vjp.py:57-69``, ``ops/attention_bwd.py:629-635``):
    returns the static diagonal offset and the window.

    A window without ``causal`` raises ``ValueError``; a window of Lkv or
    more is plain causal (None).  Non-causal attention ignores the
    positions.  Traced positions raise ``NotImplementedError``."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window >= lkv:
            window = None           # the band covers every key: causal
    if static_positions is not None:
        _require_static(static_positions)
    return _diag_offset(lq, lkv, static_positions), window


def attention_partial_local(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    static_positions: Optional[Tuple[int, int]] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized partial attention over a local KV shard: (o f32
    [B,H,Lq,d], lse f32 [B,H,Lq]), O written in f32 by H1 on the card.

    Non-causal; causal at static positions; or a causal ``window`` at the
    decode-convention positions, as ``parallel/partials.py:46-81`` routes
    it (a window of Lkv or more is plain causal, any other positions raise
    ``NotImplementedError``).  Traced positions are not ported, and the
    kernel fixes its own tiles, so the JAX signature's ``config`` is not
    taken."""
    lq, lkv = q.shape[2], k.shape[2]
    if window is not None and not causal:
        raise NotImplementedError(
            "window requires causal=True with static positions")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if static_positions is not None:
        _require_static(static_positions)
    if window is not None and window >= lkv:
        window = None               # the band covers every key: causal
    if window is not None and static_positions is not None and tuple(
            int(p) for p in static_positions) != (lkv - lq, 0):
        raise NotImplementedError(
            "windowed partial attention needs decode-convention positions; "
            f"got Lq={lq}, Lkv={lkv}, positions={static_positions}")
    return prefill_attention(
        q, k, v, scale, _diag_offset(lq, lkv, static_positions), causal,
        window, out_dtype=torch.float32)


def merge_partials(
    o_a: torch.Tensor, lse_a: torch.Tensor,      # [..., Lq, d], [..., Lq]
    o_b: torch.Tensor, lse_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Associative merge of two normalized partials: (o, lse) of attention
    over the union of the two KV sets.  The identity is (0, -inf).  The
    JAX package's formula (``parallel/partials.py:108-128``), operation for
    operation; plain PyTorch on any device."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w_a = torch.where(torch.isneginf(lse_a), 0.0, torch.exp(lse_a - m_safe))
    w_b = torch.where(torch.isneginf(lse_b), 0.0, torch.exp(lse_b - m_safe))
    denom = w_a + w_b
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = (o_a * (w_a / denom_safe)[..., None]
         + o_b * (w_b / denom_safe)[..., None])
    lse = m + torch.log(denom_safe)
    lse = torch.where(denom == 0.0, float("-inf"), lse)
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash_attention_static`` in the JAX package
    (``ops/attention_vjp.py:83-126``): the forward is :func:`prefill_attention`
    (H1 on the card), which saves ``(q, k, v, out, lse)`` as ``_fwd_static``
    does; the backward is ``flash_attention_bwd`` (H3-dkv and H3-dq) under
    the same mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, diag_off: int,
                window: Optional[int]):
        out, lse = prefill_attention(q, k, v, scale, diag_off, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (scale, causal, diag_off, window)
        return out

    @staticmethod
    def backward(ctx, do):
        # local import: ops.attention_bwd imports this module
        from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
            masked_attention_bwd,
        )
        q, k, v, out, lse = ctx.saved_tensors
        # autograd hands dO over as a permuted view (out of the
        # "bhld,hde->ble" einsum); the kernels take contiguous rows
        dq, dk, dv = masked_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                          *ctx.mask)
        return dq, dk, dv, None, None, None, None


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

    Non-causal, causal at static positions (Python or NumPy ints, or the
    default decode convention), or a causal ``window`` at the decode
    convention's positions: JAX's forward takes a band only there
    (``parallel/partials.py:63-76``), and so does the port, which raises
    ``NotImplementedError`` for other positions.  A window of Lkv or more is
    plain causal; a window without ``causal`` raises ``ValueError``; traced
    positions raise ``NotImplementedError``.  The backward runs H3 under the
    same mask; where autograd records nothing (no grad mode, or no input
    that requires grad) the call is the forward alone."""
    lq, lkv = q.shape[2], k.shape[2]
    diag_off, window = _ported_mask(lq, lkv, causal, positions, window)
    if window is not None and positions is not None and tuple(
            int(p) for p in positions) != (lkv - lq, 0):
        raise NotImplementedError(
            "windowed attention needs decode-convention positions; got "
            f"Lq={lq}, Lkv={lkv}, positions={positions}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale, causal, diag_off,
                                 window)
