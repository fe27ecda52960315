"""Fully-int8 attention (int8 Q, K and V), on kernel H4-int8.

Counterpart of ``flash_attention_int8`` (``ops/attention_int8.py:129``) in
the JAX package, whose TPU kernel B18 runs ``S = Q_i8 K_i8^T`` in int32
with the q, k and softmax scales folded into the exp2 argument, a one-pass
softmax (m over every key, l from the f32 p), and P V in bf16
(``pv_mode="bf16"``) or in int8 with ``p_i8 = round(p * 127)``
(``pv_mode="int8"``).  Here a call is one launch of H4-int8
(``csrc/int8_attention.cu``) at the head dims of
:data:`~.attention.SERVING_HEAD_DIM_RULE` (instances D 64, 128 and 256,
:func:`~.attention.h4_instance`).  Layout [B, H, L, d], non-causal, no
GQA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.configs import TileConfig
from exploring_flash_attention_tpu_torch.ops.attention import (
    LOG2E,
    SERVING_HEAD_DIM_RULE,
    kernel_head_dim,
)
from exploring_flash_attention_tpu_torch.ops.quant import (
    QuantizedTensor,
    _expand,
    check_blocks,
    check_cuda_quantized,
)

PV_MODES = ("bf16", "int8")


def attention_int8_plain(q_q: QuantizedTensor, k_q: QuantizedTensor,
                         v_q: QuantizedTensor, scale: float,
                         pv_mode: str = "bf16") -> torch.Tensor:
    """Plain PyTorch version of H4-int8, with B18's roundings: f32 o
    [B, H, Lq, d].

    The int8 products are exact in f32 (|sum| <= 127^2 * d < 2^24 for
    d <= 1040, and likewise over a kv block of up to 1040 keys in int8
    mode).  The exp2 argument is ``s_i32 * ((q_scale * k_scale) *
    f32(scale * log2e))`` as at ``attention_int8.py:88``; P is rounded to
    bf16, or to ``round(p * 127)`` half to even; each kv block's P V is
    scaled by its v_scale (times f32(1/127) in int8 mode) and the blocks
    are summed; l sums the f32 p."""
    shape_q, shape_k = q_q.values.shape, k_q.values.shape
    qs = _expand(q_q.scales, shape_q, q_q.block)          # [B, H, Lq, 1]
    ks = _expand(k_q.scales, shape_k, k_q.block)[..., 0]  # [B, H, Lkv]
    s = torch.einsum("bhqd,bhkd->bhqk", q_q.values.float(),
                     k_q.values.float())
    cc = (qs * ks[:, :, None, :]) * torch.tensor(scale * LOG2E,
                                                 dtype=torch.float32)
    s = s * cc
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if pv_mode == "int8":
        p_lp = torch.round(p * 127.0)
        pv_scale = torch.tensor(1.0 / 127.0, dtype=torch.float32)
    else:
        p_lp = p.bfloat16().float()
        pv_scale = torch.tensor(1.0, dtype=torch.float32)
    v = v_q.values.float()
    vs = v_q.scales * pv_scale                             # [B, H, nb]
    out = torch.zeros(p.shape[:-1] + (v.shape[-1],), dtype=torch.float32,
                      device=p.device)
    block = v_q.block
    for i, k0 in enumerate(range(0, shape_k[2], block)):
        pv = torch.einsum("bhqk,bhkd->bhqd", p_lp[..., k0:k0 + block],
                          v[:, :, k0:k0 + block])
        out += pv * vs[:, :, i, None, None]
    return out / torch.where(l == 0, 1.0, l)


def flash_attention_int8(
    q_q: QuantizedTensor,          # int8 [B, H, Lq, d] + per-Lq-block scales
    k_q: QuantizedTensor,          # int8 [B, H, Lkv, d]
    v_q: QuantizedTensor,
    config: TileConfig = TileConfig(),
    scale: Optional[float] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    pv_mode: str = "bf16",         # "bf16" (accurate) | "int8" (fastest)
) -> torch.Tensor:
    """Fully-int8 fused attention forward: o [B, H, Lq, d] in
    ``out_dtype``; the default scale is ``1/sqrt(d)``.

    As in the JAX package, K and V quant blocks must match (``ValueError``);
    each quantized tensor must carry cdiv(L, block) scales, and
    ``pv_mode`` is "bf16" or "int8" (``ValueError`` otherwise; JAX reads
    any other value as "bf16").  Dropped: JAX's ``q_q.block == block_q``
    (``attention_int8.py:152``), a TPU tile rule, since the port reads
    each row's Q scale as ``scales[row // q_q.block]``.  ``config`` is
    taken at the JAX package's place and not read: H4-int8 fixes its own
    tiles.

    CPU tensors take :func:`attention_int8_plain`.  CUDA tensors launch
    H4-int8 once per call, or raise: it takes contiguous int8 values with
    :data:`~.attention.SERVING_HEAD_DIM_RULE` and a kv block that is a
    multiple of 16, and writes bf16 or f32 O; the scale is the caller's or
    1/sqrt of the true d, whatever instance runs it.
    ``flash_attention_int8.launches`` counts kernel launches."""
    if pv_mode not in PV_MODES:
        raise ValueError(f"pv_mode must be one of {PV_MODES}, got {pv_mode!r}")
    b, h, lq, d = q_q.values.shape
    lkv = k_q.values.shape[2]
    if (k_q.values.shape != (b, h, lkv, d)
            or v_q.values.shape != k_q.values.shape):
        raise ValueError(f"shape mismatch: q={tuple(q_q.shape)} "
                         f"k={tuple(k_q.shape)} v={tuple(v_q.shape)}")
    block = check_blocks(lkv, k_q, v_q)
    check_blocks(lq, q_q)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q_q.values.device
    if dev.type == "cpu":
        return attention_int8_plain(q_q, k_q, v_q, scale, pv_mode
                                    ).to(out_dtype)
    check_cuda_quantized("H4-int8 attention", dev, (torch.int8,),
                         q_q, k_q, v_q)
    if not kernel_head_dim(d) or block % 16 or lq == 0 or lkv == 0:
        raise ValueError(f"H4-int8 takes {SERVING_HEAD_DIM_RULE}, a kv "
                         f"block that is a multiple of 16 and nonempty "
                         f"sequences; got q "
                         f"{tuple(q_q.shape)}, Lkv {lkv}, block {block}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"H4-int8 writes bf16 or f32 O, not {out_dtype}")
    o = torch.empty((b, h, lq, d), dtype=out_dtype, device=dev)
    err = kernels.library().eft_int8_attention(
        q_q.values.data_ptr(), k_q.values.data_ptr(), v_q.values.data_ptr(),
        q_q.scales.data_ptr(), k_q.scales.data_ptr(), v_q.scales.data_ptr(),
        o.data_ptr(), b, h, lq, lkv, d, q_q.block, q_q.scales.shape[2],
        block, k_q.scales.shape[2], int(pv_mode == "int8"),
        int(out_dtype == torch.float32), scale * LOG2E, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "H4-int8 attention")
    flash_attention_int8.launches += 1
    return o


flash_attention_int8.launches = 0
