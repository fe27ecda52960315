"""Attention over a quantized K/V, on kernel H4-kvq.

Counterpart of ``flash_attention_kvquant`` (``ops/attention_kvquant.py:176``)
in the JAX package, which picks between two TPU kernels (B16 streaming, B17
one pass) by a VMEM rule.  Here a call is one launch: of H4-kvq
(``csrc/kvquant_attention.cu``) at the head dims of
:data:`~.attention.NARROW_HEAD_DIM_RULE` (instances D 64, 128 and 256,
:func:`~.attention.h4_instance`), of H5's quantized form
(``csrc/dtiled_attention.cuh``, through
:func:`~.attention_v1_dtiled.flash_attention_v1_dtiled`) past 256 up to
2048 (:func:`kvquant_kernel`).  Q is bf16 or f32 (any float dtype on the
CPU); K and V are int8 or e4m3 :class:`~.quant.QuantizedTensor`s with one
scale per ``block`` keys.  Layout [B, H, L, d], non-causal, no GQA.  f32 q
runs on the kernel's f32 form, as B16 and B17 compute in q's dtype: the
codes exact, q and P * v_scale each three bf16 pieces (bf16x3).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.configs import TileConfig
from exploring_flash_attention_tpu_torch.ops.attention import (
    H5_HEAD_DIM_RULE,
    LOG2E,
    NARROW_HEAD_DIM_RULE,
    _check_cuda_inputs,
    attention_plain,
    narrow_head_dim,
)
from exploring_flash_attention_tpu_torch.ops.quant import (
    FP8_DTYPE,
    KV_KIND,
    QuantizedTensor,
    check_blocks,
    check_cuda_quantized,
    dequantize,
)


def kvquant_kernel(d: int) -> str:
    """The kernel a CUDA call of :func:`flash_attention_kvquant` at head dim
    ``d`` launches: "H4-kvq" for :data:`~.attention.NARROW_HEAD_DIM_RULE`,
    "H5" (its quantized form) past 256 within
    :data:`~.attention.H5_HEAD_DIM_RULE`.  ``ValueError`` for any other d,
    naming both rules."""
    if narrow_head_dim(d):
        return "H4-kvq"
    if 256 < d <= 2048:
        return "H5"
    raise ValueError(f"H4-kvq takes {NARROW_HEAD_DIM_RULE}, and H5 past it "
                     f"{H5_HEAD_DIM_RULE}; got d={d}")


def attention_kvquant_plain(q: torch.Tensor, k_q: QuantizedTensor,
                            v_q: QuantizedTensor, scale: float
                            ) -> torch.Tensor:
    """Plain PyTorch version of H4-kvq: attention in f32 math (f64 for f64
    q) over the dequantized K and V, o [B, H, Lq, d]."""
    ct = torch.promote_types(q.dtype, torch.float32)
    return attention_plain(q, dequantize(k_q, ct), dequantize(v_q, ct),
                           scale, causal=False)[0]


def flash_attention_kvquant(
    q: torch.Tensor,               # [B, H, Lq, d]
    k_q: QuantizedTensor,          # int8 or e4m3 [B, H, Lkv, d] + scales
    v_q: QuantizedTensor,
    config: TileConfig = TileConfig(),
    scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Fused attention over a quantized KV: o [B, H, Lq, d] in
    ``out_dtype`` or q.dtype; the default scale is ``1/sqrt(d)``.

    As in the JAX package, K and V quant blocks must match and each must
    carry cdiv(Lkv, block) scales (``ValueError``).  ``config`` is taken at
    the JAX package's place and not read: H4-kvq fixes its own tiles.

    CPU tensors take :func:`attention_kvquant_plain`.  CUDA tensors launch
    one kernel per call, or raise: contiguous bf16 or f32 q
    (``ops.attention.KERNEL_DTYPES``), K and V both int8 or both e4m3, bf16
    or f32 O, and d by :func:`kvquant_kernel`: H4-kvq up to 256, counted by
    ``flash_attention_kvquant.launches``; H5 past it, counted by
    ``flash_attention_v1_dtiled.launches``.  The scale is the caller's or
    1/sqrt of the true d, whatever instance runs it."""
    b, h, lq, d = q.shape
    lkv = k_q.values.shape[2]
    if k_q.values.shape != (b, h, lkv, d) or v_q.values.shape != \
            k_q.values.shape:
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} "
                         f"k={tuple(k_q.shape)} v={tuple(v_q.shape)}")
    block = check_blocks(lkv, k_q, v_q)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return attention_kvquant_plain(q, k_q, v_q, scale).to(out_dtype)
    q_dtype = _check_cuda_inputs("H4-kvq", "H4-kvq attention", q)
    check_cuda_quantized("H4-kvq attention", q.device,
                         (torch.int8, FP8_DTYPE), k_q, v_q)
    if kvquant_kernel(d) == "H5":
        from exploring_flash_attention_tpu_torch.ops.attention_v1_dtiled \
            import flash_attention_v1_dtiled
        return flash_attention_v1_dtiled(q, k_q, v_q, scale=scale,
                                         out_dtype=out_dtype)
    if lq == 0 or lkv == 0:
        raise ValueError(f"H4-kvq takes nonempty sequences; got q "
                         f"{tuple(q.shape)}, Lkv {lkv}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"H4-kvq writes bf16 or f32 O, not {out_dtype}")
    o = torch.empty((b, h, lq, d), dtype=out_dtype, device=q.device)
    err = kernels.library().eft_kvquant_attention(
        q.data_ptr(), k_q.values.data_ptr(), v_q.values.data_ptr(),
        k_q.scales.data_ptr(), v_q.scales.data_ptr(), o.data_ptr(), b, h, lq,
        lkv, d, block, k_q.scales.shape[2], KV_KIND[k_q.dtype],
        int(out_dtype == torch.float32), scale * LOG2E,
        int(q_dtype == torch.float32), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H4-kvq attention")
    flash_attention_kvquant.launches += 1
    return o


flash_attention_kvquant.launches = 0
