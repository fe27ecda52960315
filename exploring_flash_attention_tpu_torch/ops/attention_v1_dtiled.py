"""The d-tiled attention forward for large head dims, on kernel H5.

Counterpart of ``flash_attention_v1_dtiled`` (``ops/attention_v1_dtiled.py:191``)
in the JAX package, whose TPU kernel B19 accumulates S over d-chunks of Q
and K, runs the online softmax on the f32 S and accumulates P V chunk by
chunk into a full-width f32 O.  Here a call is one launch of H5
(``csrc/dtiled_attention.cu``), whose warpgroups each hold 128 of O's
columns.  K and V are bf16, or both int8 or e4m3
:class:`~.quant.QuantizedTensor`s, whose K scale folds into the softmax
constant and whose V scale rides P.  Layout [B, H, L, d], non-causal.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.ops.attention import (
    LOG2E,
    _check_cuda_inputs,
    attention_plain,
)
from exploring_flash_attention_tpu_torch.ops.attention_kvquant import (
    attention_kvquant_plain,
)
from exploring_flash_attention_tpu_torch.ops.quant import (
    FP8_DTYPE,
    KV_KIND,
    QuantizedTensor,
    check_blocks,
    check_cuda_quantized,
)

H5_D_CHUNK = 128         # one consumer warpgroup's O columns
H5_MAX_D = 512           # four consumer warpgroups and a producer

KV = Union[torch.Tensor, QuantizedTensor]


def attention_dtiled_plain(q: torch.Tensor, k: KV, v: KV,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version of H5: attention in f32 math (f64 for f64 q)
    over K and V, dequantized where they are quantized."""
    if isinstance(k, QuantizedTensor):
        return attention_kvquant_plain(q, k, v, scale)
    return attention_plain(q, k, v, scale, causal=False)[0]


def flash_attention_v1_dtiled(
    q: torch.Tensor,               # [B, H, Lq, d]
    k: KV,                         # [B, H, Lkv, d] or its QuantizedTensor
    v: KV,
    scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """d-tiled fused attention forward: o [B, H, Lq, d] in ``out_dtype``
    or q.dtype; the default scale is ``1/sqrt(d)``.

    As in the JAX package, k and v are both quantized or neither
    (``ValueError``), and quantized K and V share one block.  Dropped, as
    TPU tile rules: "L divisible by blocks", "d divisible by the d tiles"
    and "quant block == block_kv" (``attention_v1_dtiled.py:225,230,275``);
    the kernel masks ragged L and reads the scales per key,
    ``scales[key // block]``.  Neither ``config`` nor ``interpret`` is
    taken.

    CPU tensors take :func:`attention_dtiled_plain`.  CUDA tensors launch
    H5 once per call, or raise: it takes contiguous bf16 q (and bf16 K/V
    unless quantized) with d a multiple of 128 up to 512, and writes bf16
    or f32 O.  ``flash_attention_v1_dtiled.launches`` counts kernel
    launches."""
    quantized = isinstance(k, QuantizedTensor)
    if quantized != isinstance(v, QuantizedTensor):
        raise ValueError("quantize both k and v or neither")
    kv, vv = (k.values, v.values) if quantized else (k, v)
    b, h, lq, d = q.shape
    lkv = kv.shape[2]
    if kv.shape != (b, h, lkv, d) or vv.shape != kv.shape:
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} "
                         f"k={tuple(kv.shape)} v={tuple(vv.shape)}")
    block = check_blocks(lkv, k, v) if quantized else 0
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return attention_dtiled_plain(q, k, v, scale).to(out_dtype)
    if quantized:
        _check_cuda_inputs("H5 attention", q)
        check_cuda_quantized("H5 attention", q.device,
                             (torch.int8, FP8_DTYPE), k, v)
        ks, vs, n_blocks = k.scales, v.scales, k.scales.shape[2]
    else:
        _check_cuda_inputs("H5 attention", q, k, v)
        ks = vs = None
        n_blocks = 0
    if d % H5_D_CHUNK or d > H5_MAX_D or lq == 0 or lkv == 0:
        raise ValueError(f"H5 takes d a multiple of {H5_D_CHUNK} up to "
                         f"{H5_MAX_D} and nonempty sequences; got q "
                         f"{tuple(q.shape)}, Lkv {lkv}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"H5 writes bf16 or f32 O, not {out_dtype}")
    o = torch.empty((b, h, lq, d), dtype=out_dtype, device=q.device)
    err = kernels.library().eft_dtiled_attention(
        q.data_ptr(), kv.data_ptr(), vv.data_ptr(),
        ks.data_ptr() if quantized else None,
        vs.data_ptr() if quantized else None, o.data_ptr(), b, h, lq, lkv, d,
        block, n_blocks, KV_KIND[kv.dtype], int(out_dtype == torch.float32),
        scale * LOG2E, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H5 attention")
    flash_attention_v1_dtiled.launches += 1
    return o


flash_attention_v1_dtiled.launches = 0
