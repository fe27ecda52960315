"""The split-KV merge of the port, on kernel H2.

Counterpart of ``splitkv_combine`` (``ops/attention_v2_splitkv.py:619``)
in the JAX package.  The partials it merges come from kernel H1's span
mode (``prefill_attention(..., kv_span=)``): per KV span, an O normalized
over the span and the span's natural-log LSE.
"""

from __future__ import annotations

from typing import Optional

import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.ops.attention import H1_HEAD_DIMS


def splitkv_combine_plain(o_partials: torch.Tensor, lses: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of H2 in f32 (f64 for f64 partials):
    ``O = sum_k w_k O_k`` with ``w = softmax_k(lse_k)``; a row whose
    partials all have LSE -inf gives 0 (``_combine_kernel``,
    ``ops/attention_v2_splitkv.py:330``)."""
    ct = torch.promote_types(o_partials.dtype, torch.float32)
    lse = lses.to(ct)
    m = lse.max(dim=2, keepdim=True).values
    w = torch.exp(lse - torch.where(torch.isneginf(m), 0.0, m))
    den = w.sum(dim=2, keepdim=True)
    w = w / torch.where(den == 0, 1.0, den)
    return (o_partials.to(ct) * w[..., None]).sum(dim=2)


def splitkv_combine(
    o_partials: torch.Tensor,      # [B, H, nkb, Lq, d] f32
    lses: torch.Tensor,            # [B, H, nkb, Lq] f32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Merge split-KV partials by their LSE: o [B, H, Lq, d] in
    ``out_dtype`` (the partials' dtype by default).

    CPU tensors take :func:`splitkv_combine_plain`.  CUDA tensors launch
    kernel H2 (``csrc/splitkv_combine.cu``), once per call, or raise: it
    takes contiguous f32 partials (O 16-byte aligned) with d in {32, 64,
    128} and writes bf16 or f32.  ``splitkv_combine.launches`` counts kernel
    launches."""
    out_dtype = out_dtype or o_partials.dtype
    b, h, nkb, lq, d = o_partials.shape
    if lses.shape != (b, h, nkb, lq):
        raise ValueError(f"partials {tuple(o_partials.shape)} and LSE "
                         f"{tuple(lses.shape)} disagree")
    if o_partials.device.type == "cpu":
        return splitkv_combine_plain(o_partials, lses).to(out_dtype)
    for t in (o_partials, lses):
        if t.device != o_partials.device:
            raise ValueError("H2 combine: tensors must share one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"H2 combine: the kernel takes f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("H2 combine: inputs must be contiguous")
    if o_partials.data_ptr() % 16:
        raise ValueError("H2 combine: the partials must be 16-byte aligned")
    if d not in H1_HEAD_DIMS or b * h * lq >= 2 ** 31:
        raise ValueError(f"H2 takes d in {H1_HEAD_DIMS} and fewer than 2^31 "
                         f"rows; got {tuple(o_partials.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"H2 writes bf16 or f32 O, not {out_dtype}")
    o = torch.empty((b, h, lq, d), dtype=out_dtype, device=o_partials.device)
    dev = o_partials.device
    err = kernels.library().eft_splitkv_combine(
        o_partials.data_ptr(), lses.data_ptr(), o.data_ptr(), b * h, nkb, lq,
        d, int(out_dtype == torch.float32), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "H2 combine")
    splitkv_combine.launches += 1
    return o


splitkv_combine.launches = 0
