"""Split-KV attention of the port (the reference's V2 tier): the span
partials on kernel H1, their merge on kernel H2.

Counterparts of ``flash_attention_splitkv_partial`` (``:348``),
``splitkv_combine`` (``:619``) and ``flash_attention_v2`` (``:657``) in the
JAX package's ``ops/attention_v2_splitkv.py``.  The partials come from
H1's span mode (``prefill_attention(..., kv_span=)``): per KV span, an O
normalized over the span and the span's natural-log LSE, in one launch
for every span; H2 merges them by their LSE in one more.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.configs import SplitKVConfig, cdiv
from exploring_flash_attention_tpu_torch.ops.attention import (
    H1_KV_TILE,
    SERVING_HEAD_DIM_RULE,
    h1_q_rows,
    kernel_head_dim,
    mask_diagonal,
    prefill_attention,
)


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
    block_q: int = 128,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Merge split-KV partials by their LSE: o [B, H, Lq, d] in
    ``out_dtype`` (the partials' dtype by default).  ``block_q`` is the
    JAX kernel's row block (B10's grid); H2 sizes its own rows from d and
    does not read it.

    CPU tensors take :func:`splitkv_combine_plain`.  CUDA tensors launch
    kernel H2 (``csrc/splitkv_combine.cu``), once per call, or raise: it
    takes contiguous f32 partials (O 16-byte aligned) with
    ``ops.attention.SERVING_HEAD_DIM_RULE`` and writes bf16 or f32.
    ``splitkv_combine.launches`` counts kernel launches."""
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
    if not kernel_head_dim(d) or b * h * lq >= 2 ** 31:
        raise ValueError(f"H2 takes {SERVING_HEAD_DIM_RULE} and fewer than "
                         f"2^31 rows; got {tuple(o_partials.shape)}")
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


def flash_attention_splitkv_partial(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    config: SplitKVConfig = SplitKVConfig(),
    scale: Optional[float] = None,
    causal: bool = False,
    workspace_dtype: torch.dtype = torch.float32,
    positions: Optional[Tuple[int, int]] = None,
    static_positions: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of the split-KV pair: (o_partial [B, Hq, nkb, Lq, d] in
    ``workspace_dtype``, normalized over each span, lse f32 [B, Hq, nkb,
    Lq], natural log), the KV cut into nkb = cdiv(Lkv, span) spans of
    ``config.kv_span(Lkv)`` keys.  A span that sees no key gives (0, -inf).

    ``static_positions`` (Python or NumPy ints ``(q_pos0, kv_pos0)``, the
    global positions of q row 0 and KV row 0) place the causal diagonal;
    by default the q rows are the last Lq positions.  Traced
    ``positions`` (0-d integer tensors: B9's offsets, which H1 reads from
    device memory) place it too.  GQA: k/v may carry fewer heads (Hq % Hkv
    == 0).

    CPU tensors take H1's plain version over each span.  CUDA tensors
    launch H1 once over every span (``prefill_attention``), or raise: H1
    takes bf16 or f32 q/k/v with ``ops.attention.SERVING_HEAD_DIM_RULE``
    at both dtypes, writes bf16 or f32 partials and takes spans of whole
    128-key tiles.  H1 reads ``block_q`` (its Q tile) and
    ``kv_tiles_per_block`` (the span) of ``config``.  A single span
    covering the whole KV is handed to H1 rounded up to whole tiles (the
    same result)."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    if (k.shape != (b, hkv, lkv, d) or v.shape != (b, hkv, lkv, d)
            or hq % hkv != 0):
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    diag_off = mask_diagonal(lq, lkv, causal, positions, q.device,
                             static_positions)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    span = config.kv_span(lkv)
    if span >= lkv and q.device.type != "cpu":
        span = cdiv(lkv, H1_KV_TILE) * H1_KV_TILE    # one span either way
    return prefill_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), scale, diag_off,
        causal, out_dtype=workspace_dtype, kv_span=span,
        q_rows=h1_q_rows(config))


def flash_attention_v2(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    config: SplitKVConfig = SplitKVConfig(),
    scale: Optional[float] = None,
    causal: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The split-KV pair: :func:`flash_attention_splitkv_partial`, then
    :func:`splitkv_combine`; o [B, Hq, Lq, d] in ``out_dtype`` or q.dtype.
    On the card, one H1 launch and one H2 launch.

    The JAX package keeps the workspace in q's dtype (bf16 for bf16
    inputs); the port keeps it in f32, because H2 merges f32 partials
    only.  So for bf16 inputs the port rounds once (O to ``out_dtype``)
    where JAX rounds twice (each partial, then O), and lands nearer the
    f64 oracle: within JAX's bf16 tier (``tests/test_attention_v2.py``,
    1.5e-2)."""
    o_part, lse = flash_attention_splitkv_partial(
        q, k, v, config=config, scale=scale, causal=causal,
        workspace_dtype=torch.promote_types(q.dtype, torch.float32))
    return splitkv_combine(o_part, lse, config.block_q,
                           out_dtype or q.dtype)
