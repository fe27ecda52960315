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

Positions are static (Python or NumPy ints, known on the host, as the JAX
package reads them at ``ops/attention_vjp.py:65``) or traced: 0-d integer
tensors, the port's counterpart of JAX's traced values (a sequence-parallel
shard's offsets).  Traced positions reach the kernels as one int32 pair
``(q_pos0, kv_pos0)`` in device memory (:func:`traced_pair`), which every
block of H1 and H3 reads itself: no value goes back to the host, and a
call captured in a CUDA graph replays with whatever the pair then holds.
Internally a mask's ``diag_off`` is either the static int ``q_pos0 -
kv_pos0`` or that pair.

H1 takes two forms beside its default (``csrc/prefill_attention.cu``): a
64-row Q tile (``TileConfig.block_q <= 64``: :func:`h1_q_rows`) and the
bound statistic (``softmax="bound"``), whose row shift is fixed before the
K/V loop from ``||q_i||`` and a prefix maximum of ``||k_j||^2`` over
128-key tiles (:func:`bound_kmax`, :func:`bound_shift`), as the JAX
package's B3 computes it (``ops/attention_v1.py:1110-1137,1735-1753``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from exploring_flash_attention_tpu_torch import kernels
from exploring_flash_attention_tpu_torch.configs import TileConfig, cdiv

LOG2E = math.log2(math.e)      # the kernels' exp2 basis: scale * LOG2E
# the bound statistic's shift below the Cauchy-Schwarz bound, in bits
# (the JAX package's ops/attention_v1.py:1110): p <= 2^64
BOUND_SHIFT = 64.0
# the statistic's row group: a row reads the K/V tile that the last row of
# its group of 128 sees, whatever H1's Q tile (csrc BOUND_ROWS)
BOUND_ROWS = 128
# a mask's diagonal: the static int q_pos0 - kv_pos0, or the traced pair
# (q_pos0, kv_pos0), int32 [2] on the inputs' device
DiagOff = Union[int, torch.Tensor]


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True, diag_off: int = 0,
                    window: Optional[int] = None,
                    shift: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of H1 in f32 math (f64 for f64 inputs): (o
    [B,H,Lq,d] normalized, lse [B,H,Lq] natural log, scale included).

    Non-causal rows see every key.  Causal row ``i`` sees key ``j`` iff
    ``j <= i + diag_off``; a ``window`` (causal only, inclusive) further
    needs ``j >= i + diag_off - window + 1``.  ``diag_off`` is an int or
    a traced pair (the mask is then built by tensor arithmetic).  A row
    that sees nothing gives (0, -inf).

    ``shift`` [B, H, Lq] (natural log, :func:`bound_shift`) is the bound
    statistic: p = exp(s - shift) with no row max, l = sum p, lse = shift
    + ln l, summed over 128-key tiles in order as H1 sums them (a tile a
    row does not see adds exact zeros, so causal rows are bitwise
    unchanged when the KV grows by whole tiles)."""
    group = q.shape[1] // k.shape[1]
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct).repeat_interleave(group, dim=1)
    vf = v.to(ct).repeat_interleave(group, dim=1)
    hidden = hidden_keys(q.shape[2], k.shape[2], causal, diag_off, window,
                         q.device)
    if shift is not None:
        return _bound_plain(q.to(ct), kf, vf, scale, hidden, shift.to(ct))
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kf) * scale
    if hidden is not None:
        s = s.masked_fill(hidden, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    row_shift = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - row_shift[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p, vf), lse


def _bound_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, hidden: Optional[torch.Tensor],
                 shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_plain` under the bound statistic, over 128-key
    tiles (q, k, v in the compute type, k/v at q's heads)."""
    o = torch.zeros_like(q[..., :v.shape[-1]])
    l_row = torch.zeros_like(shift)
    for j in range(0, k.shape[2], H1_KV_TILE):
        s = torch.einsum("bhqd,bhkd->bhqk", q,
                         k[:, :, j:j + H1_KV_TILE]) * scale
        if hidden is not None:
            s = s.masked_fill(hidden[:, j:j + H1_KV_TILE], float("-inf"))
        p = torch.exp(s - shift[..., None])
        l_row = l_row + p.sum(dim=-1)
        o = o + torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, j:j + H1_KV_TILE])
    seen = l_row > 0
    o = o / torch.where(seen, l_row, 1.0)[..., None]
    lse = torch.where(seen, shift + torch.log(l_row), float("-inf"))
    return o, lse


def bound_kmax(k: torch.Tensor) -> torch.Tensor:
    """The bound statistic's K side: f32 [B, Hkv, cdiv(Lkv, 128)], the
    prefix maxima (cummax over 128-key tiles) of each tile's largest
    ``||k_j||^2``.  Zero-filled tail keys have norm 0.  Torch ops on either
    device (a norm, a pad, a max, a cummax, a square), as the JAX package
    computes it with XLA outside its kernel; ``bound_kmax.launches`` counts
    calls."""
    b, hkv, lkv, _ = k.shape
    n_kv = cdiv(lkv, H1_KV_TILE)
    norm = torch.linalg.vector_norm(
        k, dim=-1, dtype=torch.promote_types(k.dtype, torch.float32))
    if n_kv * H1_KV_TILE != lkv:
        norm = torch.nn.functional.pad(norm, (0, n_kv * H1_KV_TILE - lkv))
    tile_max = norm.view(b, hkv, n_kv, H1_KV_TILE).amax(dim=-1)
    bound_kmax.launches += 1
    return torch.cummax(tile_max, dim=-1).values.square()


bound_kmax.launches = 0


def bound_shift(q: torch.Tensor, kmax: torch.Tensor, scale: float,
                causal: bool, diag_off: DiagOff) -> torch.Tensor:
    """Each row's bound shift in the natural log, [B, Hq, Lq]:
    ``sqrt(||q_i||^2 kmax) scale - 64 ln 2``, H1's ``m_i`` of the bound
    form.  ``kmax`` is :func:`bound_kmax`'s, read at the last K/V tile that
    the last row of the row's 128-row group sees (the last tile without a
    mask), whatever the Q tile: the index H1 computes per block."""
    lq = q.shape[2]
    n_kv = kmax.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    if causal:
        rows = torch.arange(lq, device=q.device)
        last = torch.clamp(rows // BOUND_ROWS * BOUND_ROWS + BOUND_ROWS,
                           max=lq) - 1
        idx = torch.clamp(torch.div(last + diagonal(diag_off), H1_KV_TILE,
                                    rounding_mode="floor"), 0, n_kv - 1)
    else:
        idx = torch.full((lq,), n_kv - 1, device=q.device)
    group = q.shape[1] // kmax.shape[1]
    k_sq = kmax.to(ct).repeat_interleave(group, dim=1)[:, :, idx]
    q_sq = q.to(ct).square().sum(dim=-1)
    return torch.sqrt(q_sq * k_sq) * scale - BOUND_SHIFT * math.log(2.0)


def hidden_keys(lq: int, lkv: int, causal: bool, diag_off: DiagOff,
                window: Optional[int], device: torch.device
                ) -> Optional[torch.Tensor]:
    """The mask of :func:`attention_plain`: [Lq, Lkv] bool, True where q row
    ``i`` does not see key ``j``; None without a mask (non-causal)."""
    if not causal:
        return None
    last = torch.arange(lq, device=device)[:, None] + diagonal(diag_off)
    col = torch.arange(lkv, device=device)[None, :]
    hidden = col > last
    if window is not None:
        hidden |= col < last - window + 1
    return hidden


def is_static(positions) -> bool:
    """Whether ``(q_pos0, kv_pos0)`` are static: Python or NumPy ints, as
    the JAX package's ``ops/attention_vjp.py:65`` tells them apart."""
    return all(isinstance(p, (int, np.integer)) for p in positions)


def traced_pair(positions, device: torch.device) -> torch.Tensor:
    """Traced positions ``(q_pos0, kv_pos0)`` as the kernels read them: a
    contiguous int32 [2] on ``device``.  Each position is a 0-d integer
    tensor (an int also goes); nothing is read back to the host."""
    for p in positions:
        if isinstance(p, torch.Tensor) and (
                p.dim() != 0 or p.is_floating_point() or p.is_complex()
                or p.dtype == torch.bool):
            raise TypeError(f"a traced position is a 0-d integer tensor, got "
                            f"{p.dtype} of shape {tuple(p.shape)}")
        elif not isinstance(p, (torch.Tensor, int, np.integer)):
            raise TypeError(f"positions are ints or 0-d integer tensors, "
                            f"got {type(p).__name__}")
    return torch.stack([torch.as_tensor(p, device=device).to(torch.int32)
                        for p in positions])


def diagonal(diag_off: DiagOff):
    """A mask's diagonal for tensor arithmetic: the static int, or ``q_pos0
    - kv_pos0`` of a traced pair as a 0-d int64 tensor (a 0-d tensor is
    such a diagonal already)."""
    if isinstance(diag_off, torch.Tensor) and diag_off.dim() == 1:
        return diag_off[0].long() - diag_off[1].long()
    return diag_off


# The head dims of the serving kernels H1, H2, H6-decode and H6-extend, of
# the backward pair H3-dkv and H3-dq and of the quantized pair H4-kvq and
# H4-int8: every d up to their largest instance.  A d below its instance's
# D runs on zero-filled columns; where a row of q, k, v, dO or the codes is
# not a multiple of 16 bytes (bf16 d % 8, f32 d % 4, codes d % 16) the
# kernels load it at the alignment it has instead of by TMA boxes or
# 16-byte loads
SERVING_HEAD_DIM_RULE = "d from 1 to 256"
# The head dims of H5 (ops.attention_v1_dtiled.h5_plan), d cut into
# 128-column chunks across the blocks of a cluster, rows loaded as the
# serving kernels load them
H5_HEAD_DIM_RULE = "d from 1 to 2048"


def kernel_head_dim(d: int) -> bool:
    """Whether the serving kernels H1, H2, H6-decode and H6-extend, the
    backward pair H3-dkv and H3-dq and the quantized pair H4-kvq and
    H4-int8 take head dim ``d`` (:data:`SERVING_HEAD_DIM_RULE`).  H1, H3,
    H4 and the paged pair run a d below their next instance's (32, 64, 128
    or 256) on zero-filled columns; H2 has one instance per multiple of 16
    and runs any other d on the instance of its lanes with d read at run
    time."""
    return 1 <= d <= 256


H4_INSTANCES = (64, 128, 256)   # the head dims H4-kvq and H4-int8 build


def h4_instance(d: int) -> int:
    """The instance of H4-kvq and H4-int8 that head dim ``d`` runs on: the
    smallest of :data:`H4_INSTANCES` at or above it (a d below it runs on
    zero-filled columns).  ``ValueError`` outside
    :data:`SERVING_HEAD_DIM_RULE`."""
    if not kernel_head_dim(d):
        raise ValueError(f"H4-kvq and H4-int8 take {SERVING_HEAD_DIM_RULE}; "
                         f"got d={d}")
    return next(x for x in H4_INSTANCES if x >= d)


H1_KV_TILE = 128                # keys per K/V tile; a KV span is whole tiles
H1_Q_ROWS = (64, 128)           # Q rows per block: H1's two Q tiles


def h1_q_rows(config: TileConfig) -> int:
    """H1's Q tile for ``config``: 64 rows when ``block_q <= 64``, else 128
    (the default)."""
    return 64 if config.block_q <= 64 else 128

_MASK_NONE, _MASK_CAUSAL, _MASK_WINDOW = 0, 1, 2      # csrc enum Mask


def mask_args(causal: bool, diag_off: DiagOff, window: Optional[int],
              device: torch.device) -> Tuple[int, int, int, Optional[int]]:
    """(mask, diag_off, window, offs) as the kernels' C entries take them
    (H1, H3): the csrc ``Mask`` code, the static diagonal and the window,
    both checked to fit 32 bits, and the device address of a traced pair
    (None when the diagonal is static; its int is then the one read)."""
    offs = None
    if isinstance(diag_off, torch.Tensor):
        if (diag_off.dtype != torch.int32 or diag_off.shape != (2,)
                or not diag_off.is_contiguous()
                or diag_off.device != device):
            raise ValueError(f"traced positions must be a contiguous int32 "
                             f"[2] on {device} (traced_pair)")
        diag_off, offs = 0, diag_off.data_ptr()
    if not all(-2 ** 31 <= int(x) < 2 ** 31 for x in (diag_off, window or 0)):
        raise ValueError(f"diag_off {diag_off} and window {window} must "
                         "fit in 32 bits")
    mask = (_MASK_NONE if not causal
            else _MASK_CAUSAL if window is None else _MASK_WINDOW)
    return mask, int(diag_off), int(window or 0), offs


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, diag_off: DiagOff = 0, causal: bool = True,
                      window: Optional[int] = None,
                      out_dtype: Optional[torch.dtype] = None,
                      with_lse: bool = True, kv_span: Optional[int] = None,
                      q_rows: int = 128, softmax: str = "exact"
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention forward: (o in ``out_dtype`` or q.dtype, lse f32
    [B, Hq, Lq] or None without ``with_lse``).  The mask is none, causal
    at ``diag_off`` (an int, or a traced pair from :func:`traced_pair`,
    which the kernel reads from device memory), or a causal ``window`` (see
    :func:`attention_plain`); at a static diagonal, a window that holds
    every key the causal rows see is plain causal.

    With ``kv_span`` the KV is cut into nkb = cdiv(Lkv, kv_span) spans and
    both outputs gain a span axis: o [B, Hq, nkb, Lq, d] normalized over
    each span and lse [B, Hq, nkb, Lq] of each span, the partials that
    ``splitkv_combine`` merges.  The plain path takes any positive span;
    H1 takes whole 128-key tiles.

    ``q_rows`` (64 or 128, :func:`h1_q_rows`) is H1's Q tile; it leaves the
    result unchanged.  ``softmax="bound"`` fixes each row's shift before
    the K/V loop (:func:`bound_shift`, from :func:`bound_kmax`'s statistic
    over the whole KV, so every span of a row shares it) instead of the
    running row max: the same function within bf16's rounding of P, under
    every mask, offset and span.

    CPU tensors take :func:`attention_plain`.  CUDA tensors launch kernel
    H1 (``csrc/prefill_attention.cu``), once per call, or raise: it takes
    contiguous q/k/v of one dtype, bf16 or f32 (bf16x6 on wgmma, at f32
    accuracy: :data:`KERNEL_DTYPES`), with :data:`SERVING_HEAD_DIM_RULE`
    and writes bf16 or f32 O.  ``prefill_attention.launches`` counts kernel
    launches; the bound form's statistic adds :func:`bound_kmax`'s torch
    ops before it."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    out_dtype = out_dtype or q.dtype
    if window is not None:
        if not causal or window < 1:
            raise ValueError(f"a window needs causal=True and window >= 1, "
                             f"got causal={causal}, window={window}")
        if (not isinstance(diag_off, torch.Tensor)
                and window >= lq + diag_off):
            window = None               # the last row sees keys 0..window-1
    if kv_span is not None and kv_span <= 0:
        raise ValueError(f"kv_span must be positive, got {kv_span}")
    if q_rows not in H1_Q_ROWS or softmax not in ("exact", "bound"):
        raise ValueError(f"H1 takes q_rows in {H1_Q_ROWS} and softmax "
                         f"'exact' or 'bound'; got {q_rows}, {softmax!r}")
    kmax = bound_kmax(k) if softmax == "bound" else None
    if q.device.type == "cpu":
        shift = (None if kmax is None
                 else bound_shift(q, kmax, scale, causal, diag_off))
        if kv_span is None:
            o, lse = attention_plain(q, k, v, scale, causal, diag_off, window,
                                     shift)
        else:
            parts = [attention_plain(q, k[:, :, s:s + kv_span],
                                     v[:, :, s:s + kv_span], scale, causal,
                                     diagonal(diag_off) - s, window, shift)
                     for s in range(0, lkv, kv_span)]
            o = torch.stack([p[0] for p in parts], dim=2)
            lse = torch.stack([p[1] for p in parts], dim=2)
        return o.to(out_dtype), lse if with_lse else None
    in_dtype = _check_cuda_inputs("H1", "H1 attention", q, k, v)
    if (k.shape != (b, hkv, lkv, d) or v.shape != k.shape
            or hq % hkv or not kernel_head_dim(d) or lq == 0 or lkv == 0):
        raise ValueError(
            f"H1 takes q [B,Hq,Lq,d], k/v [B,Hkv,Lkv,d] with Hq % Hkv == 0 "
            f"and {SERVING_HEAD_DIM_RULE}; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"H1 writes bf16 or f32 O, not {out_dtype}")
    if kv_span is not None and kv_span % H1_KV_TILE:
        raise ValueError(
            f"H1 takes a kv_span that is a multiple of {H1_KV_TILE} keys (whole "
            f"K/V tiles); got kv_span={kv_span} for q {tuple(q.shape)} and "
            f"k/v {tuple(k.shape)}")
    mask = mask_args(causal, diag_off, window, q.device)
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
        int(out_dtype == torch.float32), scale, q_rows,
        None if kmax is None else kmax.data_ptr(),
        int(in_dtype == torch.float32), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(err, "H1 attention")
    prefill_attention.launches += 1
    return o, lse


prefill_attention.launches = 0


# The input dtypes each kernel takes on the card: q/k/v for H1, H3 and H5
# (and dO for H3), q for H4-kvq and the paged pair (their K/V are codes;
# H5's K/V too where they are quantized).  f32 is the JAX package's default
# dtype (models/transformer.py:59) and its kernels compute f32 at f32
# accuracy (HIGHEST); no kernel takes f16 or f64.  Each takes f32 at
# every head dim it takes bf16 at.
KERNEL_DTYPES = {
    "H1": (torch.bfloat16, torch.float32),
    "H3-dkv": (torch.bfloat16, torch.float32),
    "H3-dq": (torch.bfloat16, torch.float32),
    "H4-kvq": (torch.bfloat16, torch.float32),
    "H5": (torch.bfloat16, torch.float32),
    "H6-decode": (torch.bfloat16, torch.float32),
    "H6-extend": (torch.bfloat16, torch.float32),
}
_DTYPE_WORD = {torch.bfloat16: "bf16", torch.float32: "f32"}


def kernel_dtype(kernel: str, *tensors: torch.Tensor) -> torch.dtype:
    """The dtype ``kernel`` (a key of :data:`KERNEL_DTYPES`) runs
    ``tensors`` at: their one dtype, where the kernel takes it.  Raises
    ``TypeError`` otherwise, naming what the kernel takes.  Device-free:
    the rule is the same on the CPU, where the plain versions take any
    float."""
    dtypes = {t.dtype for t in tensors}
    takes = KERNEL_DTYPES[kernel]
    names = " or ".join(_DTYPE_WORD[dt] for dt in takes)
    if len(dtypes) != 1:
        raise TypeError(f"{kernel} takes inputs of one dtype ({names}), got "
                        f"{sorted(str(dt) for dt in dtypes)}")
    (dtype,) = dtypes
    if dtype not in takes:
        raise TypeError(f"{kernel} takes {names}, got {dtype}")
    return dtype


def _check_cuda_inputs(kernel: str, name: str,
                       *tensors: torch.Tensor) -> torch.dtype:
    """The checks of ``kernel`` (a key of :data:`KERNEL_DTYPES`), whose
    errors say ``name``: one CUDA device, the kernel's dtypes
    (:func:`kernel_dtype`, whose dtype it returns), contiguous 16-byte
    aligned tensors."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
    dtype = kernel_dtype(kernel, *tensors)
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")
    return dtype


def static_diagonal(lq: int, lkv: int,
                    static_positions: Optional[Tuple[int, int]]) -> int:
    """``q_pos0 - kv_pos0`` of static positions, by default the decode
    convention's ``Lkv - Lq``.  Tensors raise ``TypeError``: they go in
    ``positions``, the traced argument."""
    if static_positions is None:
        return lkv - lq
    if not is_static(static_positions):
        raise TypeError("static_positions take Python or NumPy ints; pass "
                        "tensors as the traced positions")
    return int(static_positions[0]) - int(static_positions[1])


def _decode_convention(positions, lq: int, lkv: int) -> bool:
    """Whether static ``positions`` are the default ``(Lkv - Lq, 0)``, the
    only ones the JAX package's band forward takes
    (``parallel/partials.py:63-68``)."""
    return positions is None or tuple(int(p) for p in positions) == (
        lkv - lq, 0)


def mask_diagonal(lq: int, lkv: int, causal: bool, positions,
                  device: torch.device, static_positions=None) -> DiagOff:
    """The ``diag_off`` of ``positions`` or ``static_positions`` (neither:
    the decode convention): the static int, or the traced pair on
    ``device``.  Without ``causal`` positions mean nothing and give 0.
    Both kinds at once raise ``ValueError``, as in the JAX package."""
    if positions is not None and static_positions is not None:
        raise ValueError("pass positions OR static_positions, not both")
    if positions is None:
        return static_diagonal(lq, lkv, static_positions)
    if not causal:
        return 0
    if is_static(positions):
        return static_diagonal(lq, lkv, positions)
    return traced_pair(positions, device)


def attention_partial_local(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    config: TileConfig = TileConfig(),
    scale: Optional[float] = None,
    causal: bool = False,
    positions=None,
    static_positions: Optional[Tuple[int, int]] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized partial attention over a local KV shard: (o f32
    [B,H,Lq,d], lse f32 [B,H,Lq]), O written in f32 by H1 on the card.  A
    row that sees no key gives (0, -inf), the merge identity.

    Non-causal; causal at ``positions`` (a sequence-parallel shard's
    ``(q_pos0, kv_pos0)``, traced as 0-d integer tensors: B9's route) or
    ``static_positions`` (ints); or a causal ``window`` at the
    decode-convention positions, as ``parallel/partials.py:46-81`` routes
    it (a window of Lkv or more is plain causal; other positions, and any
    traced ones, raise ``NotImplementedError``).  H1 reads
    ``config.block_q`` (its Q tile, :func:`h1_q_rows`) and no other field;
    ``softmax`` is ``flash_attention_v1``'s alone, as in the JAX package."""
    lq, lkv = q.shape[2], k.shape[2]
    if window is not None and (not causal or positions is not None):
        raise NotImplementedError(
            "window requires causal=True with static positions")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    diag_off = mask_diagonal(lq, lkv, causal, positions, q.device,
                             static_positions)
    if window is not None and window >= lkv:
        window = None               # the band covers every key: causal
    if window is not None and not _decode_convention(static_positions, lq,
                                                     lkv):
        raise NotImplementedError(
            "windowed partial attention needs decode-convention positions; "
            f"got Lq={lq}, Lkv={lkv}, positions={static_positions}")
    return prefill_attention(q, k, v, scale, diag_off, causal, window,
                             out_dtype=torch.float32,
                             q_rows=h1_q_rows(config))


def checked_window(causal: bool, window: Optional[int], lkv: int
                   ) -> Optional[int]:
    """The window check of ``flash_attention`` and ``flash_attention_bwd``,
    as the JAX package makes it (``ops/attention_vjp.py:57-61``,
    ``ops/attention_bwd.py:631-635``): a window without ``causal`` raises
    ``ValueError``; a window of Lkv or more is plain causal (None)."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window >= lkv:
            return None             # the band covers every key: causal
    return window


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
    """Counterpart of ``_flash_attention_static`` and, at traced positions,
    ``_flash_attention`` in the JAX package (``ops/attention_vjp.py:83-166``):
    the forward is :func:`prefill_attention` (H1 on the card), which saves
    ``(q, k, v, out, lse)`` and the mask, a traced pair included, as
    ``_fwd`` does; the backward is ``flash_attention_bwd`` (H3-dkv and
    H3-dq) under the same mask."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, diag_off: DiagOff,
                window: Optional[int], q_rows: int = 128):
        out, lse = prefill_attention(q, k, v, scale, diag_off, causal, window,
                                     q_rows=q_rows)
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
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,               # [B, Hq, Lq, d]
    k: torch.Tensor,               # [B, Hkv, Lkv, d]
    v: torch.Tensor,
    config: TileConfig = TileConfig(),
    scale: Optional[float] = None,
    causal: bool = False,
    positions: Optional[Tuple[int, int]] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The JAX package's ``flash_attention``, differentiable: o in q.dtype.

    Non-causal; causal at static positions (Python or NumPy ints, or the
    default decode convention) or at traced ones (0-d integer tensors, a
    sequence-parallel shard's offsets, which the kernels read from device
    memory); or a causal ``window`` at the decode convention's positions:
    JAX's forward takes a band only there (``parallel/partials.py:63-76``),
    and so does the port, which raises ``NotImplementedError`` for other
    positions and for traced ones (``ops/attention_vjp.py:70-73``).  A
    window of Lkv or more is plain causal; a window without ``causal``
    raises ``ValueError``.  The backward runs H3 under the same mask; where
    autograd records nothing (no grad mode, or no input that requires
    grad) the call is the forward alone.  The forward's H1 reads
    ``config.block_q`` (its Q tile, :func:`h1_q_rows`); H3 and the other
    fields do not read ``config``."""
    lq, lkv = q.shape[2], k.shape[2]
    window = checked_window(causal, window, lkv)
    diag_off = mask_diagonal(lq, lkv, causal, positions, q.device)
    if window is not None and isinstance(diag_off, torch.Tensor):
        raise NotImplementedError(
            "window with traced shard positions is not supported; shard "
            "windows at the caller or use static positions")
    if window is not None and not _decode_convention(positions, lq, lkv):
        raise NotImplementedError(
            "windowed attention needs decode-convention positions; got "
            f"Lq={lq}, Lkv={lkv}, positions={positions}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale, causal, diag_off,
                                 window, h1_q_rows(config))
