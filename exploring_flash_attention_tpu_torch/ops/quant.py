"""Quantization primitives of the port: INT8 / FP8 tensors with per-block
scales.

Counterpart of ``ops/quant.py`` in the JAX package, with its arithmetic:
one f32 scale per ``block`` rows of L, ``max(absmax, 1e-8) / qmax``; the
values are ``x * (1 / scale)`` (a multiply, not a divide), rounded half to
even and clipped to +-127 for int8, clipped to +-448 and cast for e4m3.
The quantized attention kernels (H4-kvq, H4-int8, H5) fold the scales into
multiplies they already do.

Layout: a quantized [B, H, L, d] tensor is ``values`` int8 or
``torch.float8_e4m3fn`` [B, H, L, d] and ``scales`` f32 [B, H, n_blocks].
``warn_if_fp8_slow`` is not ported: it steers a TPU generation without
native e4m3 operands, and the H100 has them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.configs import cdiv

INT8_MAX = 127.0
FP8_MAX = 448.0                 # e4m3's largest normal value
FP8_DTYPE = torch.float8_e4m3fn
# the element type of K and V, as the kernels' kv_kind argument numbers it
# (csrc/quant_tile.cuh, enum KvKind)
KV_KIND = {torch.bfloat16: 0, torch.int8: 1, FP8_DTYPE: 2}


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Per-L-block symmetric quantized tensor."""

    values: torch.Tensor        # [B, H, L, d] int8 or float8_e4m3fn
    scales: torch.Tensor        # [B, H, n_blocks] f32
    block: int                  # rows of L per scale

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype


def _absmax_scale(x: torch.Tensor, block: int, qmax: float) -> torch.Tensor:
    b, h, l, d = x.shape
    n_blocks = cdiv(l, block)
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, n_blocks * block - l))
    absmax = xf.reshape(b, h, n_blocks, block * d).abs().amax(dim=-1)
    return torch.clamp(absmax, min=1e-8) / qmax


def _expand(scales: torch.Tensor, shape, block: int) -> torch.Tensor:
    """[B, H, nb] -> broadcastable [B, H, L, 1]."""
    return scales.repeat_interleave(block, dim=2)[:, :, :shape[2], None]


def quantize_int8(x: torch.Tensor, block: int = 128) -> QuantizedTensor:
    """Symmetric absmax INT8 quantization with one f32 scale per L-block."""
    scales = _absmax_scale(x, block, INT8_MAX)
    scaled = x.float() * _expand(1.0 / scales, x.shape, block)
    q = torch.clamp(torch.round(scaled), -INT8_MAX, INT8_MAX).to(torch.int8)
    return QuantizedTensor(q, scales, block)


def quantize_fp8(x: torch.Tensor, block: int = 128) -> QuantizedTensor:
    """Symmetric absmax FP8 (e4m3) quantization with per-L-block scales."""
    scales = _absmax_scale(x, block, FP8_MAX)
    scaled = x.float() * _expand(1.0 / scales, x.shape, block)
    return QuantizedTensor(torch.clamp(scaled, -FP8_MAX, FP8_MAX)
                           .to(FP8_DTYPE), scales, block)


def dequantize(qt: QuantizedTensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reference dequant (the kernels never materialize it)."""
    return (qt.values.float() * _expand(qt.scales, qt.values.shape, qt.block)
            ).to(dtype)


def quantization_error(x: torch.Tensor, qt: QuantizedTensor) -> float:
    """max-abs round-trip error, for calibration diagnostics."""
    return float((x.float() - dequantize(qt)).abs().max())


def check_blocks(length: int, *qts: QuantizedTensor) -> int:
    """The quant block the tensors share, each with cdiv(length, block)
    scales per (batch, head); raises ``ValueError`` otherwise."""
    if any(qt.block != qts[0].block for qt in qts):
        raise ValueError("K and V quant blocks must match")
    block = qts[0].block
    for qt in qts:
        if (qt.scales.shape[2] != cdiv(length, block)
                or qt.scales.shape[:2] != qt.values.shape[:2]):
            raise ValueError(
                f"scale blocks {tuple(qt.scales.shape)} != n_kv_blocks "
                f"{cdiv(length, block)} of {tuple(qt.values.shape)}")
    return block


def check_cuda_quantized(name: str, device: torch.device, dtypes,
                         *qts: QuantizedTensor) -> None:
    """What a kernel needs of quantized operands on the card: values of
    one of ``dtypes``, all of one dtype, contiguous and 16-byte aligned,
    and contiguous f32 scales, all on ``device``."""
    for qt in qts:
        for t in (qt.values, qt.scales):
            if t.device != device:
                raise ValueError(f"{name}: tensors must share one CUDA "
                                 f"device, got {t.device} and {device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: inputs must be contiguous")
        if qt.values.dtype not in dtypes or qt.values.dtype != qts[0].dtype:
            raise TypeError(f"{name}: the kernel takes values of one dtype "
                            f"in {dtypes}, got {[x.dtype for x in qts]}")
        if qt.values.data_ptr() % 16:
            raise ValueError(f"{name}: values must be 16-byte aligned")
        if qt.scales.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be f32, got "
                            f"{qt.scales.dtype}")


def tensor_from_numpy(x, device="cuda") -> torch.Tensor:
    """A NumPy array (such as ``np.asarray`` of a JAX array) as a tensor on
    ``device``, copied (such arrays are read-only).  e4m3 goes through its
    bytes and bf16 through f32, both exact, so no ``ml_dtypes`` is needed."""
    name = x.dtype.name
    if name == "float8_e4m3fn":
        raw = torch.from_numpy(np.ascontiguousarray(x).view(np.uint8).copy())
        return raw.view(FP8_DTYPE).to(device)
    if name == "bfloat16":
        return torch.from_numpy(np.asarray(x, np.float32).copy()).to(
            device, torch.bfloat16)
    return torch.from_numpy(np.array(x)).to(device)


def quantized_from_numpy(values, scales, block: int,
                         device="cuda") -> QuantizedTensor:
    """The port's :class:`QuantizedTensor` from a JAX ``QuantizedTensor``'s
    arrays (``np.asarray(qt.values)``, ``np.asarray(qt.scales)``, its
    ``block``), on ``device``."""
    return QuantizedTensor(tensor_from_numpy(values, device),
                           tensor_from_numpy(scales, device), int(block))
