"""Config helpers of the PyTorch port.

Counterpart of ``exploring_flash_attention_tpu/configs.py``: ``cdiv``,
the split-KV knobs (:class:`SplitKVConfig`) and the device mesh's layout
(:class:`MeshConfig`).  The Hopper kernels fix their
own tiles in ``csrc/``, so the JAX package's ``TileConfig`` on its own
comes back only when a kernel takes tile sizes as launch parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class SplitKVConfig:
    """The JAX package's ``SplitKVConfig`` (``configs.py:35-116``, with the
    fields it takes from ``TileConfig``): the same fields, defaults and
    validation, owned by the port.

    Kernel H1 fixes its own tiles (128 Q rows, 128-key K/V tiles), so only
    the KV span counts here: ``kv_tiles_per_block`` tiles of ``block_kv``
    keys, :meth:`kv_span` for a given KV length, which fixes the number of
    spans and so the partials' shape.  ``block_q`` and ``one_pass`` choose
    TPU routes, and ``d_tile_qk``, ``d_tile_v``, ``q_chunk``, ``head_fold``
    and ``softmax`` TPU strip and statistic options: they are taken and
    ignored."""

    block_q: int = 512
    block_kv: int = 512
    d_tile_qk: Optional[int] = None
    d_tile_v: Optional[int] = None
    one_pass: Optional[bool] = None
    q_chunk: Optional[int] = None
    head_fold: Optional[int] = None
    softmax: str = "exact"
    kv_tiles_per_block: int = 4

    def __post_init__(self):
        if self.softmax not in ("exact", "bound"):
            raise ValueError(
                f"softmax must be 'exact' or 'bound', got {self.softmax!r}")
        if self.block_q <= 0 or self.block_kv <= 0:
            raise ValueError("block sizes must be positive")
        if not _is_pow2(self.block_q) or not _is_pow2(self.block_kv):
            raise ValueError("block_q / block_kv must be powers of two")
        if self.head_fold is not None and (
                self.head_fold < 1 or not _is_pow2(self.head_fold)):
            raise ValueError("head_fold must be a positive power of two")
        for dt in (self.d_tile_qk, self.d_tile_v):
            if dt is not None and (dt <= 0 or dt % 128 != 0):
                raise ValueError("d tiles must be positive multiples of 128")
        if self.q_chunk is not None and (
                self.q_chunk <= 0 or self.q_chunk % 8 != 0):
            raise ValueError("q_chunk must be a positive multiple of 8")

    def validate_for(self, seq_len_q: int, seq_len_kv: int,
                     head_dim: int) -> None:
        if self.d_tile_qk is not None and head_dim % self.d_tile_qk != 0:
            raise ValueError(f"head_dim {head_dim} not divisible by "
                             f"d_tile_qk {self.d_tile_qk}")
        if self.d_tile_v is not None and head_dim % self.d_tile_v != 0:
            raise ValueError(f"head_dim {head_dim} not divisible by "
                             f"d_tile_v {self.d_tile_v}")

    def num_kv_blocks(self, seq_len_kv: int) -> int:
        n_kv_tiles = cdiv(seq_len_kv, self.block_kv)
        return cdiv(n_kv_tiles, self.kv_tiles_per_block)

    @property
    def kv_block_len(self) -> int:
        return self.kv_tiles_per_block * self.block_kv

    def kv_span(self, seq_len_kv: int) -> int:
        """Keys per span of ``flash_attention_splitkv_partial`` for a KV of
        ``seq_len_kv``: whole tiles of ``min(block_kv, max(Lkv, 8))`` keys,
        at most ``kv_tiles_per_block`` of them, as
        ``ops/attention_v2_splitkv.py:384-391`` of the JAX package sizes
        it."""
        block_kv = min(self.block_kv, max(seq_len_kv, 8))
        return min(self.kv_tiles_per_block,
                   cdiv(seq_len_kv, block_kv)) * block_kv


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the multi-GPU paths, the JAX package's
    ``MeshConfig`` (``configs.py:139-157``): ``dp`` data (batch), ``tp``
    tensor (heads and FFN columns), ``sp`` sequence (ring, Ulysses or the
    windowed tail hop over the sequence).  ``parallel.make_mesh`` lays the
    ranks of a ``torch.distributed`` job out in this shape."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    axis_names: Tuple[str, str, str] = ("dp", "tp", "sp")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.dp, self.tp, self.sp)

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.sp
