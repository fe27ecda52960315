"""Config helpers of the PyTorch port.

Counterpart of ``exploring_flash_attention_tpu/configs.py``: ``cdiv`` and
``round_up``, the tile knobs (:class:`TileConfig`), the split-KV knob
(:class:`SplitKVConfig`), the precision policy (:class:`Precision`) and the
device mesh's layout (:class:`MeshConfig`), with the JAX package's fields,
defaults and validation.

Of :class:`TileConfig`'s fields the Hopper kernels read three: ``block_q``
picks H1's Q tile (64 rows when ``block_q <= 64``, else 128), ``softmax``
picks H1's row statistic (``flash_attention_v1`` only, as in the JAX
package), and :class:`SplitKVConfig`'s ``kv_tiles_per_block`` sizes H1's
KV span.  ``block_kv``, ``one_pass``, ``q_chunk``, ``head_fold`` and the
``d_tile_*`` pair choose TPU routes and VMEM strips: they are validated as
in the JAX package and not read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Tile knobs of the attention ops, the JAX package's ``TileConfig``
    (``configs.py:34-100``) field for field.

    ``block_q`` chooses H1's Q tile: 64 rows (one consumer warpgroup, 256
    threads) when ``block_q <= 64``, else 128 (two warpgroups, 384
    threads), the default.  ``softmax`` is the row statistic of
    ``flash_attention_v1``: ``"exact"`` (the running row max) or
    ``"bound"`` (the Cauchy-Schwarz shift ``||q_i|| max_j ||k_j|| scale``
    fixed before the K/V loop; ``ops/attention.py``).  The other fields
    are the JAX package's TPU knobs and are not read."""

    block_q: int = 512
    block_kv: int = 512
    d_tile_qk: Optional[int] = None
    d_tile_v: Optional[int] = None
    one_pass: Optional[bool] = None
    q_chunk: Optional[int] = None
    head_fold: Optional[int] = None
    softmax: str = "exact"

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
                raise ValueError("d tiles must be positive multiples of 128 "
                                 "(TPU lane width)")
        if self.q_chunk is not None and (
                self.q_chunk <= 0 or self.q_chunk % 8 != 0):
            raise ValueError("q_chunk must be a positive multiple of 8 "
                             "(TPU sublane width)")

    def validate_for(self, seq_len_q: int, seq_len_kv: int,
                     head_dim: int) -> None:
        if self.d_tile_qk is not None and head_dim % self.d_tile_qk != 0:
            raise ValueError(f"head_dim {head_dim} not divisible by "
                             f"d_tile_qk {self.d_tile_qk}")
        if self.d_tile_v is not None and head_dim % self.d_tile_v != 0:
            raise ValueError(f"head_dim {head_dim} not divisible by "
                             f"d_tile_v {self.d_tile_v}")


@dataclasses.dataclass(frozen=True)
class SplitKVConfig(TileConfig):
    """The JAX package's ``SplitKVConfig`` (``configs.py:103-116``): adds
    how many ``block_kv`` tiles one span holds.  H1 reads it through
    :meth:`kv_span`, which fixes the number of spans and so the partials'
    shape."""

    kv_tiles_per_block: int = 4

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
class Precision:
    """Mixed-precision policy, the JAX package's ``Precision``
    (``configs.py:118-136``): Q/K/V/O stored in ``storage`` (bf16, the
    Hopper kernels' input type), matmul accumulators and the softmax
    statistics in ``accum`` (f32, as every kernel keeps them), and the
    softmax scale, ``1/sqrt(d)`` unless ``scale`` is set."""

    storage: torch.dtype = torch.bfloat16
    accum: torch.dtype = torch.float32
    scale: Optional[float] = None

    def softmax_scale(self, head_dim: int) -> float:
        return (self.scale if self.scale is not None
                else 1.0 / math.sqrt(head_dim))


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


# The canonical benchmark shape of the reference drivers (B, H, L) and the
# head dims of its V1 and d-tiled tiers, as the JAX package names them
CANONICAL_B, CANONICAL_H, CANONICAL_L = 32, 8, 1024
CANONICAL_D_V1, CANONICAL_D_TILED = 32, 128
