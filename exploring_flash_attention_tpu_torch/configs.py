"""Config helpers of the PyTorch port.

Counterpart of ``exploring_flash_attention_tpu/configs.py``: only what the
generation path reads.  The Hopper kernels fix their own tiles in
``csrc/``, so the JAX package's tile-size knobs (``TileConfig``) come back
only when a kernel takes them as launch parameters.
"""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
