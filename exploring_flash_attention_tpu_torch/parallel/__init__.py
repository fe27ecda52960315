"""The multi-GPU paths of the port on ``torch.distributed``: the mesh,
the partial-attention primitives, ring, Ulysses and windowed
sequence-parallel attention, and the cross-rank split-KV combine.  Exports
what the JAX package's ``parallel/__init__.py`` exports."""

from exploring_flash_attention_tpu_torch.parallel.mesh import make_mesh
from exploring_flash_attention_tpu_torch.parallel.partials import (
    attention_partial_local,
    merge_partials,
)
from exploring_flash_attention_tpu_torch.parallel.ring import (
    ring_attention,
    ring_flash_attention,
)
from exploring_flash_attention_tpu_torch.parallel.splitkv_xhost import (
    splitkv_attention_xhost,
)
from exploring_flash_attention_tpu_torch.parallel.ulysses import (
    ulysses_attention,
)
from exploring_flash_attention_tpu_torch.parallel.window import (
    sp_window_attention,
)

__all__ = [
    "make_mesh",
    "attention_partial_local",
    "merge_partials",
    "ring_attention",
    "ring_flash_attention",
    "splitkv_attention_xhost",
    "sp_window_attention",
    "ulysses_attention",
]
