"""Partial-attention primitives shared by every cross-rank strategy.

Counterpart of ``parallel/partials.py`` in the JAX package: the normalized
partial (O, LSE) of a local KV shard, :func:`attention_partial_local`
(kernel H1, at static or traced positions), and the associative LSE merge
that folds partials together, :func:`merge_partials`.  Both live in
``ops/attention.py``; the parallel package exports them from here, as the
JAX package's ``parallel/__init__.py`` does.
"""

from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    merge_partials,
)

__all__ = ["attention_partial_local", "merge_partials"]
