"""Weights from the JAX package into the port."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.models.transformer import (
    Params,
    make_trainable,
)
from exploring_flash_attention_tpu_torch.models.tree import tree_map


def params_from_jax(tree: Any, device: torch.device | str = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's params pytree, with its leaves as NumPy arrays
    (e.g. ``jax.device_get(params)``), as the port's parameters on
    ``device`` (the card by default), in ``dtype`` or else bf16 for bf16
    leaves and f32 for the rest.  Any nested dict/list tree converts leaf
    by leaf with its structure kept: the LM's and encoder's ``embed`` /
    ``layers`` / ``ln_f``, seq2seq's ``enc_layers``, ``dec_layers`` (with
    their ``cross`` blocks), ``ln_enc`` and ``ln_f``.

    Leaves go through f32, which is exact for f32 and bf16:
    ``torch.from_numpy`` refuses ml_dtypes' bf16 arrays."""

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        target = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16"
                           else torch.float32)
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=target)

    return tree_map(leaf, tree)


def trainable_params_from_jax(tree: Any, device: torch.device | str = "cuda",
                              dtype: Optional[torch.dtype] = None) -> Params:
    """:func:`params_from_jax` with ``requires_grad`` set on every leaf: the
    JAX package's params as the port's trainable parameters.  Their
    gradients and the optimizer follow ``param_leaves`` order, which is
    ``jax.tree.leaves``' order of the same tree."""
    return make_trainable(params_from_jax(tree, device=device, dtype=dtype))
