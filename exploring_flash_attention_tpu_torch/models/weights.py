"""Weights from the JAX package into the port."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.models.transformer import (
    Params,
    make_trainable,
)


def params_from_jax(tree: Any, device: torch.device | str = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's params pytree, with its leaves as NumPy arrays
    (e.g. ``jax.device_get(params)``), as the port's parameters on
    ``device`` (the card by default), in ``dtype`` or else bf16 for bf16
    leaves and f32 for the rest.

    Leaves go through f32, which is exact for f32 and bf16:
    ``torch.from_numpy`` refuses ml_dtypes' bf16 arrays."""

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        target = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16"
                           else torch.float32)
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=target)

    return {
        "embed": leaf(tree["embed"]),
        "ln_f": leaf(tree["ln_f"]),
        "layers": [{name: leaf(x) for name, x in layer.items()}
                   for layer in tree["layers"]],
    }


def trainable_params_from_jax(tree: Any, device: torch.device | str = "cuda",
                              dtype: Optional[torch.dtype] = None) -> Params:
    """:func:`params_from_jax` with ``requires_grad`` set on every leaf: the
    JAX package's params as the port's trainable parameters.  Their
    gradients and the optimizer follow ``param_leaves`` order, which is
    ``jax.tree.leaves``' order of the same tree."""
    return make_trainable(params_from_jax(tree, device=device, dtype=dtype))
