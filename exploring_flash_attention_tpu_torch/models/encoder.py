"""Bidirectional encoder (masked LM) of the port, single device.

Counterpart of ``models/encoder.py`` in the JAX package: the decoder's
stack (``models/transformer.py``) run with ``causal=False`` (kernel H1
without a mask on the card, and H3 without a mask in its backward), trained
with the masked-language-model objective::

    inputs = tokens with a drawn mask_rate of positions set to mask_token
    loss   = CE(logits, tokens) averaged over the masked positions only

The mask is drawn from an explicit ``torch.Generator``.  Its bits differ
from ``jax.random``'s for the same seed, so a comparison with the JAX
package hands both sides the same mask (``mask=``).  The sharded step
runs over a (dp, tp, sp) mesh as the decoder's does
(``models/transformer.py``), with bidirectional attention over sp through
Ulysses (``parallel/ulysses.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from exploring_flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    OptimizerFactory,
    Params,
    dp_rows,
    forward,
    make_optimizer_init,
    param_leaves,
    reduce_over_data,
)
from exploring_flash_attention_tpu_torch.parallel.mesh import (
    axis_size,
    check_mesh,
)


def mask_tokens(tokens: torch.Tensor, generator: torch.Generator,
                mask_token: int, mask_rate: float = 0.15
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked inputs, mask [B, L] bool): each position is masked with
    probability ``mask_rate``, drawn on the generator's device, and every
    masked position becomes ``mask_token`` (plain BERT masking, as the JAX
    package's ``mask_tokens``)."""
    draw = torch.rand(tokens.shape, generator=generator,
                      device=generator.device)
    mask = (draw < mask_rate).to(tokens.device)
    return torch.where(mask, mask_token, tokens), mask


def mlm_loss(params: Params, tokens: torch.Tensor,
             generator: Optional[torch.Generator], config: ModelConfig,
             mask_token: int, mask_rate: float = 0.15,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked-LM loss of clean int ``tokens`` [B, L]: an f32 scalar.

    The mask is drawn by :func:`mask_tokens` from ``generator``, unless
    ``mask`` (bool [B, L]) is given.  The bidirectional forward runs on the
    masked inputs; the cross-entropy against the clean tokens is summed
    over the masked positions and divided by their count (at least 1)."""
    if mask is None:
        inputs, mask = mask_tokens(tokens, generator, mask_token, mask_rate)
    else:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=tokens.device)
        inputs = torch.where(mask, mask_token, tokens)
    logits = forward(params, inputs, config, causal=False)
    ce = F.cross_entropy(logits.flatten(0, 1), tokens.flatten().long(),
                         reduction="none").view(tokens.shape)
    return torch.where(mask, ce, 0.0).sum() / mask.sum().clamp(min=1)


def make_mlm_train_step(
    config: ModelConfig,
    mask_token: Optional[int] = None,
    mask_rate: float = 0.15,
    learning_rate: float = 1e-3,
    optimizer: Optional[OptimizerFactory] = None,
    mesh: Optional[Any] = None,
) -> Tuple[Callable[..., torch.Tensor],
           Callable[[Params], torch.optim.Optimizer]]:
    """Returns ``(train_step, optimizer_init)``: the JAX package's
    single-device MLM step (``models/encoder.py:64-96``), with its defaults.

    ``mask_token`` defaults to ``vocab_size - 1``.  ``optimizer_init`` and
    ``optimizer`` are :func:`~.transformer.make_train_step`'s (the default is
    AdamW at ``learning_rate`` with optax's defaults).
    ``train_step(params, opt, tokens, generator, mask=None)`` takes clean
    int tokens ``[B, L]``, draws the mask from ``generator`` (or takes
    ``mask``), runs :func:`mlm_loss`, the backward and one ``opt.step()``,
    and returns the loss (detached, not synchronized).  It updates
    ``params`` and ``opt`` in place, where the JAX step returns new ones.

    With a ``mesh`` (``:100-140`` of the JAX package), every rank calls the
    step on the same global tokens, generator state or ``mask`` (the mask
    is drawn at the global shape, so every rank draws the same), with its
    tp slices of the parameters; it takes its dp rows and sp block, divides
    its masked cross-entropy by the global masked count, and sums the
    gradients and the loss over dp and sp (JAX's ``psum``)."""
    optimizer_init = make_optimizer_init(optimizer, learning_rate)
    mtok = config.vocab_size - 1 if mask_token is None else mask_token
    if mesh is not None:
        return _sharded_mlm_step(config, mesh, mtok, mask_rate), \
            optimizer_init

    def train_step(params: Params, opt: torch.optim.Optimizer, tokens,
                   generator: Optional[torch.Generator],
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        opt.zero_grad(set_to_none=True)
        loss = mlm_loss(params, tokens, generator, config, mtok, mask_rate,
                        mask)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step, optimizer_init


def _sharded_mlm_step(config: ModelConfig, mesh, mtok: int,
                      mask_rate: float) -> Callable[..., torch.Tensor]:
    check_mesh(mesh)
    tp_g, sp_g = mesh.get_group("tp"), mesh.get_group("sp")

    def train_step(params: Params, opt: torch.optim.Optimizer, tokens,
                   generator: Optional[torch.Generator],
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        if mask is None:
            inputs, mask = mask_tokens(tokens, generator, mtok, mask_rate)
        else:
            mask = torch.as_tensor(mask, dtype=torch.bool,
                                   device=tokens.device)
            inputs = torch.where(mask, mtok, tokens)
        l_local = tokens.shape[1] // axis_size(mesh, "sp")
        cols = slice(mesh.get_local_rank("sp") * l_local,
                     (mesh.get_local_rank("sp") + 1) * l_local)
        inputs, tokens, mask = (dp_rows(x, mesh)[:, cols]
                                for x in (inputs, tokens, mask))
        denom = mask.sum().float().reshape(1)
        for axis in ("dp", "sp"):
            dist.all_reduce(denom, group=mesh.get_group(axis))
        opt.zero_grad(set_to_none=True)
        logits = forward(params, inputs, config, tp_g, sp_g, causal=False)
        ce = F.cross_entropy(logits.flatten(0, 1), tokens.flatten().long(),
                             reduction="none").view(tokens.shape)
        loss = torch.where(mask, ce, 0.0).sum() / denom.clamp(min=1)[0]
        loss.backward()
        loss = reduce_over_data(mesh, [p.grad for p in param_leaves(params)],
                                loss.detach(), mean=False)
        opt.step()
        return loss

    return train_step
