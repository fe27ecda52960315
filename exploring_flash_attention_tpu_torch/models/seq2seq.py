"""Encoder-decoder (seq2seq) model family of the port, single device.

Counterpart of ``models/seq2seq.py`` in the JAX package:

    encoder : bidirectional self-attention over the source (kernel H1
              without a mask on the card, H3 without a mask backward)
    decoder : causal self-attention over the target, then cross attention
              of the decoder's queries against the encoder's memory
              (Lq = L_tgt, Lkv = L_src, no mask, no positions: H1 and H3
              without a mask at Lq != Lkv), then the SwiGLU FFN

RoPE rotates the self-attention q/k at their own positions; the cross
attention is position-free (T5's convention).  The encoder and decoder
stacks are separate, the embedding is shared and tied to the logits, and
the loss is teacher-forcing cross-entropy over the target.  Parameters
have the JAX pytree's structure and leaf shapes, and ``init_seq2seq_params``
draws the JAX package's NumPy numbers in its order, so a seed gives the
same weights in both packages.  Every attention is :func:`flash_attention`,
differentiable through H3.  The sharded step (``mesh``) and
``seq2seq_param_spec`` are not ported: they come with the multi-GPU port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from exploring_flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    OptimizerFactory,
    Params,
    _mlp_block,
    _rmsnorm,
    adam,
    make_optimizer_init,
    rope,
)
from exploring_flash_attention_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """One config drives both stacks; ``n_enc_layers`` / ``n_dec_layers``
    split the depth.  ``base`` supplies the shared shape knobs (heads,
    widths, dtype); its ``n_layers`` is not read."""
    base: ModelConfig = ModelConfig()
    n_enc_layers: int = 2
    n_dec_layers: int = 2

    def __post_init__(self):
        if self.base.window is not None:
            raise ValueError("seq2seq does not support sliding windows")


def init_seq2seq_params(config: Seq2SeqConfig, seed: int = 0,
                        device: torch.device | str = "cuda") -> Params:
    """Random weights from ``np.random.default_rng(seed)``, drawn in the JAX
    package's order (``:98-125``), on ``device`` (the card by default)."""
    rng = np.random.default_rng(seed)
    c = config.base

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=c.dtype)

    def dense(*shape):
        return put(rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape))

    def ones():
        return torch.ones(c.d_model, dtype=c.dtype, device=device)

    def attn():
        return {
            "wq": dense(c.d_model, c.n_heads, c.d_head),
            "wk": dense(c.d_model, c.n_kv_heads, c.d_head),
            "wv": dense(c.d_model, c.n_kv_heads, c.d_head),
            "wo": dense(c.n_heads * c.d_head, c.d_model).reshape(
                c.n_heads, c.d_head, c.d_model),
        }

    def mlp():
        return {
            "ln2": ones(),
            "w_gate": dense(c.d_model, c.d_ff),
            "w_up": dense(c.d_model, c.d_ff),
            "w_down": dense(c.d_ff, c.d_model),
        }

    enc_layers = [{"ln1": ones(), **attn(), **mlp()}
                  for _ in range(config.n_enc_layers)]
    dec_layers = []
    for _ in range(config.n_dec_layers):
        layer = {"ln1": ones(), **attn()}
        layer["ln_x"] = ones()
        layer["cross"] = attn()
        layer.update(mlp())
        dec_layers.append(layer)
    return {
        "embed": put(rng.normal(0.0, 0.02, (c.vocab_size, c.d_model))),
        "ln_enc": ones(),
        "ln_f": ones(),
        "enc_layers": enc_layers,
        "dec_layers": dec_layers,
    }


def _qkv(p: Params, h: torch.Tensor, kv_src: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project h -> q and (kv_src or h) -> k, v as [B, H, L, d]."""
    kv_in = h if kv_src is None else kv_src
    q = torch.einsum("ble,ehd->bhld", h, p["wq"])
    k = torch.einsum("ble,ehd->bhld", kv_in, p["wk"])
    v = torch.einsum("ble,ehd->bhld", kv_in, p["wv"])
    return q, k, v


def _self_attn(p: Params, x: torch.Tensor, c: ModelConfig,
               causal: bool) -> torch.Tensor:
    h = _rmsnorm(x, p["ln1"], c.norm_eps)
    q, k, v = _qkv(p, h)
    if c.use_rope:
        pos = torch.arange(x.shape[1], device=x.device)
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
    o = flash_attention(q, k, v, causal=causal)
    return torch.einsum("bhld,hde->ble", o.to(x.dtype), p["wo"])


def _cross_attn(p: Params, x: torch.Tensor, memory: torch.Tensor,
                c: ModelConfig) -> torch.Tensor:
    """Decoder queries against encoder memory: Lq = L_tgt, Lkv = L_src, no
    mask, no positions."""
    h = _rmsnorm(x, p["ln_x"], c.norm_eps)
    q, k, v = _qkv(p["cross"], h, kv_src=memory)
    o = flash_attention(q, k, v, causal=False)
    return torch.einsum("bhld,hde->ble", o.to(x.dtype), p["cross"]["wo"])


def encode(params: Params, src_tokens: torch.Tensor,
           config: Seq2SeqConfig) -> torch.Tensor:
    """Encoder memory [B, L_src, E]: bidirectional self-attention."""
    c = config.base
    x = params["embed"][src_tokens.long()].to(c.dtype)
    for p in params["enc_layers"]:
        x = x + _self_attn(p, x, c, causal=False)
        x = x + _mlp_block(p, x, c)
    return _rmsnorm(x, params["ln_enc"], c.norm_eps)


def decode(params: Params, tgt_tokens: torch.Tensor, memory: torch.Tensor,
           config: Seq2SeqConfig) -> torch.Tensor:
    """Decoder logits f32 [B, L_tgt, V]: causal self-attention, cross
    attention, MLP per layer."""
    c = config.base
    x = params["embed"][tgt_tokens.long()].to(c.dtype)
    for p in params["dec_layers"]:
        x = x + _self_attn(p, x, c, causal=True)
        x = x + _cross_attn(p, x, memory, c)
        x = x + _mlp_block(p, x, c)
    x = _rmsnorm(x, params["ln_f"], c.norm_eps)
    return torch.einsum("ble,ve->blv", x, params["embed"].to(c.dtype)).float()


def seq2seq_forward(params: Params, src_tokens: torch.Tensor,
                    tgt_tokens: torch.Tensor,
                    config: Seq2SeqConfig) -> torch.Tensor:
    """Logits f32 [B, L_tgt, V] of the target given the source."""
    return decode(params, tgt_tokens, encode(params, src_tokens, config),
                  config)


def seq2seq_loss(params: Params, src_tokens: torch.Tensor,
                 tgt_tokens: torch.Tensor,
                 config: Seq2SeqConfig) -> torch.Tensor:
    """Teacher-forcing cross-entropy (f32 scalar): predict tgt[:, t+1] from
    tgt[:, :t+1] and the source; ``tgt_tokens`` is [B, L_tgt + 1]."""
    logits = seq2seq_forward(params, src_tokens, tgt_tokens[:, :-1], config)
    return F.cross_entropy(logits.flatten(0, 1),
                           tgt_tokens[:, 1:].flatten().long())


def make_seq2seq_train_step(
    config: Seq2SeqConfig,
    learning_rate: float = 3e-3,
    optimizer: Optional[OptimizerFactory] = None,
    mesh: Optional[Any] = None,
) -> Tuple[Callable[..., torch.Tensor],
           Callable[[Params], torch.optim.Optimizer]]:
    """Returns ``(train_step, optimizer_init)``: the JAX package's
    single-device seq2seq step (``:298-325``).

    ``optimizer_init(params)`` sets ``requires_grad`` on every leaf (in
    place) and returns ``optimizer(param_leaves(params))``, by default
    Adam at ``learning_rate`` with optax's defaults (``transformer.adam``).
    ``train_step(params, opt, src, tgt)`` takes int tokens src [B, L_src]
    and tgt [B, L_tgt + 1], runs :func:`seq2seq_loss`, the backward and one
    ``opt.step()``, and returns the loss (detached, not synchronized); it
    updates ``params`` and ``opt`` in place where the JAX step returns new
    ones.  A ``mesh`` raises ``NotImplementedError``: the sharded step
    comes with the multi-GPU port (A9)."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded seq2seq train step is not ported yet (A9)")
    optimizer_init = make_optimizer_init(optimizer, learning_rate,
                                         default=adam)

    def train_step(params: Params, opt: torch.optim.Optimizer, src,
                   tgt) -> torch.Tensor:
        dev = params["embed"].device
        src = torch.as_tensor(src, device=dev)
        tgt = torch.as_tensor(tgt, device=dev)
        opt.zero_grad(set_to_none=True)
        loss = seq2seq_loss(params, src, tgt, config)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step, optimizer_init
