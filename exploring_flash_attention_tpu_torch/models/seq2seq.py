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
differentiable through H3.  The sharded step (``mesh``) runs as the
decoder-only one does (``models/transformer.py``): tp cuts every
attention and FFN, sp cuts both the source and the target, the decoder's
causal self-attention runs the ring and the encoder's and the cross
attention run Ulysses (K/V gathered when the heads do not split).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from exploring_flash_attention_tpu_torch.models.parallel_layers import (
    f_tp,
    g_tp,
    gather_seq,
)
from exploring_flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    OptimizerFactory,
    Params,
    _mlp_block,
    _rmsnorm,
    adam,
    dp_rows,
    make_optimizer_init,
    param_leaves,
    reduce_over_data,
    rope,
)
from exploring_flash_attention_tpu_torch.ops.attention import flash_attention
from exploring_flash_attention_tpu_torch.parallel.mesh import (
    axis_size,
    check_mesh,
    shard_tree,
)
from exploring_flash_attention_tpu_torch.parallel.ring import (
    ring_flash_attention,
)
from exploring_flash_attention_tpu_torch.parallel.ulysses import (
    ulysses_flash_attention,
)


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


def _sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  c: ModelConfig, causal: bool, sp_axis) -> torch.Tensor:
    """Attention of (possibly) sequence-sharded q/k/v, as the JAX package's
    ``_sp_attention`` routes it: one device; the ring for causal shards;
    Ulysses for bidirectional and cross-length ones, or K/V gathered when
    the heads do not split over sp.  Every route takes ``c.tile``."""
    if sp_axis is None:
        return flash_attention(q, k, v, config=c.tile, causal=causal)
    if causal:
        return ring_flash_attention(q, k, v, sp_axis, c.tile, None, True)
    n = dist.get_world_size(sp_axis)
    if q.shape[1] % n == 0 and k.shape[1] % n == 0:
        return ulysses_flash_attention(q, k, v, sp_axis, c.tile, None, False)
    return flash_attention(q, gather_seq(k, sp_axis, 2),
                           gather_seq(v, sp_axis, 2), config=c.tile,
                           causal=False)


def _self_attn(p: Params, x: torch.Tensor, c: ModelConfig, causal: bool,
               tp_axis=None, sp_axis=None) -> torch.Tensor:
    h = _rmsnorm(x, p["ln1"], c.norm_eps)
    if tp_axis is not None:
        h = f_tp(h, tp_axis)          # the norm's grad needs the tp sum
    q, k, v = _qkv(p, h)
    if c.use_rope:
        pos0 = 0 if sp_axis is None else dist.get_rank(sp_axis) * x.shape[1]
        pos = pos0 + torch.arange(x.shape[1], device=x.device)
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
    o = _sp_attention(q, k, v, c, causal, sp_axis)
    out = torch.einsum("bhld,hde->ble", o.to(x.dtype), p["wo"])
    return out if tp_axis is None else g_tp(out, tp_axis)


def _cross_attn(p: Params, x: torch.Tensor, memory: torch.Tensor,
                c: ModelConfig, tp_axis=None, sp_axis=None) -> torch.Tensor:
    """Decoder queries against encoder memory: Lq = L_tgt, Lkv = L_src, no
    mask, no positions.  Under sp each side carries its own sequence
    block, and Ulysses gathers each side's own length."""
    h = _rmsnorm(x, p["ln_x"], c.norm_eps)
    if tp_axis is not None:
        h = f_tp(h, tp_axis)
        memory = f_tp(memory, tp_axis)
    q, k, v = _qkv(p["cross"], h, kv_src=memory)
    o = _sp_attention(q, k, v, c, False, sp_axis)
    out = torch.einsum("bhld,hde->ble", o.to(x.dtype), p["cross"]["wo"])
    return out if tp_axis is None else g_tp(out, tp_axis)


def encode(params: Params, src_tokens: torch.Tensor, config: Seq2SeqConfig,
           tp_axis=None, sp_axis=None) -> torch.Tensor:
    """Encoder memory [B, L_src, E]: bidirectional self-attention."""
    c = config.base
    x = params["embed"][src_tokens.long()].to(c.dtype)
    for p in params["enc_layers"]:
        x = x + _self_attn(p, x, c, False, tp_axis, sp_axis)
        x = x + _mlp_block(p, x, c, tp_axis)
    return _rmsnorm(x, params["ln_enc"], c.norm_eps)


def decode(params: Params, tgt_tokens: torch.Tensor, memory: torch.Tensor,
           config: Seq2SeqConfig, tp_axis=None, sp_axis=None
           ) -> torch.Tensor:
    """Decoder logits f32 [B, L_tgt, V]: causal self-attention, cross
    attention, MLP per layer."""
    c = config.base
    x = params["embed"][tgt_tokens.long()].to(c.dtype)
    for p in params["dec_layers"]:
        x = x + _self_attn(p, x, c, True, tp_axis, sp_axis)
        x = x + _cross_attn(p, x, memory, c, tp_axis, sp_axis)
        x = x + _mlp_block(p, x, c, tp_axis)
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
    ones.

    With a ``mesh`` (``:298-363`` of the JAX package), every rank calls the
    step on the same global src and tgt with its tp slices of the
    parameters (:func:`shard_seq2seq_params`): it takes its dp rows and
    its sp block of both sequences, and averages the gradients and the
    loss over dp and sp."""
    optimizer_init = make_optimizer_init(optimizer, learning_rate,
                                         default=adam)
    if mesh is not None:
        return _sharded_seq2seq_step(config, mesh), optimizer_init

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


def _sharded_seq2seq_step(config: Seq2SeqConfig, mesh
                          ) -> Callable[..., torch.Tensor]:
    check_mesh(mesh)
    tp_g, sp_g = mesh.get_group("tp"), mesh.get_group("sp")
    sp, sp_idx = axis_size(mesh, "sp"), mesh.get_local_rank("sp")

    def train_step(params: Params, opt: torch.optim.Optimizer, src,
                   tgt) -> torch.Tensor:
        dev = params["embed"].device
        src = dp_rows(torch.as_tensor(src, device=dev), mesh)
        tgt = dp_rows(torch.as_tensor(tgt, device=dev), mesh)
        ls, lt = src.shape[1] // sp, (tgt.shape[1] - 1) // sp
        src_l = src[:, sp_idx * ls:(sp_idx + 1) * ls]
        tgt_in = tgt[:, sp_idx * lt:(sp_idx + 1) * lt]
        tgt_out = tgt[:, sp_idx * lt + 1:(sp_idx + 1) * lt + 1]
        opt.zero_grad(set_to_none=True)
        memory = encode(params, src_l, config, tp_g, sp_g)
        logits = decode(params, tgt_in, memory, config, tp_g, sp_g)
        loss = F.cross_entropy(logits.flatten(0, 1),
                               tgt_out.flatten().long())
        loss.backward()
        loss = reduce_over_data(mesh, [p.grad for p in param_leaves(params)],
                                loss.detach(), mean=True)
        opt.step()
        return loss

    return train_step


def seq2seq_param_spec(config: Seq2SeqConfig) -> Params:
    """The dim each parameter is cut along over tp (None: replicated):
    heads and FFN columns, norms and the embedding whole, as the JAX
    package's ``seq2seq_param_spec`` (``:266-295``)."""
    attn = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    mlp = {"ln2": None, "w_gate": 1, "w_up": 1, "w_down": 0}
    enc_layer = {"ln1": None, **attn, **mlp}
    dec_layer = {"ln1": None, **attn, "ln_x": None, "cross": dict(attn),
                 **mlp}
    return {"embed": None, "ln_enc": None, "ln_f": None,
            "enc_layers": [dict(enc_layer)
                           for _ in range(config.n_enc_layers)],
            "dec_layers": [dict(dec_layer)
                           for _ in range(config.n_dec_layers)]}


def shard_seq2seq_params(params: Params, mesh, config: Seq2SeqConfig
                         ) -> Params:
    """This rank's tp slices of the full seq2seq ``params`` (copies)."""
    return shard_tree(params, seq2seq_param_spec(config), mesh)
