"""Flagship decoder LM of the port, single device: forward and training.

Counterpart of ``models/transformer.py`` in the JAX package: pre-RMSNorm,
GQA attention with half-split RoPE, SwiGLU FFN, tied embeddings, the
cross-entropy loss and the train step.  Parameters are a plain dictionary
with the JAX pytree's structure and leaf shapes (``wq [E, H, d]``,
``wo [H, d, E]``, ...), so both packages' weights map one to one.  Every
attention call is :func:`flash_attention` (kernel H1 on the card, and H3
in its backward), causal or, for the encoder, without a mask; projections,
FFN and logits are ``torch.einsum``, as the JAX package leaves them to
XLA.  The mesh and sequence-parallel paths are not ported.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from exploring_flash_attention_tpu_torch.ops.attention import flash_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 4096
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 8
    d_model: int = 512
    d_head: int = 64
    d_ff: int = 1024
    dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-5
    use_rope: bool = True
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.use_rope and self.d_head % 2:
            raise ValueError("RoPE needs an even d_head")


def flagship_config() -> ModelConfig:
    """The flagship LM that the JAX package's ``bench/suite.py``
    (``bench_generate_e2e``) serves, at full width and depth, in bf16."""
    return ModelConfig(
        vocab_size=32768, n_layers=4, n_heads=8, n_kv_heads=4, d_model=1024,
        d_head=128, d_ff=4096, dtype=torch.bfloat16,
    )


def init_params(config: ModelConfig, seed: int = 0,
                device: torch.device | str = "cuda") -> Params:
    """Random weights drawn from ``np.random.default_rng(seed)`` in the JAX
    package's order, so both packages build the same f32 weights; on the
    card unless ``device`` says otherwise (``"cpu"`` runs the plain
    paths)."""
    rng = np.random.default_rng(seed)
    c = config

    def put(a: np.ndarray) -> torch.Tensor:
        # f64 -> f32 on the host rounds as NumPy (and JAX) do
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=c.dtype)

    def dense(*shape):
        return put(rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape))

    def ones():
        return torch.ones(c.d_model, dtype=c.dtype, device=device)

    layers = []
    for _ in range(c.n_layers):
        layers.append({
            "ln1": ones(),
            "wq": dense(c.d_model, c.n_heads, c.d_head),
            "wk": dense(c.d_model, c.n_kv_heads, c.d_head),
            "wv": dense(c.d_model, c.n_kv_heads, c.d_head),
            "wo": dense(c.n_heads * c.d_head, c.d_model).reshape(
                c.n_heads, c.d_head, c.d_model),
            "ln2": ones(),
            "w_gate": dense(c.d_model, c.d_ff),
            "w_up": dense(c.d_model, c.d_ff),
            "w_down": dense(c.d_ff, c.d_model),
        })
    return {
        "embed": put(rng.normal(0.0, 0.02, (c.vocab_size, c.d_model))),
        "ln_f": ones(),
        "layers": layers,
    }


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding.  x: [..., L, d] (d even); pos: integer
    positions broadcastable to x's [..., L] prefix."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].float() * freqs                 # [..., L, half]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def _attn_block(p: Params, x: torch.Tensor, config: ModelConfig,
                causal: bool = True) -> torch.Tensor:
    """x: [B, L, E] -> the attention branch's residual update; causal or,
    for the encoder, bidirectional."""
    c = config
    h = _rmsnorm(x, p["ln1"], c.norm_eps)
    q = torch.einsum("ble,ehd->bhld", h, p["wq"])
    k = torch.einsum("ble,ehd->bhld", h, p["wk"])
    v = torch.einsum("ble,ehd->bhld", h, p["wv"])
    if c.use_rope:
        pos = torch.arange(x.shape[1], device=x.device)
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
    o = flash_attention(q, k, v, causal=causal)
    return torch.einsum("bhld,hde->ble", o.to(x.dtype), p["wo"])


def _mlp_block(p: Params, x: torch.Tensor, config: ModelConfig
               ) -> torch.Tensor:
    h = _rmsnorm(x, p["ln2"], config.norm_eps)
    gate = torch.einsum("ble,ef->blf", h, p["w_gate"])
    up = torch.einsum("ble,ef->blf", h, p["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    return torch.einsum("blf,fe->ble", act, p["w_down"])


def forward(params: Params, tokens: torch.Tensor, config: ModelConfig,
            causal: bool = True) -> torch.Tensor:
    """Logits f32 [B, L, V] of a forward over int tokens [B, L]: causal, or
    with ``causal=False`` the same stack bidirectionally (the encoder,
    ``models/encoder.py``), as the JAX package's ``forward`` (``:242-263``)."""
    x = params["embed"][tokens.long()].to(config.dtype)
    for p in params["layers"]:
        x = x + _attn_block(p, x, config, causal)
        x = x + _mlp_block(p, x, config)
    x = _rmsnorm(x, params["ln_f"], config.norm_eps)
    return torch.einsum("ble,ve->blv", x,
                        params["embed"].to(config.dtype)).float()


def loss_fn(params: Params, inputs: torch.Tensor, targets: torch.Tensor,
            config: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy over f32 logits: an f32 scalar.  The
    counterpart of the JAX package's ``loss_fn`` (``:266-277``, optax's
    integer-label softmax cross-entropy, then the mean)."""
    logits = forward(params, inputs, config)
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten().long())


def named_param_leaves(params: Params) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every parameter in ``jax.tree.leaves`` order
    (dictionary keys sorted: ``embed``, every layer's leaves by name,
    ``ln_f``): the order the optimizer and the tests share."""
    return ([("embed", params["embed"])]
            + [(f"layers.{i}.{name}", layer[name])
               for i, layer in enumerate(params["layers"])
               for name in sorted(layer)]
            + [("ln_f", params["ln_f"])])


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tensors in :func:`named_param_leaves` order."""
    return [leaf for _, leaf in named_param_leaves(params)]


def make_trainable(params: Params) -> Params:
    """Set ``requires_grad`` on every leaf of ``params``, in place; returns
    ``params``."""
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    return params


def adamw(leaves: Iterable[torch.Tensor], lr: float = 1e-3
          ) -> torch.optim.Optimizer:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults set explicitly:
    betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's own default
    decay is 1e-2)."""
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def make_optimizer_init(optimizer: Optional[OptimizerFactory],
                        learning_rate: float
                        ) -> Callable[[Params], torch.optim.Optimizer]:
    """The ``optimizer_init`` of the train steps: it sets ``requires_grad``
    on the leaves of ``params`` (in place) and returns ``optimizer`` over
    :func:`param_leaves`, :func:`adamw` at ``learning_rate`` by default."""
    if optimizer is None:
        optimizer = functools.partial(adamw, lr=learning_rate)

    def optimizer_init(params: Params) -> torch.optim.Optimizer:
        return optimizer(param_leaves(make_trainable(params)))

    return optimizer_init


def make_train_step(
    config: ModelConfig,
    mesh: Optional[Any] = None,
    learning_rate: float = 1e-3,
    optimizer: Optional[OptimizerFactory] = None,
) -> Tuple[Callable[..., torch.Tensor],
           Callable[[Params], torch.optim.Optimizer]]:
    """Returns ``(train_step, optimizer_init)``: the single-device train
    step of the JAX package (``:280-306``).

    ``optimizer_init(params)`` sets ``requires_grad`` on the leaves of
    ``params`` (in place) and returns ``optimizer(param_leaves(params))``.
    ``optimizer`` is any factory from that leaf list to a torch optimizer
    (SGD in the tests); the default is :func:`adamw` at ``learning_rate``.

    ``train_step(params, opt, tokens)`` takes int tokens ``[B, L+1]`` (a
    tensor or an array), runs the forward on ``tokens[:, :-1]`` against the
    targets ``tokens[:, 1:]``, the backward and one ``opt.step()``, and
    returns the loss (an f32 scalar tensor, detached, not synchronized).
    Unlike the JAX step, which returns new params and optimizer state, it
    updates ``params`` and ``opt`` in place.  The sharded step is not
    ported: a ``mesh`` raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError("the sharded train step is not ported yet")
    optimizer_init = make_optimizer_init(optimizer, learning_rate)

    def train_step(params: Params, opt: torch.optim.Optimizer,
                   tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, inputs, targets, config)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step, optimizer_init
