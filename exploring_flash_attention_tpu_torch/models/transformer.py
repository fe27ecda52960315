"""Flagship decoder LM of the port, single device: forward and training.

Counterpart of ``models/transformer.py`` in the JAX package: pre-RMSNorm,
GQA attention with half-split RoPE, SwiGLU FFN, tied embeddings, an
optional sliding window on every layer, the cross-entropy loss and the
train step.  Parameters are a plain dictionary with the JAX pytree's
structure and leaf shapes (``wq [E, H, d]``, ``wo [H, d, E]``, ...), so
both packages' weights map one to one.  Every attention call is
:func:`flash_attention` (kernel H1 on the card, and H3 in its backward),
causal (banded under ``ModelConfig.window``) or, for the encoder, without
a mask; projections, FFN and logits are ``torch.einsum``, as the JAX
package leaves them to XLA.

The sharded train step (``make_train_step(mesh=)``) runs one rank of a
``torch.distributed`` job over a (dp, tp, sp) ``DeviceMesh``
(``parallel/mesh.py``), as the JAX package's runs one device of its
``shard_map``: dp cuts the batch; tp cuts heads and FFN columns, with
Megatron's conjugate all-reduces (``models/parallel_layers.py``); sp cuts
the sequence, and attention runs the differentiable ring
(``parallel/ring.py``, H1 and H3 at traced positions), Ulysses for the
encoder, the one-hop tail for a window, or, with ``sp_attn="allgather"``,
K/V gathered over sp and masked at this shard's traced offset.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from exploring_flash_attention_tpu_torch.configs import TileConfig
from exploring_flash_attention_tpu_torch.models.parallel_layers import (
    f_tp,
    g_tp,
    gather_seq,
)
from exploring_flash_attention_tpu_torch.models.tree import tree_leaves
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
from exploring_flash_attention_tpu_torch.parallel.window import (
    sp_window_attention,
)

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
    # the attention ops' tiles: H1 reads block_q (128 rows here, its
    # default tile; 64 rows when block_q <= 64)
    tile: TileConfig = TileConfig(block_q=128, block_kv=128)
    norm_eps: float = 1e-5
    use_rope: bool = True
    rope_theta: float = 10000.0
    # sequence-parallel attention: "ring" rotates K/V shards (O(L_local)
    # memory both passes), "allgather" gathers K/V over sp (O(L), short
    # sequences only)
    sp_attn: str = "ring"
    # sliding-window (local) attention width of every layer, the query's
    # own position included; None = full causal.  Trains on H1's and H3's
    # band (O(L * window)) and serves on H6's (pages before the band are
    # never read)
    window: Optional[int] = None

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.use_rope and self.d_head % 2:
            raise ValueError("RoPE needs an even d_head")
        if self.sp_attn not in ("ring", "allgather"):
            raise ValueError(f"unknown sp_attn {self.sp_attn!r}")
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


def flagship_config() -> ModelConfig:
    """The flagship LM that the JAX package's ``bench/suite.py``
    (``bench_generate_e2e``) serves, at full width and depth, in bf16."""
    return ModelConfig(
        vocab_size=32768, n_layers=4, n_heads=8, n_kv_heads=4, d_model=1024,
        d_head=128, d_ff=4096, dtype=torch.bfloat16,
    )


def long_context_config() -> ModelConfig:
    """The windowed LM of the JAX package's long-context training entry
    (``bench/suite.py:1019-1024``), at full width and depth, in bf16: the
    flagship's layers with a 2048-token vocabulary (the f32 logits of
    32,768 positions bound its memory) and a window of 4096."""
    return ModelConfig(
        vocab_size=2048, n_layers=4, n_heads=8, n_kv_heads=4, d_model=1024,
        d_head=128, d_ff=4096, dtype=torch.bfloat16, window=4096,
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
                causal: bool = True, tp_axis=None, sp_axis=None
                ) -> torch.Tensor:
    """x: [B, L_local, E] -> the attention branch's residual update; causal
    (within ``config.window`` of each position, if set) or, for the
    encoder, bidirectional.  A window without ``causal`` raises
    ``NotImplementedError``, as the JAX package's ``_attn_block`` does.

    ``tp_axis`` and ``sp_axis`` are the mesh's groups inside the sharded
    step (None on one device): x is replicated over tp and this rank's
    sequence block over sp.  Routing as JAX's (``:142-235``): RoPE at
    global positions; bidirectional: Ulysses, or K/V gathered when the
    heads do not split over sp; a window: the one-hop tail; causal: the
    ring, or with ``sp_attn="allgather"`` K/V gathered and the causal mask
    at this shard's traced offset.  Every route takes ``config.tile``, as
    JAX's passes ``c.tile``."""
    c = config
    if not causal and c.window is not None:
        raise NotImplementedError(
            "windows are causal-only (encoder models use window=None)")
    h = _rmsnorm(x, p["ln1"], c.norm_eps)
    # Megatron's f between the replicated norm and the column-parallel
    # projections: the norm's gradient sees the tp-summed cotangent
    if tp_axis is not None:
        h = f_tp(h, tp_axis)
    q = torch.einsum("ble,ehd->bhld", h, p["wq"])
    k = torch.einsum("ble,ehd->bhld", h, p["wk"])
    v = torch.einsum("ble,ehd->bhld", h, p["wv"])
    l_local = x.shape[1]
    pos0 = 0 if sp_axis is None else dist.get_rank(sp_axis) * l_local
    if c.use_rope:
        pos = pos0 + torch.arange(l_local, device=x.device)
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
    if sp_axis is None:
        o = flash_attention(q, k, v, config=c.tile, causal=causal,
                            window=c.window)
    elif not causal:
        n = dist.get_world_size(sp_axis)
        if q.shape[1] % n == 0 and k.shape[1] % n == 0:
            o = ulysses_flash_attention(q, k, v, sp_axis, c.tile, None, False)
        else:
            o = flash_attention(q, gather_seq(k, sp_axis, 2),
                                gather_seq(v, sp_axis, 2), config=c.tile,
                                causal=False)
    elif c.window is not None:
        o = sp_window_attention(q, k, v, sp_axis, c.window, c.tile)
    elif c.sp_attn == "ring":
        o = ring_flash_attention(q, k, v, sp_axis, c.tile, None, True)
    else:
        # all-gather: q stays local, K/V gathered (reduce-scattered
        # backward), the causal mask at this shard's traced offset
        positions = tuple(torch.full((), p0, dtype=torch.int32,
                                     device=x.device) for p0 in (pos0, 0))
        o = flash_attention(q, gather_seq(k, sp_axis, 2),
                            gather_seq(v, sp_axis, 2), config=c.tile,
                            causal=True, positions=positions)
    out = torch.einsum("bhld,hde->ble", o.to(x.dtype), p["wo"])
    return out if tp_axis is None else g_tp(out, tp_axis)


def _mlp_block(p: Params, x: torch.Tensor, config: ModelConfig,
               tp_axis=None) -> torch.Tensor:
    h = _rmsnorm(x, p["ln2"], config.norm_eps)
    if tp_axis is not None:
        h = f_tp(h, tp_axis)
    gate = torch.einsum("ble,ef->blf", h, p["w_gate"])
    up = torch.einsum("ble,ef->blf", h, p["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    out = torch.einsum("blf,fe->ble", act, p["w_down"])
    return out if tp_axis is None else g_tp(out, tp_axis)


def forward(params: Params, tokens: torch.Tensor, config: ModelConfig,
            tp_axis=None, sp_axis=None, causal: bool = True
            ) -> torch.Tensor:
    """Logits f32 [B, L, V] of a forward over int tokens [B, L]: causal, or
    with ``causal=False`` the same stack bidirectionally (the encoder,
    ``models/encoder.py``), as the JAX package's ``forward`` (``:242-263``).
    Inside the sharded step, ``tp_axis`` / ``sp_axis`` are the mesh's
    groups and tokens this rank's [B/dp, L/sp] block."""
    x = params["embed"][tokens.long()].to(config.dtype)
    for p in params["layers"]:
        x = x + _attn_block(p, x, config, causal, tp_axis, sp_axis)
        x = x + _mlp_block(p, x, config, tp_axis)
    x = _rmsnorm(x, params["ln_f"], config.norm_eps)
    return torch.einsum("ble,ve->blv", x,
                        params["embed"].to(config.dtype)).float()


def loss_fn(params: Params, inputs: torch.Tensor, targets: torch.Tensor,
            config: ModelConfig, tp_axis=None, sp_axis=None) -> torch.Tensor:
    """Mean next-token cross-entropy over f32 logits: an f32 scalar.  The
    counterpart of the JAX package's ``loss_fn`` (``:266-277``, optax's
    integer-label softmax cross-entropy, then the mean)."""
    logits = forward(params, inputs, config, tp_axis, sp_axis)
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
    """The parameter tensors of any of the port's parameter trees (LM,
    encoder, seq2seq) in ``jax.tree.leaves`` order (``tree_leaves``); for
    the LM that is :func:`named_param_leaves` order."""
    return tree_leaves(params)


def make_trainable(params: Params) -> Params:
    """Set ``requires_grad`` on every leaf of ``params`` (any of the port's
    parameter trees), in place; returns ``params``."""
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


def adam(leaves: Iterable[torch.Tensor], lr: float = 1e-3
         ) -> torch.optim.Optimizer:
    """``torch.optim.Adam`` with ``optax.adam``'s defaults set explicitly:
    betas (0.9, 0.999), eps 1e-8, no weight decay."""
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def make_optimizer_init(optimizer: Optional[OptimizerFactory],
                        learning_rate: float,
                        default: Callable[..., torch.optim.Optimizer] = adamw
                        ) -> Callable[[Params], torch.optim.Optimizer]:
    """The ``optimizer_init`` of the train steps: it sets ``requires_grad``
    on the leaves of ``params`` (in place) and returns ``optimizer`` over
    :func:`param_leaves`, ``default`` (:func:`adamw`) at ``learning_rate``
    when ``optimizer`` is None."""
    if optimizer is None:
        optimizer = functools.partial(default, lr=learning_rate)

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
    """Returns ``(train_step, optimizer_init)``: the train step of the JAX
    package (``:280-344``).

    ``optimizer_init(params)`` sets ``requires_grad`` on the leaves of
    ``params`` (in place) and returns ``optimizer(param_leaves(params))``.
    ``optimizer`` is any factory from that leaf list to a torch optimizer
    (SGD in the tests); the default is :func:`adamw` at ``learning_rate``.

    ``train_step(params, opt, tokens)`` takes int tokens ``[B, L+1]`` (a
    tensor or an array), runs the forward on ``tokens[:, :-1]`` against the
    targets ``tokens[:, 1:]``, the backward and one ``opt.step()``, and
    returns the loss (an f32 scalar tensor, detached, not synchronized).
    Unlike the JAX step, which returns new params and optimizer state, it
    updates ``params`` and ``opt`` in place.

    With a ``mesh`` (``parallel.make_mesh``), every rank calls the step on
    the same global tokens with its tp slices of the parameters
    (:func:`shard_params`) and an optimizer over them: it takes its dp rows
    and its sp block of the sequence, averages the gradients and the loss
    over dp and sp (``all_reduce``, JAX's ``pmean``) and steps its own
    optimizer; the returned loss is the global mean."""
    optimizer_init = make_optimizer_init(optimizer, learning_rate)
    if mesh is None:
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

    check_mesh(mesh)
    tp_g, sp_g = mesh.get_group("tp"), mesh.get_group("sp")

    def train_step(params: Params, opt: torch.optim.Optimizer,
                   tokens) -> torch.Tensor:
        tokens = dp_rows(torch.as_tensor(tokens,
                                         device=params["embed"].device), mesh)
        l_local = (tokens.shape[1] - 1) // axis_size(mesh, "sp")
        start = mesh.get_local_rank("sp") * l_local
        inputs = tokens[:, start:start + l_local]
        targets = tokens[:, start + 1:start + 1 + l_local]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, inputs, targets, config, tp_g, sp_g)
        loss.backward()
        loss = reduce_over_data(mesh, [p.grad for p in param_leaves(params)],
                                loss.detach(), mean=True)
        opt.step()
        return loss

    return train_step, optimizer_init


def dp_rows(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of global ``tokens``: the ``dp`` index's block of
    the batch, as JAX's ``P("dp", None)`` hands it to the device."""
    n = axis_size(mesh, "dp")
    if tokens.shape[0] % n:
        raise ValueError(f"a batch of {tokens.shape[0]} does not split over "
                         f"{n} dp ranks")
    return tokens.chunk(n)[mesh.get_local_rank("dp")]


def reduce_over_data(mesh, grads: List[torch.Tensor], loss: torch.Tensor,
                     mean: bool) -> torch.Tensor:
    """Sum (or average, with ``mean``) ``grads``, in place, and ``loss``
    over the dp and sp axes, which both cut the token stream: JAX's
    ``psum`` / ``pmean`` over ``("dp", "sp")``, as one all-reduce a group
    of one flat f32 buffer.  Returns the reduced loss."""
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.reshape(1).float()])
    for axis in ("dp", "sp"):
        dist.all_reduce(flat, group=mesh.get_group(axis))
    if mean:
        flat /= axis_size(mesh, "dp") * axis_size(mesh, "sp")
    for g, part in zip(grads, flat.split([g.numel() for g in grads] + [1])):
        g.copy_(part.view_as(g))
    return flat[-1].to(loss.dtype)


def param_spec(config: ModelConfig) -> Params:
    """The dim each parameter is cut along over tp (None: replicated), in
    the parameters' structure: heads of wq/wk/wv/wo and FFN columns, as the
    JAX package's ``param_spec`` (``:347-364``) shards them."""
    layer = {"ln1": None, "ln2": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
             "w_gate": 1, "w_up": 1, "w_down": 0}
    return {"embed": None, "ln_f": None,
            "layers": [dict(layer) for _ in range(config.n_layers)]}


def shard_params(params: Params, mesh, config: ModelConfig) -> Params:
    """This rank's tp slices of the full ``params`` (copies), to train with
    the sharded step; ``parallel.mesh.gather_tree`` with
    :func:`param_spec` puts them back together."""
    return shard_tree(params, param_spec(config), mesh)
