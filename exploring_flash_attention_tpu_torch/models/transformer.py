"""Flagship decoder LM of the port, single device.

Counterpart of ``models/transformer.py`` in the JAX package: pre-RMSNorm,
GQA attention with half-split RoPE, SwiGLU FFN, tied embeddings.
Parameters are a plain dictionary with the JAX pytree's structure and leaf
shapes (``wq [E, H, d]``, ``wo [H, d, E]``, ...), so both packages' weights
map one to one.  Every attention call is :func:`flash_attention` (kernel H1
on the card); projections, FFN and logits are ``torch.einsum``, as the JAX
package leaves them to XLA.  The mesh and sequence-parallel paths are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
                device: torch.device | str = "cpu") -> Params:
    """Random weights drawn from ``np.random.default_rng(seed)`` in the JAX
    package's order, so both packages build the same f32 weights."""
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


def _attn_block(p: Params, x: torch.Tensor, config: ModelConfig
                ) -> torch.Tensor:
    """x: [B, L, E] -> the attention branch's residual update."""
    c = config
    h = _rmsnorm(x, p["ln1"], c.norm_eps)
    q = torch.einsum("ble,ehd->bhld", h, p["wq"])
    k = torch.einsum("ble,ehd->bhld", h, p["wk"])
    v = torch.einsum("ble,ehd->bhld", h, p["wv"])
    if c.use_rope:
        pos = torch.arange(x.shape[1], device=x.device)
        q = rope(q, pos, c.rope_theta)
        k = rope(k, pos, c.rope_theta)
    o = flash_attention(q, k, v, causal=True)
    return torch.einsum("bhld,hde->ble", o.to(x.dtype), p["wo"])


def _mlp_block(p: Params, x: torch.Tensor, config: ModelConfig
               ) -> torch.Tensor:
    h = _rmsnorm(x, p["ln2"], config.norm_eps)
    gate = torch.einsum("ble,ef->blf", h, p["w_gate"])
    up = torch.einsum("ble,ef->blf", h, p["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    return torch.einsum("blf,fe->ble", act, p["w_down"])


def forward(params: Params, tokens: torch.Tensor, config: ModelConfig
            ) -> torch.Tensor:
    """Logits f32 [B, L, V] of a causal forward over int tokens [B, L]."""
    x = params["embed"][tokens.long()].to(config.dtype)
    for p in params["layers"]:
        x = x + _attn_block(p, x, config)
        x = x + _mlp_block(p, x, config)
    x = _rmsnorm(x, params["ln_f"], config.norm_eps)
    return torch.einsum("ble,ve->blv", x,
                        params["embed"].to(config.dtype)).float()
