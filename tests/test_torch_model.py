"""Port flagship LM (single device) vs the JAX package.

Both packages draw their weights from ``np.random.default_rng(seed)`` in
the same order, so the f32 weights must be equal to the bit.  Logits are
compared in f32 at atol 1e-4: they are O(1) sums over d_model=128 after
two layers, and the two sides differ in summation order and in their
libm's cos/sin for RoPE (a few ulp)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    forward,
    init_params,
    params_from_jax,
    rope,
    trainable_params_from_jax,
)
from exploring_flash_attention_tpu_torch.serving import make_cache

KW = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=128,
          d_head=64, d_ff=256)
CFG = ModelConfig(**KW)
JCFG = jtf.ModelConfig(**KW, tile=JTileConfig(block_q=64, block_kv=64))


def _leaves(params):
    out = [params["embed"], params["ln_f"]]
    for layer in params["layers"]:
        out.extend(layer[name] for name in sorted(layer))
    return out


def test_init_params_equal_jax_bitwise():
    jp = jax.device_get(jtf.init_params(JCFG, seed=3))
    tp = init_params(CFG, seed=3, device="cpu")
    for j, t in zip(_leaves(jp), _leaves(tp), strict=True):
        assert t.dtype == torch.float32 and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_params_from_jax_keeps_values_and_dtypes():
    jcfg_bf16 = jtf.ModelConfig(**KW, dtype=jnp.bfloat16)
    jp = jax.device_get(jtf.init_params(jcfg_bf16, seed=0))
    tp = params_from_jax(jp, device="cpu")
    for j, t in zip(_leaves(jp), _leaves(tp), strict=True):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    tp32 = params_from_jax(jp, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in _leaves(tp32))


@pytest.mark.parametrize("seq_len", [32, 20])
def test_forward_logits_match_jax(seq_len):
    """32 takes the B4 route of the JAX prefill, 20 the B8 one."""
    jp = jtf.init_params(JCFG, seed=1)
    toks = np.random.default_rng(1).integers(
        0, KW["vocab_size"], (2, seq_len)).astype(np.int32)
    ref = np.asarray(jtf.forward(jp, jnp.asarray(toks), JCFG))
    got = forward(init_params(CFG, seed=1, device="cpu"),
                  torch.from_numpy(toks), CFG)
    assert got.shape == (2, seq_len, KW["vocab_size"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_forward_is_causal():
    params = init_params(CFG, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, KW["vocab_size"], (1, 16)))
    a = forward(params, toks, CFG)
    toks2 = toks.clone()
    toks2[0, 10:] = (toks2[0, 10:] + 1) % KW["vocab_size"]
    b = forward(params, toks2, CFG)
    torch.testing.assert_close(a[:, :10], b[:, :10], rtol=0, atol=1e-6)
    assert not torch.allclose(a[:, 10:], b[:, 10:])


def test_rope_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 4, 9, 64)).astype(
        np.float32)
    pos = np.arange(9, dtype=np.int32) + 100
    ref = np.asarray(jtf.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_model_config_validation():
    with pytest.raises(ValueError, match="divisible"):
        ModelConfig(n_heads=6, n_kv_heads=4)
    with pytest.raises(ValueError, match="even"):
        ModelConfig(d_head=63)


@pytest.mark.parametrize("window", [0, -1])
def test_model_config_refuses_a_window_below_one(window):
    """As JAX's ``ModelConfig`` (``models/transformer.py:82-83``)."""
    with pytest.raises(ValueError, match="window"):
        ModelConfig(window=window)
    with pytest.raises(ValueError, match="window"):
        jtf.ModelConfig(window=window)


def test_model_config_defaults_match_jax():
    """Every field the port's config shares with JAX's has its default,
    the new ``window`` (None, full causal) included, and the port has every
    field JAX's has; ``tile`` is each package's own ``TileConfig`` with the
    same field values."""
    import dataclasses

    theirs = {f.name: f.default for f in dataclasses.fields(jtf.ModelConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert "window" in ours and ours["window"] is None
    assert list(ours) == list(theirs)
    for name, default in ours.items():
        if name == "tile":
            assert (dataclasses.astuple(default)
                    == dataclasses.astuple(theirs[name])), name
        elif name != "dtype":         # a torch dtype on one side, jnp's on the other
            assert default == theirs[name], name


def test_windowed_forward_matches_jax_and_bidirectional_raises():
    """The windowed forward's logits against JAX's (L = 128, window 40;
    JAX's band forward takes lane-aligned lengths), a band that changes
    them, and a window without ``causal`` raising ``NotImplementedError``
    on both sides (an encoder has no window)."""
    cfg = ModelConfig(**KW, window=40)
    jcfg = jtf.ModelConfig(**KW, tile=JTileConfig(block_q=64, block_kv=64),
                           window=40)
    jp = jtf.init_params(jcfg, seed=6)
    toks = np.random.default_rng(6).integers(
        0, KW["vocab_size"], (2, 128)).astype(np.int32)
    ref = np.asarray(jtf.forward(jp, jnp.asarray(toks), jcfg))
    params = init_params(cfg, seed=6, device="cpu")
    got = forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    full = forward(params, torch.from_numpy(toks), CFG)
    torch.testing.assert_close(got[:, :40], full[:, :40], rtol=0, atol=1e-6)
    assert (got[:, 40:] - full[:, 40:]).abs().max() > 1e-3
    with pytest.raises(NotImplementedError, match="causal-only"):
        forward(params, torch.from_numpy(toks), cfg, causal=False)
    with pytest.raises(NotImplementedError, match="causal-only"):
        jtf.forward(jp, jnp.asarray(toks), jcfg, causal=False)



@pytest.mark.parametrize("fn", [init_params, params_from_jax,
                                trainable_params_from_jax, make_cache],
                         ids=lambda fn: fn.__name__)
def test_entry_points_default_to_the_card(fn):
    """The port's entry points run on the card unless the caller asks for
    the CPU (``device="cpu"``, as every CPU test passes)."""
    default = inspect.signature(fn).parameters["device"].default
    assert torch.device(default).type == "cuda"
