"""The training path at head dims that are not a multiple of 16, vs the
JAX package: ``flash_attention_bwd`` at d 1 to 250 (GQA 8/2, ragged and
cross), at traced positions, autograd through ``flash_attention``, and a
``d_head=72`` LM and encoder (SigLIP-so400m's and DiT-XL/2's heads).

The same NumPy f32 inputs go through the JAX function (Pallas in interpret
mode with small tiles, as ``tests/test_torch_bwd.py`` runs it) and through
the port's CPU path (``attention_bwd_plain``, autograd through the plain
forward), which H3-dkv and H3-dq stand for on the card at every d of
``ops.attention.NARROW_HEAD_DIM_RULE``: rows of a multiple of 16 bytes
by TMA, others by the producer warpgroup's staged loads (bf16 d % 8 != 0)
or a float at a time (f32 d % 4 != 0), the columns past d zero.

Tolerances, as ``tests/test_torch_bwd_heads.py``:
- each backward against f64 autograd first, atol 2e-4 rtol 2e-2
  (``ORACLE``), then the port against JAX, atol 1e-5 rtol 1e-4
  (``ROUTES``);
- a 2-layer model's loss atol 2e-5 (the encoder's 5e-5, as
  ``tests/test_torch_encoder.py``) and every gradient atol 2e-5 plus rtol
  1e-3.
The card's limits (``chip_smoke.py``: 2e-2 of max|ref| per gradient at
bf16, 1e-4 of max|g64| at f32) are rehearsed on CPU emulations of the
kernels' arithmetic (``tests/test_torch_bwd.py``'s bf16 roundings,
``tests/test_torch_bwd_f32.py``'s bf16x6 in the kernels' tile order, the
D=256 cluster's two column halves at d=250): the emulation reads within
half of each limit, and the same emulation on rows read one element late,
or with each row's last column dropped, beyond it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from f32_pieces import one_torch_thread  # noqa: F401 (autouse)
from test_torch_bwd import (
    ORACLE,
    ROUTES,
    _f64_forward,
    _f64_grads,
    _hidden,
    _inputs,
    _kernel_emulation,
)
from test_torch_bwd_f32 import _card_err, _emulate_h3_f32
from test_torch_traced import HOPS, _jtraced, _traced

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import encoder as jenc
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.ops import attention_bwd as jax_bwd_mod
from exploring_flash_attention_tpu.ops.attention_vjp import (
    flash_attention as jax_flash_attention,
)
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    loss_fn,
    mlm_loss,
    param_leaves,
    trainable_params_from_jax,
)
from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_plain,
    flash_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    attention_bwd_plain,
    flash_attention_bwd,
)

# d off the multiples of 16: 1 (scale 1, one column), bf16 rows of 2-byte
# alignment (33), 8-byte (36, 100), 4-byte (250) and 16-byte (40, 72)
ODD_DIMS = (1, 33, 36, 40, 72, 100, 250)
MASKS = {"none": (False, None), "causal": (True, None), "window": (True, 12)}
TILES = JTileConfig(block_q=16, block_kv=16, q_chunk=16)
GRAD_NAMES = ("dq", "dk", "dv")


def _against_f64_and_jax(port_grads, jax_grads, ref):
    for name, j, t, r in zip(GRAD_NAMES, jax_grads, port_grads, ref):
        assert t.dtype == torch.float32 and t.shape == r.shape
        np.testing.assert_allclose(np.asarray(j), r, **ORACLE,
                                   err_msg=f"jax {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), r, **ORACLE,
                                   err_msg=f"port {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **ROUTES,
                                   err_msg=f"port {name} vs jax")


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("d", ODD_DIMS)
def test_flash_attention_bwd_odd_head_dims_match_jax(d, mask):
    """``flash_attention_bwd`` at d 1 to 250 off the multiples of 16, GQA
    8/2, ragged and cross (Lq 24, Lkv 40), against JAX's
    ``flash_attention_bwd`` (16-row tiles), each side first against f64
    autograd; dK and dV come back summed over each group."""
    causal, window = MASKS[mask]
    q, k, v, do = _inputs(d, 1, 8, 2, 24, 40, d)
    o64, lse64 = _f64_forward(q, k, v, causal, 16, window)
    args = (q, k, v, o64.astype(np.float32), do, lse64.astype(np.float32))
    jax_bwd_mod.flash_attention_bwd.clear_cache()
    jax_grads = jax_bwd_mod.flash_attention_bwd(
        *(jnp.asarray(x) for x in args), config=TILES, causal=causal,
        window=window)
    port_grads = flash_attention_bwd(*(torch.from_numpy(x) for x in args),
                                     causal=causal, window=window)
    _against_f64_and_jax(port_grads, jax_grads,
                         _f64_grads(q, k, v, do, causal, 16, window))


@pytest.mark.parametrize("hop", list(HOPS))
@pytest.mark.parametrize("d", [72, 33])
def test_bwd_at_traced_positions_odd_head_dims_matches_jax(d, hop):
    """The backward of a ring hop (positions traced: 0-d int tensors) at d
    72 and 33, GQA 4/2, Lq 64 over Lkv 128, on the whole row's ``out`` and
    ``lse`` (finite where the hop shows no key), against JAX's traced
    backward; a hop wholly in the future gives zero gradients."""
    pos = HOPS[hop]
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (1, 4, 64, d), (1, 2, 128, d), (1, 2, 128, d)))
    out, do = (rng.standard_normal(q.shape).astype(np.float32)
               for _ in range(2))
    lse = (rng.standard_normal(q.shape[:3]) + 6.0).astype(np.float32)
    got = flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, out, do, lse)),
        causal=True, positions=_traced(pos))
    ref = jax_bwd_mod.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, out, do, lse)), causal=True,
        positions=_jtraced(pos))
    for g, r, name in zip(got, ref, GRAD_NAMES):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **ROUTES,
                                   err_msg=name)
    if hop == "future":
        assert all((g == 0).all() for g in got)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_through_flash_attention_d72_matches_jax_grad(causal):
    """``torch.autograd`` through the port's ``flash_attention`` (forward
    and backward) against ``jax.grad`` of JAX's at d=72, GQA 8/2, cross
    (Lq 24, Lkv 40)."""
    q, k, v, g = _inputs(72 + causal, 1, 8, 2, 24, 40, 72)

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, TILES,
                                           causal=causal) * g)

    jax_bwd_mod.flash_attention_bwd.clear_cache()
    jax_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal)
    port_grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                     (qt, kt, vt))
    _against_f64_and_jax(port_grads, jax_grads,
                         _f64_grads(q, k, v, g, causal, 16))


# 2-layer LMs at test_torch_train.py's widths with heads72's attention (16
# heads of 72 over 16 KV heads, here 4 over 4) and d=36 in a group of 2
MODELS = {"d72": dict(n_heads=4, n_kv_heads=4, d_head=72),
          "d36_group2": dict(n_heads=4, n_kv_heads=2, d_head=36)}


def _model_cfgs(geometry):
    kw = dict(vocab_size=128, n_layers=2, d_model=128, d_ff=256,
              **MODELS[geometry])
    return kw, jtf.ModelConfig(**kw, tile=TILES), ModelConfig(**kw)


def _grads_match(loss, ref_grads, leaves):
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(ref_leaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        assert g.shape == r.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-3, err_msg=f"leaf {i}")


@pytest.mark.parametrize("geometry", MODELS)
def test_odd_head_model_loss_and_every_gradient_match_jax(geometry):
    """The LM's loss and the gradient of every leaf against JAX's
    ``jax.value_and_grad(loss_fn)``, on JAX's weights carried over by
    ``trainable_params_from_jax``, at L = 32 with 16-row tiles on the JAX
    side."""
    kw, jcfg, cfg = _model_cfgs(geometry)
    jp = jtf.init_params(jcfg, seed=7)
    toks = np.random.default_rng(7).integers(
        0, kw["vocab_size"], (2, 33)).astype(np.int32)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    ref_loss, ref_grads = jax.value_and_grad(jtf.loss_fn)(
        jp, jnp.asarray(inputs), jnp.asarray(targets), jcfg)
    params = trainable_params_from_jax(jax.device_get(jp), device="cpu")
    loss = loss_fn(params, torch.from_numpy(inputs),
                   torch.from_numpy(targets), cfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=2e-5)
    _grads_match(loss, ref_grads, param_leaves(params))


def test_d72_encoder_mlm_loss_and_every_gradient_match_jax():
    """The encoder's MLM loss (bidirectional: H3 without a mask, as
    SigLIP-so400m's tower trains) and every gradient at d_head=72 against
    JAX's ``mlm_loss``, on the mask JAX draws from its key."""
    kw, jcfg, cfg = _model_cfgs("d72")
    mask_token = kw["vocab_size"] - 1
    jp = jtf.init_params(jcfg, seed=8)
    toks = np.random.default_rng(8).integers(
        0, mask_token, (4, 32)).astype(np.int32)
    key = jax.random.PRNGKey(8)
    ref_loss, ref_grads = jax.value_and_grad(jenc.mlm_loss)(
        jp, jnp.asarray(toks), key, jcfg, mask_token)
    _, mask = jenc.mask_tokens(jnp.asarray(toks), key, mask_token)
    mask = np.array(mask)
    assert 0 < mask.sum() < mask.size
    params = trainable_params_from_jax(jax.device_get(jp), device="cpu")
    loss = mlm_loss(params, torch.from_numpy(toks), None, cfg, mask_token,
                    mask=torch.from_numpy(mask))
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=5e-5)
    _grads_match(loss, ref_grads, param_leaves(params))


def _misread(x):
    """The known-wrong loads of rows that are no multiple of 16 bytes, as
    ``chip_smoke.py``'s ``misread_rows``: each element read one element
    late (the memory shifted by one), and each row's last column
    dropped."""
    late = x.flatten().roll(-1).view(x.shape)
    drop = x.clone()
    drop[..., -1] = 0
    return {"rows read one element late": late, "last column dropped": drop}


# the card's limits (chip_smoke.py's H3_REL_TOL and F32_H3_TOL), and the
# emulations' shapes: GQA 4/2, ragged Lq 136 over Lkv 150 (neither a
# multiple of 32 or 64), the window across the tiles
BF16_LIMIT, F32_LIMIT = 2e-2, 1e-4
EMU_DIMS = (33, 72, 250)
EMU_MASKS = {"none": (False, None), "causal": (True, None),
             "window": (True, 100)}
EMU_CASES = [(d, m) for d in EMU_DIMS for m in EMU_MASKS]


@pytest.mark.parametrize("d,mask", EMU_CASES,
                         ids=[f"d{d}-{m}" for d, m in EMU_CASES])
def test_card_limit_holds_bf16_roundings_and_not_a_misread_row(d, mask):
    """H3's bf16 arithmetic (P and dS rounded to bf16, bf16 gradients) on
    bf16 inputs within half the card's limit of the plain backward, per
    gradient; the same arithmetic on each misread of q, k, v and dO
    beyond it."""
    causal, window = EMU_MASKS[mask]
    gen = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(*s, generator=gen).bfloat16() for s in (
        (1, 4, 136, d), (1, 2, 150, d), (1, 2, 150, d), (1, 4, 136, d)))
    scale, diag_off = 1.0 / math.sqrt(d), 150 - 136
    out, lse = attention_plain(q, k, v, scale, causal, diag_off, window)
    out = out.bfloat16()
    ref = attention_bwd_plain(q, k, v, out, do, lse, scale, causal, diag_off,
                              window)
    emu = _kernel_emulation(q, k, v, out, do, lse, scale, causal, diag_off,
                            window)
    bad = [_misread(x) for x in (q, k, v, do)]
    for what in bad[0]:
        ctl = _kernel_emulation(*(b[what] for b in bad[:3]), out,
                                bad[3][what], lse, scale, causal, diag_off,
                                window)
        for name, c, r in zip(GRAD_NAMES, ctl, ref):
            peak = r.float().abs().max()
            assert (c.float() - r.float()).abs().max() / peak > BF16_LIMIT, (
                what, name)
    for name, e, r in zip(GRAD_NAMES, emu, ref):
        peak = r.float().abs().max()
        assert (e.float() - r.float()).abs().max() / peak < BF16_LIMIT / 2, (
            name)


@pytest.mark.parametrize("d,mask", EMU_CASES,
                         ids=[f"d{d}-{m}" for d, m in EMU_CASES])
def test_card_limit_holds_f32_arithmetic_and_not_a_misread_row(d, mask):
    """H3's f32 arithmetic (bf16x6 in the kernels' tile order; at d=250
    the D=256 cluster's S and dP as two column halves, [0, 128) and [128,
    250), added in f32) within half the card's limit of f64 autograd per
    gradient; the same arithmetic on each misread of q, k, v and dO
    beyond it."""
    causal, window = EMU_MASKS[mask]
    q, k, v, do = _inputs(d + 1, 1, 4, 2, 136, 150, d)
    diag_off = 150 - 136
    o64, lse64 = _f64_forward(q, k, v, causal, diag_off, window)
    out, lse = (torch.from_numpy(x.astype(np.float32)) for x in (o64, lse64))
    hidden = torch.from_numpy(_hidden(136, 150, causal, diag_off, window))
    scale = 1.0 / math.sqrt(d)
    ref = _f64_grads(q, k, v, do, causal, diag_off, window)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    emu = _emulate_h3_f32(*t[:3], out, t[3], lse, scale, hidden)
    for name, e, r in zip(GRAD_NAMES, emu, ref):
        assert _card_err(e, r) <= F32_LIMIT / 2, name
    bad = [_misread(x) for x in t]
    for what in bad[0]:
        ctl = _emulate_h3_f32(*(b[what] for b in bad[:3]), out, bad[3][what],
                              lse, scale, hidden)
        for name, c, r in zip(GRAD_NAMES, ctl, ref):
            assert _card_err(c, r) > F32_LIMIT, (what, name)
