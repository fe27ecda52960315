"""Port encoder (``models/encoder.py``: the bidirectional forward, the
masked-LM loss and train step) vs the JAX package's ``models/encoder.py``.

Small f32 config (``tests/test_torch_train.py``'s: vocab 128, 2 layers,
GQA 4/2, d_model 128, d_head 64, d_ff 256), weights from the same seed.
At L = 32 the JAX non-causal forward is B8 and its backward B11; at
L = 20, B8 and B12/B13.  The port runs its CPU path (the plain attention
without a mask, forward and backward).

The port draws its MLM mask from a ``torch.Generator`` and JAX from
``jax.random``: the two give different bits for one seed, so the
comparisons hand JAX's mask (``jax.random.bernoulli`` of the step's key,
as JAX's ``mask_tokens`` draws it) to the port's ``mask=``.

Tolerances, the tiers of ``tests/test_torch_train.py``:
- logits atol 1e-4 (``tests/test_torch_model.py``: O(1) sums after two
  layers, differing in summation order and in libm's RoPE cos/sin);
- loss atol 5e-5: a mean over the ~20 masked tokens only, where the
  causal LM's 2e-5 averages over all B·L tokens;
- gradients atol 2e-5 plus rtol 1e-3 per element;
- SGD steps: loss 1e-4, params atol 5e-4 rtol 1e-3 (the JAX package's
  sharded-vs-single-device tier, ``tests/test_model.py:85-92``).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import encoder as jenc
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    forward,
    init_params,
    make_mlm_train_step,
    mask_tokens,
    mlm_loss,
    param_leaves,
    params_from_jax,
    trainable_params_from_jax,
)

KW = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=128,
          d_head=64, d_ff=256)
CFG = ModelConfig(**KW)
JCFG = jtf.ModelConfig(**KW, tile=JTileConfig(block_q=64, block_kv=64))
MASK_TOKEN = KW["vocab_size"] - 1


def _tokens(seed, b, n):
    """Clean tokens below the mask token, as the JAX suite draws them."""
    return np.random.default_rng(seed).integers(
        0, MASK_TOKEN, (b, n)).astype(np.int32)


def _jax_mask(key, shape, rate=0.15):
    """The mask JAX's ``mask_tokens`` draws from ``key``."""
    return np.array(jax.random.bernoulli(key, rate, shape))


@pytest.mark.parametrize("seq_len", [32, 20])
def test_noncausal_forward_logits_match_jax(seq_len):
    jp = jtf.init_params(JCFG, seed=1)
    toks = _tokens(seq_len, 2, seq_len)
    ref = np.asarray(jtf.forward(jp, jnp.asarray(toks), JCFG, causal=False))
    got = forward(init_params(CFG, seed=1, device="cpu"),
                  torch.from_numpy(toks), CFG, causal=False)
    assert got.shape == (2, seq_len, KW["vocab_size"])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    causal = forward(init_params(CFG, seed=1, device="cpu"),
                     torch.from_numpy(toks), CFG)
    assert (causal - got).abs().max() > 100 * 1e-4


def test_encoder_is_bidirectional():
    """``tests/test_model.py:174-184``: a change at position 50 moves the
    bidirectional logits at position 10, and leaves the causal ones equal
    to the bit."""
    params = init_params(CFG, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(1, 1, 64))
    toks2 = toks.clone()
    toks2[0, 50] = (toks2[0, 50] + 1) % KW["vocab_size"]
    la = forward(params, toks, CFG, causal=False)
    lb = forward(params, toks2, CFG, causal=False)
    assert (la[0, 10] - lb[0, 10]).abs().max() > 1e-6
    ca = forward(params, toks, CFG, causal=True)
    cb = forward(params, toks2, CFG, causal=True)
    assert (ca[0, 10] - cb[0, 10]).abs().max() == 0.0


@pytest.mark.parametrize("seq_len", [32, 20])
def test_mlm_loss_and_every_gradient_match_jax(seq_len):
    jp = jtf.init_params(JCFG, seed=4)
    toks = _tokens(seq_len, 4, seq_len)
    key = jax.random.PRNGKey(seq_len)
    ref_loss, ref_grads = jax.value_and_grad(jenc.mlm_loss)(
        jp, jnp.asarray(toks), key, JCFG, MASK_TOKEN)
    mask = _jax_mask(key, toks.shape)
    _, jax_mask = jenc.mask_tokens(jnp.asarray(toks), key, MASK_TOKEN)
    np.testing.assert_array_equal(mask, np.asarray(jax_mask))
    assert 0 < mask.sum() < mask.size
    params = trainable_params_from_jax(jax.device_get(jp), device="cpu")
    leaves = param_leaves(params)
    loss = mlm_loss(params, torch.from_numpy(toks), None, CFG, MASK_TOKEN,
                    mask=torch.from_numpy(mask))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=5e-5)
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(ref_leaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        assert g.shape == r.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-3, err_msg=f"leaf {i}")


def test_three_sgd_steps_match_jax():
    """SGD keeps the update linear in the gradient, as the JAX package's
    own step comparison does (``tests/test_model.py:70-72``); each step
    draws a new mask from its own key, on both sides the same."""
    toks = _tokens(1, 4, 32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    step, opt = jenc.make_mlm_train_step(JCFG, optimizer=optax.sgd(0.1))
    jp = jtf.init_params(JCFG, seed=0)
    state = opt.init(jp)
    ref_losses = []
    for key in keys:
        jp, state, loss = step(jp, state, jnp.asarray(toks), key)
        ref_losses.append(float(loss))

    pstep, opt_init = make_mlm_train_step(
        CFG, optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.1))
    params = params_from_jax(jax.device_get(jtf.init_params(JCFG, seed=0)),
                             device="cpu")
    popt = opt_init(params)
    losses = [pstep(params, popt, toks, None,
                    torch.from_numpy(_jax_mask(key, toks.shape))).item()
              for key in keys]
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4)
    for i, (p, r) in enumerate(zip(param_leaves(params),
                                   jax.tree.leaves(jax.device_get(jp)))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   atol=5e-4, rtol=1e-3, err_msg=f"leaf {i}")


def test_adamw_mlm_loss_falls():
    """``tests/test_model.py:186-196`` on the port: AdamW at its defaults,
    mask rate 0.2, a fresh mask each step from one generator; the loss
    after four more steps is under the first."""
    step, opt_init = make_mlm_train_step(CFG, mask_rate=0.2)
    params = init_params(CFG, seed=0, device="cpu")
    opt = opt_init(params)
    data = torch.from_numpy(_tokens(2, 4, 128))
    gen = torch.Generator().manual_seed(0)
    losses = [step(params, opt, data, gen).item() for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_mask_tokens_rate_and_untouched_positions():
    toks = torch.from_numpy(_tokens(3, 64, 512)).long()
    inputs, mask = mask_tokens(toks, torch.Generator().manual_seed(5),
                               MASK_TOKEN)
    assert mask.dtype == torch.bool and mask.shape == toks.shape
    assert abs(mask.float().mean().item() - 0.15) < 0.01
    assert torch.equal(inputs[~mask], toks[~mask])
    assert (inputs[mask] == MASK_TOKEN).all()
    again, mask2 = mask_tokens(toks, torch.Generator().manual_seed(5),
                               MASK_TOKEN)
    assert torch.equal(mask, mask2) and torch.equal(inputs, again)
    _, mask3 = mask_tokens(toks, torch.Generator().manual_seed(5),
                           MASK_TOKEN, mask_rate=0.5)
    assert abs(mask3.float().mean().item() - 0.5) < 0.01


def test_make_mlm_train_step_refuses_a_mesh():
    """The sharded step takes a ``DeviceMesh`` with the axes (dp, tp, sp)
    (``parallel.make_mesh``; its cases: ``tests/test_torch_sharded.py``);
    anything else is refused."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_mlm_train_step(CFG, mesh=object())


def test_make_mlm_train_step_defaults_match_jax():
    """Every parameter the port shares with the JAX function has its name
    and default (JAX's ``interpret`` has no counterpart on the card); the
    default mask token is the last id and the default optimizer AdamW at
    1e-3, as ``optax.adamw(learning_rate)``."""
    ours = inspect.signature(make_mlm_train_step).parameters
    theirs = inspect.signature(jenc.make_mlm_train_step).parameters
    shared = [name for name in ours if name in theirs]
    assert shared == ["config", "mask_token", "mask_rate", "learning_rate",
                      "optimizer", "mesh"]
    for name in shared:
        assert ours[name].default == theirs[name].default, name
    step, opt_init = make_mlm_train_step(CFG)
    params = init_params(CFG, seed=0, device="cpu")
    opt = opt_init(params)
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.param_groups[0]["lr"] == 1e-3
    toks = torch.from_numpy(_tokens(6, 2, 16))
    mask = torch.zeros(toks.shape, dtype=torch.bool)
    mask[:, ::3] = True
    want = mlm_loss(params, toks, None, CFG, MASK_TOKEN, mask=mask)
    assert torch.equal(step(params, opt, toks, None, mask), want.detach())
