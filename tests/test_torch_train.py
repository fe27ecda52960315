"""Port training path (``loss_fn``, ``make_train_step``) vs the JAX package.

Small f32 config (``tests/test_torch_model.py``'s: vocab 128, 2 layers,
GQA 4/2, d_model 128, d_head 64, d_ff 256), weights from the same seed.  At
L = 32 the JAX forward is B4 and its backward B11; at L = 20 they are B8
and B12/B13.  The port runs its CPU path (plain attention, forward and
backward).

Tolerances:
- Loss: atol 2e-5 on a mean cross-entropy of ~4.9 (a few f32 ulps; the
  logits agree to 1e-4, ``tests/test_torch_model.py``, and the mean over
  B·L tokens averages their differences).
- Gradients: atol 2e-5 plus rtol 1e-3 per element; the two sides differ
  in summation order through 2 layers and in their libm's RoPE cos/sin.
- SGD steps: the tier of the JAX package's sharded-vs-single-device step
  (``tests/test_model.py:85-92``): loss 1e-4, params atol 5e-4 rtol 1e-3.
- AdamW steps: loss 2e-4.  Adam's first steps move each weight by about
  lr·sign(g), so a gradient near zero can flip its step between the two
  sides; the loss moves by less than lr times what one weight adds.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    loss_fn,
    make_train_step,
    param_leaves,
    params_from_jax,
    trainable_params_from_jax,
)
from exploring_flash_attention_tpu_torch.utils.profile_train import split_step

KW = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=128,
          d_head=64, d_ff=256)
CFG = ModelConfig(**KW)
JCFG = jtf.ModelConfig(**KW, tile=JTileConfig(block_q=64, block_kv=64))


def _tokens(seed, b, n):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, n)).astype(np.int32)


@pytest.mark.parametrize("seq_len", [32, 20])
def test_loss_and_every_gradient_match_jax(seq_len):
    jp = jtf.init_params(JCFG, seed=4)
    toks = _tokens(seq_len, 2, seq_len + 1)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    ref_loss, ref_grads = jax.value_and_grad(jtf.loss_fn)(
        jp, jnp.asarray(inputs), jnp.asarray(targets), JCFG)
    params = trainable_params_from_jax(jax.device_get(jp), device="cpu")
    leaves = param_leaves(params)
    assert all(t.requires_grad and t.dtype == torch.float32 for t in leaves)
    loss = loss_fn(params, torch.from_numpy(inputs),
                   torch.from_numpy(targets), CFG)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=2e-5)
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(ref_leaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        assert g.shape == r.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-3, err_msg=f"leaf {i}")


def _run_jax(optimizer, toks, n_steps):
    step, opt = jtf.make_train_step(JCFG, optimizer=optimizer)
    params = jtf.init_params(JCFG, seed=0)
    state = opt.init(params)
    losses = []
    for _ in range(n_steps):
        params, state, loss = step(params, state, jnp.asarray(toks))
        losses.append(float(loss))
    return jax.tree.leaves(jax.device_get(params)), losses


def _run_port(optimizer, toks, n_steps):
    step, opt_init = make_train_step(CFG, optimizer=optimizer)
    params = params_from_jax(jax.device_get(jtf.init_params(JCFG, seed=0)),
                             device="cpu")
    opt = opt_init(params)
    losses = [step(params, opt, toks).item() for _ in range(n_steps)]
    return param_leaves(params), losses


def test_three_sgd_steps_match_jax():
    """SGD keeps the update linear in the gradient, as the JAX package's
    own step comparison does (``tests/test_model.py:70-72``)."""
    toks = _tokens(1, 4, 33)
    ref_params, ref_losses = _run_jax(optax.sgd(0.1), toks, 3)
    params, losses = _run_port(
        lambda leaves: torch.optim.SGD(leaves, lr=0.1), toks, 3)
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4)
    assert losses[2] < losses[0]
    for i, (p, r) in enumerate(zip(params, ref_params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   atol=5e-4, rtol=1e-3, err_msg=f"leaf {i}")


def test_three_adamw_steps_follow_jax_loss():
    toks = _tokens(2, 4, 21)                   # L = 20: B8 and B12/B13
    _, ref_losses = _run_jax(None, toks, 3)    # optax.adamw(1e-3)
    _, losses = _run_port(None, toks, 3)
    np.testing.assert_allclose(losses, ref_losses, atol=2e-4)
    assert losses[0] > losses[1] > losses[2]


def test_default_optimizer_is_adamw_with_optax_defaults():
    defaults = {k: p.default for k, p in
                inspect.signature(optax.adamw).parameters.items()}
    _, opt_init = make_train_step(CFG, learning_rate=3e-4)
    params = params_from_jax(jax.device_get(jtf.init_params(JCFG, seed=0)),
                             device="cpu")
    opt = opt_init(params)
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert group["lr"] == 3e-4
    assert group["betas"] == (defaults["b1"], defaults["b2"]) == (0.9, 0.999)
    assert group["eps"] == defaults["eps"] == 1e-8
    assert group["weight_decay"] == defaults["weight_decay"] == 1e-4
    assert group["params"] == param_leaves(params)
    assert all(t.requires_grad for t in param_leaves(params))


def test_profile_split_times_the_real_step():
    """``utils/profile_train.split_step`` times the step that
    ``make_train_step`` built: the same loss and the same updated params as
    an untimed step from the same start, and three parts."""
    toks = _tokens(3, 2, 21)
    runs = []
    for timed in (False, True):
        step, opt_init = make_train_step(CFG)
        params = params_from_jax(
            jax.device_get(jtf.init_params(JCFG, seed=0)), device="cpu")
        opt = opt_init(params)
        if timed:
            parts, loss = split_step(step, params, opt, toks)
            assert len(parts) == 3 and all(t >= 0 for t in parts)
        else:
            loss = step(params, opt, toks)
        runs.append((loss, param_leaves(params)))
    (loss, leaves), (loss_t, leaves_t) = runs
    assert torch.equal(loss, loss_t)
    for a, b in zip(leaves, leaves_t):
        assert torch.equal(a, b)


def test_profile_attention_reads_profile_call(monkeypatch, capsys):
    """``profile_train.profile_attention`` reads ``profile_call``'s result
    (the summed kernel time and the kernel rows) and prints H1 + H3's
    share of the kernel time."""
    from types import SimpleNamespace

    from exploring_flash_attention_tpu_torch.utils import profile_train

    rows = [SimpleNamespace(key="prefill_attention_kernel<128>",
                            self_device_time_total=300.0),
            SimpleNamespace(key="attention_bwd_dq_kernel<128>",
                            self_device_time_total=100.0),
            SimpleNamespace(key="gemm", self_device_time_total=600.0)]
    monkeypatch.setattr(profile_train, "profile_call", lambda *a: {
        "wall_ms": 2.0, "kernel_ms": 1.0, "launches": 3, "kernels": rows})
    profile_train.profile_attention("step", lambda: None, 4)
    assert "0.400 ms, 0.4000 of the kernel time" in capsys.readouterr().out


def test_make_train_step_refuses_a_mesh():
    """The sharded step takes a ``DeviceMesh`` with the axes (dp, tp, sp)
    (``parallel.make_mesh``; its cases: ``tests/test_torch_sharded.py``);
    anything else is refused."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(CFG, mesh=object())


WCFG = ModelConfig(**KW, window=48)
JWCFG = jtf.ModelConfig(**KW, tile=JTileConfig(block_q=64, block_kv=64),
                        window=48)


def test_windowed_loss_and_every_gradient_match_jax():
    """The windowed model (window 48 at L = 128; JAX's band forward takes
    lane-aligned lengths): the loss and every gradient against JAX's
    windowed ``loss_fn``, at the tolerances of the unwindowed test above.
    The band matters here: the unwindowed loss differs."""
    jp = jtf.init_params(JWCFG, seed=5)
    toks = _tokens(5, 2, 129)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    ref_loss, ref_grads = jax.value_and_grad(jtf.loss_fn)(
        jp, jnp.asarray(inputs), jnp.asarray(targets), JWCFG)
    params = trainable_params_from_jax(jax.device_get(jp), device="cpu")
    loss = loss_fn(params, torch.from_numpy(inputs),
                   torch.from_numpy(targets), WCFG)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=2e-5)
    full = loss_fn(params, torch.from_numpy(inputs),
                   torch.from_numpy(targets), CFG)
    assert abs(full.item() - loss.item()) > 1e-3
    grads = torch.autograd.grad(loss, param_leaves(params))
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(ref_leaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-3, err_msg=f"leaf {i}")


def test_windowed_model_trains():
    """tests/test_model.py:132 on the port: the windowed model's AdamW
    steps lower the loss (B=2, L=256, window 96)."""
    cfg = ModelConfig(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      d_model=256, d_head=64, d_ff=512, window=96)
    jcfg = jtf.ModelConfig(vocab_size=512, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_model=256, d_head=64, d_ff=512)
    step, opt_init = make_train_step(cfg)
    params = params_from_jax(jax.device_get(jtf.init_params(jcfg, seed=0)),
                             device="cpu", dtype=torch.float32)
    opt = opt_init(params)
    toks = np.random.default_rng(0).integers(0, 512, (2, 257)).astype(
        np.int32)
    l0 = step(params, opt, toks).item()
    for _ in range(3):
        loss = step(params, opt, toks).item()
    assert loss < l0
