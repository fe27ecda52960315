"""The training path at the head geometries the port serves, vs the JAX
package: head dims 16, 80 and 256 in a GQA group of 16 over one KV head.

The same NumPy f32 inputs go through the JAX function (Pallas in interpret
mode with small tiles, as ``tests/test_torch_bwd.py`` runs it) and through
the port's CPU path (``attention_bwd_plain``, autograd through the plain
forward), which H3-dkv and H3-dq stand for on the card at every d of
``ops.attention.NARROW_HEAD_DIM_RULE`` (d off the multiples of 16:
``tests/test_torch_bwd_heads_odd.py``).  The inputs and the f64 references are
``tests/test_torch_bwd.py``'s.

Tolerances are those of ``tests/test_torch_bwd.py`` and
``tests/test_torch_train.py``:
- each backward against f64 autograd first, atol 2e-4 rtol 2e-2
  (``ORACLE``, the JAX package's backward-vs-autodiff tier), then the port
  against JAX, atol 1e-5 rtol 1e-4 (``ROUTES``, its tier between two
  kernel routes of one gradient);
- a 2-layer model's loss atol 2e-5 and every gradient atol 2e-5 plus rtol
  1e-3 (both sides in f32, summation order and libm's RoPE apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bwd import (
    ORACLE,
    ROUTES,
    _f64_forward,
    _f64_grads,
    _inputs,
)

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.ops import attention_bwd as jax_bwd_mod
from exploring_flash_attention_tpu.ops.attention_vjp import (
    flash_attention as jax_flash_attention,
)
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    loss_fn,
    param_leaves,
    trainable_params_from_jax,
)
from exploring_flash_attention_tpu_torch.ops.attention import flash_attention
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    flash_attention_bwd,
)

HEAD_DIMS = (16, 80, 256)
GROUP = 16                      # q heads over one KV head
MASKS = {"none": (False, None), "causal": (True, None), "window": (True, 12)}


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_bwd_head_dims_match_jax(d, mask):
    """``flash_attention_bwd`` at d 16, 80 and 256 over a group of 16 on
    one KV head, ragged and cross (Lq 24, Lkv 40), against JAX's
    ``flash_attention_bwd`` (16-row tiles), each side first against f64
    autograd; the GQA dK and dV come back summed over the group."""
    causal, window = MASKS[mask]
    q, k, v, do = _inputs(d, 1, GROUP, 1, 24, 40, d)
    o64, lse64 = _f64_forward(q, k, v, causal, 16, window)
    out, lse = o64.astype(np.float32), lse64.astype(np.float32)
    ref = _f64_grads(q, k, v, do, causal, 16, window)
    args = (q, k, v, out, do, lse)
    jax_bwd_mod.flash_attention_bwd.clear_cache()
    jax_grads = jax_bwd_mod.flash_attention_bwd(
        *(jnp.asarray(x) for x in args),
        config=JTileConfig(block_q=16, block_kv=16, q_chunk=16),
        causal=causal, window=window)
    port_grads = flash_attention_bwd(*(torch.from_numpy(x) for x in args),
                                     causal=causal, window=window)
    for name, j, t, r in zip(("dq", "dk", "dv"), jax_grads, port_grads, ref):
        assert t.dtype == torch.float32 and t.shape == r.shape
        np.testing.assert_allclose(np.asarray(j), r, **ORACLE,
                                   err_msg=f"jax {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), r, **ORACLE,
                                   err_msg=f"port {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **ROUTES,
                                   err_msg=f"port {name} vs jax")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [80, 256])
def test_autograd_through_flash_attention_head_dims_matches_jax_grad(
        d, causal):
    """``torch.autograd`` through the port's ``flash_attention`` (forward
    and backward) against ``jax.grad`` of JAX's, at d 80 and 256 in a group
    of 16, cross (Lq 24, Lkv 40)."""
    q, k, v, g = _inputs(d + causal, 1, GROUP, 1, 24, 40, d)

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash_attention(
            q, k, v, JTileConfig(block_q=16, block_kv=16, q_chunk=16),
            causal=causal) * g)

    jax_bwd_mod.flash_attention_bwd.clear_cache()
    jax_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal)
    port_grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                     (qt, kt, vt))
    ref = _f64_grads(q, k, v, g, causal, 16)
    for name, j, t, r in zip(("dq", "dk", "dv"), jax_grads, port_grads, ref):
        np.testing.assert_allclose(np.asarray(j), r, **ORACLE,
                                   err_msg=f"jax {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), r, **ORACLE,
                                   err_msg=f"port {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **ROUTES,
                                   err_msg=f"port {name} vs jax")


# 2-layer LMs at the two geometries the card trains (chip_smoke.py's
# heads256 and heads80g16, at test_torch_train.py's widths): heads wider
# than the model (16 * 80 and 4 * 256 against d_model 128)
MODELS = {
    "d80_group16": dict(n_heads=16, n_kv_heads=1, d_head=80),
    "d256_group4": dict(n_heads=4, n_kv_heads=1, d_head=256),
}


@pytest.mark.parametrize("geometry", MODELS)
def test_model_loss_and_every_gradient_match_jax(geometry):
    """The model's loss and the gradient of every leaf against JAX's
    ``jax.value_and_grad(loss_fn)``, on JAX's weights carried over by
    ``trainable_params_from_jax``, at L = 32 with 16-row tiles on the JAX
    side."""
    kw = dict(vocab_size=128, n_layers=2, d_model=128, d_ff=256,
              **MODELS[geometry])
    jcfg = jtf.ModelConfig(**kw, tile=JTileConfig(block_q=16, block_kv=16,
                                                  q_chunk=16))
    cfg = ModelConfig(**kw)
    jp = jtf.init_params(jcfg, seed=5)
    toks = np.random.default_rng(5).integers(
        0, kw["vocab_size"], (2, 33)).astype(np.int32)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    ref_loss, ref_grads = jax.value_and_grad(jtf.loss_fn)(
        jp, jnp.asarray(inputs), jnp.asarray(targets), jcfg)
    params = trainable_params_from_jax(jax.device_get(jp), device="cpu")
    leaves = param_leaves(params)
    loss = loss_fn(params, torch.from_numpy(inputs),
                   torch.from_numpy(targets), cfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=2e-5)
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = jax.tree.leaves(ref_grads)
    assert len(ref_leaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        assert g.shape == r.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-3, err_msg=f"leaf {i}")
