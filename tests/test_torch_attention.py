"""Port attention (prefill, kernel H1's plain version) vs the JAX package.

The same NumPy inputs go through the JAX function (Pallas in interpret
mode on the CPU, as the JAX tests run it) and through the port's CPU path,
in f32.  Tolerance: atol 1e-5 on O and LSE — both sides compute in f32 and
differ only in summation order (O is a convex combination of O(1) values,
LSE is O(1))."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import cdiv as jax_cdiv
from exploring_flash_attention_tpu.ops import attention_bwd as jax_bwd_mod
from exploring_flash_attention_tpu.ops.attention_v1 import (
    causal_partial_onepass_eligible,
)
from exploring_flash_attention_tpu.ops.attention_vjp import (
    flash_attention as jax_flash_attention,
)
from exploring_flash_attention_tpu.parallel.partials import (
    attention_partial_local as jax_attention_partial_local,
)
from exploring_flash_attention_tpu_torch.configs import cdiv
from exploring_flash_attention_tpu_torch.oracle import (
    AccuracyError,
    check_accuracy,
    naive_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    flash_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    flash_attention_bwd,
)

ATOL = 1e-5


def _qkv(seed, b, hq, hkv, lq, lkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lkv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lkv, d)).astype(np.float32)
    return q, k, v


# (route, Lq, Lkv): B4 is the causal one-pass kernel (L % 8 == 0), B8 the
# split-KV partial kernel the ragged prompt falls to
ROUTES = [("b4", 64, 64), ("b8", 17, 17), ("b4_cross", 24, 40)]


@pytest.mark.parametrize("route,lq,lkv", ROUTES)
def test_attention_partial_local_matches_jax(route, lq, lkv):
    d = 64
    assert causal_partial_onepass_eligible(lq, lkv, d) == route.startswith(
        "b4")
    q, k, v = _qkv(0, 2, 4, 2, lq, lkv, d)                 # GQA 4/2
    o_ref, lse_ref = jax_attention_partial_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    o, lse = attention_partial_local(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    # each side against the f64 oracle first, so that a failure names the
    # side that drifted (this case once failed in a full parallel run with
    # a uniform 4.4e-5 relative error over ~10 rows, and never alone)
    rep = lambda x: np.repeat(x, 2, axis=1)                # noqa: E731
    o64, lse64 = naive_attention(q, rep(k), rep(v), causal=True,
                                 return_lse=True)
    for side, (o_x, lse_x) in {"jax": (o_ref, lse_ref),
                               "port": (o.numpy(), lse.numpy())}.items():
        np.testing.assert_allclose(np.asarray(o_x), o64, atol=ATOL,
                                   err_msg=f"{side} O vs f64 oracle")
        np.testing.assert_allclose(np.asarray(lse_x), lse64, atol=ATOL,
                                   err_msg=f"{side} LSE vs f64 oracle")
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)


@pytest.mark.parametrize("port,jax_fn", [
    (attention_partial_local, jax_attention_partial_local),
    (flash_attention_bwd, jax_bwd_mod.flash_attention_bwd),
])
def test_port_defaults_match_jax(port, jax_fn):
    """Every parameter the port shares with the JAX function has its name
    and its default: a caller who leaves one out gets the same function on
    both sides.  Then ``attention_partial_local`` without ``causal`` is
    held against JAX's non-causal result on a case where causal differs."""
    ours = inspect.signature(port).parameters
    theirs = inspect.signature(jax_fn).parameters
    shared = [name for name in ours if name in theirs]
    assert "causal" in shared and len(shared) >= 6
    for name in shared:
        assert ours[name].default == theirs[name].default, name
    if port is attention_partial_local:
        q, k, v = _qkv(11, 1, 4, 2, 32, 48, 64)
        o_ref, lse_ref = jax_attention_partial_local(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        o, lse = port(*(torch.from_numpy(x) for x in (q, k, v)))
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                                   atol=ATOL)
        causal_o, _ = port(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=True)
        assert (causal_o - o).abs().max() > 100 * ATOL


@pytest.mark.parametrize("lq,lkv", [(64, 64), (17, 17), (24, 16)])
def test_attention_partial_local_matches_f64_oracle(lq, lkv):
    """(24, 16): the first 8 q rows see no key and must give (0, -inf)."""
    q, k, v = _qkv(1, 1, 4, 2, lq, lkv, 64)
    rep = lambda x: np.repeat(x, 2, axis=1)                # noqa: E731
    o_ref, lse_ref = naive_attention(q, rep(k), rep(v), causal=True,
                                     return_lse=True)
    o, lse = attention_partial_local(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)
    if lq > lkv:
        assert np.isneginf(lse.numpy()[..., :lq - lkv]).all()
        assert (o.numpy()[..., :lq - lkv, :] == 0).all()


def test_flash_attention_forward_matches_jax():
    q, k, v = _qkv(2, 2, 4, 2, 32, 32, 64)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_flash_attention_refuses_what_is_not_ported():
    """Traced positions still raise, and so does a window at positions
    other than the decode convention, on both sides; the non-causal and
    windowed calls, once refused, now match JAX's (their gradients:
    ``tests/test_torch_bwd.py``)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 2, 8, 8, 64))
    # gradients flow: the backward is ported (tests/test_torch_bwd.py
    # checks their values)
    qg = q.clone().requires_grad_()
    flash_attention(qg, k, v, causal=True).sum().backward()
    assert qg.grad.shape == q.shape and torch.isfinite(qg.grad).all()
    assert qg.grad.abs().max() > 0
    with pytest.raises(NotImplementedError, match="static"):
        flash_attention(q, k, v, causal=True,
                        positions=(torch.tensor(0), torch.tensor(0)))
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    np.testing.assert_allclose(
        flash_attention(q, k, v, causal=False).numpy(),
        np.asarray(jax_flash_attention(jq, jk, jv, causal=False)), atol=ATOL)
    # JAX's band forward takes Lkv in multiples of 128
    qw, kw, vw = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 2, 128, 128, 64))
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (qw, kw, vw))
    np.testing.assert_allclose(
        flash_attention(qw, kw, vw, causal=True, window=48).numpy(),
        np.asarray(jax_flash_attention(jq, jk, jv, causal=True, window=48)),
        atol=ATOL)
    with pytest.raises(NotImplementedError, match="positions"):
        flash_attention(qw, kw, vw, causal=True, positions=(8, 8), window=48)
    with pytest.raises(NotImplementedError, match="positions"):
        jax_flash_attention(jq, jk, jv, causal=True, positions=(8, 8),
                            window=48)


def test_flash_attention_records_no_graph_without_grad():
    """Under ``no_grad``, or with no input that requires grad, the call is
    the forward alone: the same output, no graph kept."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 1, 2, 2, 8, 8, 64))
    qg = q.clone().requires_grad_()
    with_graph = flash_attention(qg, k, v, causal=True)
    assert with_graph.grad_fn is not None
    with torch.no_grad():
        under_no_grad = flash_attention(qg, k, v, causal=True)
    no_leaf = flash_attention(q, k, v, causal=True)
    for got in (under_no_grad, no_leaf):
        assert got.grad_fn is None and not got.requires_grad
        assert torch.equal(got, with_graph.detach())


def test_flash_attention_takes_numpy_int_positions_as_static():
    """JAX counts ``np.integer`` positions as static
    (``ops/attention_vjp.py:65``)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 2, 2, 8, 12, 64))
    want = flash_attention(q, k, v, causal=True, positions=(6, 1))
    for pos in [(np.int32(6), np.int64(1)), (np.int64(6), 1)]:
        got = flash_attention(q, k, v, causal=True, positions=pos)
        assert torch.equal(got, want)
    ref = jax_flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), causal=True,
                              positions=(np.int32(6), np.int32(1)))
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("window", [12, 13, 100])
def test_flash_attention_window_covering_every_key_is_causal(window):
    """A window of Lkv or more is plain causal (``ops/attention_vjp.py:61``);
    Lkv = 12 here."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 2, 2, 8, 12, 64))
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       flash_attention(q, k, v, causal=True))


def test_flash_attention_window_without_causal_raises_value_error():
    """As the JAX package does (``ops/attention_vjp.py:59-60``)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 1, 2, 2, 8, 8, 64))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="causal"):
        jax_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                            causal=False, window=8)


@pytest.mark.parametrize("a,b", [(0, 128), (1, 128), (128, 128),
                                 (129, 128), (280, 128), (1024, 128)])
def test_cdiv_matches_jax(a, b):
    assert cdiv(a, b) == jax_cdiv(a, b) == -(-a // b)


def test_check_accuracy_passes_and_fails():
    rng = np.random.default_rng(4)
    ref = rng.standard_normal((2, 8, 16))
    stats = check_accuracy(ref + 1e-4, ref)
    assert stats["max_abs"] < 2e-4
    with pytest.raises(AccuracyError, match="max_abs"):
        check_accuracy(ref + 0.1, ref)
