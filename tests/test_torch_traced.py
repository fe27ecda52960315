"""Traced positions in the port's attention ops vs the JAX package's.

A traced position is a 0-d integer tensor in the port, a ``jax.Array`` in
JAX (B9's and B11-B15's offsets, a sequence-parallel shard's
``(q_pos0, kv_pos0)``).  The same NumPy inputs go through both packages'
partial forward, differentiable forward, backward and split-KV partials,
JAX with Pallas in interpret mode, at hops in the middle of the diagonal,
wholly in the future (no key: O = 0, LSE = -inf, zero gradients), wholly
in the past and across it.  Tolerance: atol 1e-5 in f32 (both sides sum
in f32 and differ in order only), 2e-5 / rtol 1e-4 for gradients (the
JAX tests' own).  Then the ring's hop functions, composed by hand in one
process as chip_smoke.py composes them on the card, against one-device
attention."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.ops import attention_bwd as jax_bwd_mod
from exploring_flash_attention_tpu.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial as jax_splitkv_partial,
)
from exploring_flash_attention_tpu.ops.attention_vjp import (
    flash_attention as jax_flash_attention,
)
from exploring_flash_attention_tpu.configs import SplitKVConfig as JSplitKV
from exploring_flash_attention_tpu.parallel.partials import (
    attention_partial_local as jax_partial,
)
from exploring_flash_attention_tpu_torch.configs import SplitKVConfig
from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    flash_attention,
    traced_pair,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    flash_attention_bwd,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial,
)
from exploring_flash_attention_tpu_torch.parallel.ring import (
    ring_hop_backward,
    ring_hop_forward,
    ring_offsets,
)

ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
LQ, LKV = 64, 128
# (q_pos0, kv_pos0): on the diagonal, a hop wholly in the future, one
# wholly in the past, and one across the diagonal where the first rows see
# no key
HOPS = {"diagonal": (64, 0), "future": (0, 128), "past": (256, 0),
        "across": (40, 100)}


def _qkv(seed, lq=LQ, lkv=LKV, hq=4, hkv=2, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, hq, lq, d)).astype(np.float32),
            rng.standard_normal((1, hkv, lkv, d)).astype(np.float32),
            rng.standard_normal((1, hkv, lkv, d)).astype(np.float32))


def _traced(pos):
    return (torch.tensor(pos[0]), torch.tensor(pos[1]))


def _jtraced(pos):
    return (jnp.int32(pos[0]), jnp.int32(pos[1]))


def _unseen(pos, lq=LQ):
    """The rows that see no key: row i sees key j iff kv_pos0 + j <=
    q_pos0 + i."""
    return np.arange(lq) + pos[0] < pos[1]


@pytest.mark.parametrize("hop", list(HOPS))
def test_partial_at_traced_positions_matches_jax(hop):
    pos = HOPS[hop]
    q, k, v = _qkv(0)
    o, lse = attention_partial_local(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        positions=_traced(pos))
    jo, jl = jax_partial(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                         positions=_jtraced(pos))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=ATOL)
    unseen = _unseen(pos)
    assert np.isneginf(lse.numpy()[..., unseen]).all()
    assert (o.numpy()[..., unseen, :] == 0).all()
    assert np.isfinite(lse.numpy()[..., ~unseen]).all()
    # the static route at the same positions gives the same numbers
    o_s, lse_s = attention_partial_local(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        static_positions=pos)
    assert torch.equal(o, o_s) and torch.equal(lse, lse_s)


@pytest.mark.parametrize("hop", list(HOPS))
def test_flash_attention_at_traced_positions_matches_jax_grads(hop):
    """Forward and gradients of sum(o**2) through the differentiable call
    (the forward saves the traced pair for H3's backward)."""
    pos = HOPS[hop]
    q, k, v = _qkv(1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=True, positions=_traced(pos))
    (out ** 2).sum().backward()

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(
            q, jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1),
            causal=True, positions=_jtraced(pos)) ** 2)

    j_out = jax_flash_attention(
        *(jnp.asarray(x) for x in (q, np.repeat(k, 2, 1), np.repeat(v, 2, 1))),
        causal=True, positions=_jtraced(pos))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=ATOL)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for g, r, name in zip(leaves, grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    if hop == "future":
        assert all((g.grad == 0).all() for g in leaves)


@pytest.mark.parametrize("hop", list(HOPS))
@pytest.mark.parametrize("lse_kind", ["global", "unseen_rows"])
def test_bwd_at_traced_positions_matches_jax(hop, lse_kind):
    """The backward of a ring hop: positions traced, ``out`` and ``lse``
    those of the whole row (finite even where this hop shows no key:
    P = 0 there, so a future hop's gradients are zero), or with some rows'
    LSE at -inf (rows that saw nothing anywhere: P = 0, not exp(+inf))."""
    pos = HOPS[hop]
    q, k, v = _qkv(2)
    rng = np.random.default_rng(3)
    out = rng.standard_normal(q.shape).astype(np.float32)
    do = rng.standard_normal(q.shape).astype(np.float32)
    lse = (rng.standard_normal(q.shape[:3]) + 6.0).astype(np.float32)
    if lse_kind == "unseen_rows":
        lse[..., ::3] = -np.inf
    got = flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, out, do, lse)),
        causal=True, positions=_traced(pos))
    ref = jax_bwd_mod.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, out, do, lse)), causal=True,
        positions=_jtraced(pos))
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    if hop == "future":
        assert all((g == 0).all() for g in got)


@pytest.mark.parametrize("pos", [(128, 0), (0, 256), (200, 64)])
def test_splitkv_partial_at_traced_positions_matches_jax(pos):
    """B9's route: span partials at traced offsets, spans of 128 keys."""
    q, k, v = _qkv(4, lq=128, lkv=256, hq=2, hkv=2)
    o, lse = flash_attention_splitkv_partial(
        *(torch.from_numpy(x) for x in (q, k, v)),
        config=SplitKVConfig(block_q=128, block_kv=128,
                             kv_tiles_per_block=1),
        causal=True, positions=_traced(pos))
    jo, jl = jax_splitkv_partial(
        *(jnp.asarray(x) for x in (q, k, v)),
        config=JSplitKV(block_q=128, block_kv=128, kv_tiles_per_block=1),
        causal=True, positions=_jtraced(pos))
    assert o.shape == jo.shape == (1, 2, 2, 128, 64)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=ATOL)


def test_traced_positions_take_integer_tensors_only():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5))
    want = flash_attention(q, k, v, causal=True, positions=(64, 0))
    for pos in [(torch.tensor(64), torch.tensor(0)),
                (torch.tensor(64, dtype=torch.int32), 0),
                (np.int64(64), torch.tensor(0, dtype=torch.int16))]:
        assert torch.equal(flash_attention(q, k, v, causal=True,
                                           positions=pos), want)
    for bad in [(torch.tensor(64.0), torch.tensor(0)),
                (torch.tensor([64]), torch.tensor(0)),
                (64.0, 0)]:
        with pytest.raises(TypeError):
            flash_attention(q, k, v, causal=True, positions=bad)
    pair = traced_pair((torch.tensor(3), 5), torch.device("cpu"))
    assert pair.dtype == torch.int32 and pair.tolist() == [3, 5]


@pytest.mark.parametrize("n,gqa", [(2, 1), (4, 2)])
def test_ring_hops_composed_by_hand_match_one_device(n, gqa):
    """Every rank's hops of an n-rank causal ring, run in one process
    through the hop functions with the shards passed by hand (the forward
    folds each rank's hops; the backward adds each hop's (dK, dV) to its
    source shard), against one-device causal attention and its gradients:
    what chip_smoke.py's parallel phase runs on the card."""
    l, d = 64 * n, 64
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, l, l, 4, 4 // gqa, d))
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        q.shape).astype(np.float32))
    scale = 1.0 / math.sqrt(d)
    qs, ks, vs, dos = (x.chunk(n, dim=2) for x in (q, k, v, do))
    outs, lses = [], []
    for my in range(n):
        offs = ring_offsets(my, n, l // n, l // n, q.device)
        o = lse = None
        for s in range(n):
            src = (my - s) % n
            o, lse = ring_hop_forward(qs[my], ks[src], vs[src], offs[s], o,
                                      lse, scale, True)
        outs.append(o)
        lses.append(lse)
    dq = [torch.zeros_like(x) for x in qs]
    dk = [torch.zeros_like(x) for x in ks]
    dv = [torch.zeros_like(x) for x in vs]
    for my in range(n):
        offs = ring_offsets(my, n, l // n, l // n, q.device)
        delta = (dos[my] * outs[my]).sum(-1)
        for s in range(n):
            src = (my - s) % n
            g = ring_hop_backward(qs[my], ks[src], vs[src], outs[my],
                                  dos[my], lses[my], delta, offs[s], scale,
                                  True)
            dq[my] += g[0]
            dk[src] += g[1]
            dv[src] += g[2]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = flash_attention(*leaves, causal=True)
    ref.backward(do)
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(),
                               ref.detach().numpy(), atol=ATOL)
    for got, leaf, name in zip((dq, dk, dv), leaves, ("dq", "dk", "dv")):
        np.testing.assert_allclose(torch.cat(got, 2).numpy(),
                                   leaf.grad.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
