"""The port's split-KV V2 API (``flash_attention_splitkv_partial``,
``flash_attention_v2``, ``splitkv_combine``, ``merge_partials``,
``SplitKVConfig``) vs the JAX package.

Every case of ``tests/test_attention_v2.py`` runs here on the same NumPy
inputs through the JAX function (Pallas in interpret mode on the CPU, as
its own tests run it) and through the port's plain path, and keeps that
test's check against the f64 oracle with its tolerance (2e-5 on f32 O,
1.5e-2 on bf16 inputs).  Port vs JAX: 2e-5 abs in f32 (both compute in
f32 and differ in summation order only).  With bf16 inputs JAX keeps the
workspace in bf16 and the port in f32 (H2 takes f32 partials only): the
two differ by JAX's partial rounding, within 1e-2 (one bf16 rounding of an
O(1) value is 3.9e-3; at most two roundings apart)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu import configs as jconfigs
from exploring_flash_attention_tpu.ops import (
    flash_attention_splitkv_partial as jax_partial,
    flash_attention_v1 as jax_v1,
    flash_attention_v2 as jax_v2,
    splitkv_combine as jax_combine,
)
from exploring_flash_attention_tpu.oracle.reference import (
    error_stats,
    make_qkv,
    naive_attention,
)
from exploring_flash_attention_tpu.parallel.partials import (
    merge_partials as jax_merge_partials,
)
from exploring_flash_attention_tpu.sim import combine_partials
from exploring_flash_attention_tpu_torch import SplitKVConfig
from exploring_flash_attention_tpu_torch.ops import (
    flash_attention_splitkv_partial,
    flash_attention_v1,
    flash_attention_v2,
    merge_partials,
    splitkv_combine,
)

ATOL = 2e-5           # port vs JAX, f32
ORACLE_TOL = 2e-5     # tests/test_attention_v2.py's f32 tier
BF16_ORACLE_TOL = 1.5e-2   # its bf16 tier (test_v2_bf16)
BF16_JAX_TOL = 1e-2


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x, np.float32)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _cfgs(**kw):
    return jconfigs.SplitKVConfig(**kw), SplitKVConfig(**kw)


def _v2_both(q, k, v, jcfg, cfg, **kw):
    """flash_attention_v2 on both sides: (port, jax) as f32 NumPy, after
    checking that they agree within ATOL."""
    ours = flash_attention_v2(*_t(q, k, v), config=cfg, **kw).numpy()
    theirs = np.asarray(jax_v2(*_j(q, k, v), config=jcfg, **kw))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=ATOL)
    return ours, theirs


@pytest.mark.parametrize("kv_tiles_per_block", [1, 2, 4])
def test_v2_matches_oracle(kv_tiles_per_block):
    q, k, v = make_qkv(1, 2, 512, 128, dtype=np.float32, seed=0)
    jcfg, cfg = _cfgs(block_q=128, block_kv=128,
                      kv_tiles_per_block=kv_tiles_per_block)
    ours, _ = _v2_both(q, k, v, jcfg, cfg)
    assert error_stats(ours, naive_attention(q, k, v))["max_abs"] < ORACLE_TOL


def test_v2_single_block_equals_v1():
    q, k, v = make_qkv(1, 1, 256, 64, dtype=np.float32, seed=1)
    jcfg, cfg = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=2)
    ours, _ = _v2_both(q, k, v, jcfg, cfg)
    b_jax = np.asarray(jax_v1(*_j(q, k, v)))
    b_port = flash_attention_v1(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(ours, b_jax, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, b_port, atol=1e-5, rtol=1e-5)


def test_v2_partial_lse_is_logsumexp():
    q, k, v = make_qkv(1, 1, 128, 64, dtype=np.float32, seed=2)
    jcfg, cfg = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=1)
    o_p, lse = flash_attention_splitkv_partial(*_t(q, k, v), config=cfg)
    o_j, lse_j = jax_partial(*_j(q, k, v), config=jcfg)
    assert o_p.shape == (1, 1, 1, 128, 64) == o_j.shape
    assert lse.shape == (1, 1, 1, 128) == lse_j.shape
    assert o_p.dtype == torch.float32 and lse.dtype == torch.float32
    scale = 1.0 / np.sqrt(64)
    scores = q[0, 0] @ k[0, 0].T * scale
    expected_lse = np.log(np.exp(scores).sum(axis=-1))
    np.testing.assert_allclose(lse.numpy()[0, 0, 0], expected_lse, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL)
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), atol=ATOL)


def test_v2_combine_matches_sim_combine():
    rng = np.random.default_rng(3)
    b, h, nkb, lq, d = 1, 2, 3, 128, 64
    o_p = rng.standard_normal((b, h, nkb, lq, d)).astype(np.float32)
    lse = rng.standard_normal((b, h, nkb, lq)).astype(np.float32)
    out = splitkv_combine(*_t(o_p, lse)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jax_combine(*_j(o_p, lse))), atol=1e-5)
    for bi in range(b):
        for hi in range(h):
            ref = combine_partials(o_p[bi, hi], lse[bi, hi])
            np.testing.assert_allclose(out[bi, hi], ref, atol=1e-5)


def test_v2_causal():
    q, k, v = make_qkv(1, 2, 256, 64, dtype=np.float32, seed=4)
    jcfg, cfg = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=1)
    ours, _ = _v2_both(q, k, v, jcfg, cfg, causal=True)
    ref = naive_attention(q, k, v, causal=True)
    assert error_stats(ours, ref)["max_abs"] < ORACLE_TOL


def test_v2_multi_span_streaming_fallback():
    # one_pass=False forces JAX's streaming span kernel; the port takes the
    # knob and runs the same spans
    q, k, v = make_qkv(1, 2, 512, 128, dtype=np.float32, seed=0)
    jcfg, cfg = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=2,
                      one_pass=False)
    ours, _ = _v2_both(q, k, v, jcfg, cfg)
    assert error_stats(ours, naive_attention(q, k, v))["max_abs"] < ORACLE_TOL


def test_v2_multi_span_causal_matches_streaming():
    # causal spans wholly past a row's diagonal: (0, -inf), merged away
    q, k, v = make_qkv(1, 2, 512, 64, dtype=np.float32, seed=8)
    jfast, fast = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=1)
    jslow, slow = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=1,
                        one_pass=False)
    a, _ = _v2_both(q, k, v, jfast, fast, causal=True)
    b, _ = _v2_both(q, k, v, jslow, slow, causal=True)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert error_stats(a, naive_attention(q, k, v,
                                          causal=True))["max_abs"] < ORACLE_TOL
    o_p, lse = flash_attention_splitkv_partial(*_t(q, k, v), config=fast,
                                               causal=True)
    above = torch.isneginf(lse)                  # q tile i, spans past i
    assert above.sum() == 2 * 128 * (3 + 2 + 1)
    assert (o_p[above] == 0).all()


def test_v2_multi_span_positions():
    # JAX's traced shard offsets (q rows at 128..255 over kv rows 0..255)
    # are static positions in the port
    q, k, v = make_qkv(1, 1, 128, 64, dtype=np.float32, seq_len_kv=256,
                       seed=9)
    jcfg, cfg = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=1)
    o_j, lse_j = jax_partial(*_j(q, k, v), config=jcfg, causal=True,
                             positions=(jnp.int32(128), jnp.int32(0)))
    o_p, lse = flash_attention_splitkv_partial(
        *_t(q, k, v), config=cfg, causal=True, static_positions=(128, 0))
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL)
    out = splitkv_combine(o_p, lse).numpy()
    scale = 1.0 / np.sqrt(64)
    s = q[0, 0] @ k[0, 0].T * scale
    mask = np.arange(256)[None, :] <= (np.arange(128) + 128)[:, None]
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    ref = (p / p.sum(axis=-1, keepdims=True)) @ v[0, 0]
    np.testing.assert_allclose(out[0, 0], ref, atol=1e-5)
    np.testing.assert_allclose(
        out, np.asarray(jax_combine(o_j, lse_j)), atol=ATOL)


def test_v2_ragged_kv():
    q, k, v = make_qkv(1, 1, 128, 64, dtype=np.float32, seq_len_kv=300,
                       seed=5)
    jcfg, cfg = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=1)
    ours, _ = _v2_both(q, k, v, jcfg, cfg)
    assert error_stats(ours, naive_attention(q, k, v))["max_abs"] < ORACLE_TOL


def test_v2_decode_shape():
    q, k, v = make_qkv(2, 4, 8, 128, dtype=np.float32, seq_len_kv=2048,
                       seed=6)
    jcfg, cfg = _cfgs(block_q=8, block_kv=512, kv_tiles_per_block=1)
    ours, _ = _v2_both(q, k, v, jcfg, cfg)
    assert error_stats(ours, naive_attention(q, k, v))["max_abs"] < ORACLE_TOL


def test_v2_bf16():
    q, k, v = make_qkv(1, 4, 512, 128, dtype=np.float32, seed=7)
    qb, kb, vb = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                  for x in (q, k, v))
    jcfg, cfg = _cfgs(block_q=128, block_kv=128, kv_tiles_per_block=2)
    theirs = np.asarray(jax_v2(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), config=jcfg,
        out_dtype=jnp.float32))
    ours = flash_attention_v2(
        *(x.to(torch.bfloat16) for x in _t(q, k, v)), config=cfg,
        out_dtype=torch.float32)
    assert ours.dtype == torch.float32
    ref = naive_attention(qb, kb, vb)
    assert error_stats(ours.numpy(), ref)["max_abs"] < BF16_ORACLE_TOL
    assert error_stats(theirs, ref)["max_abs"] < BF16_ORACLE_TOL
    np.testing.assert_allclose(ours.numpy(), theirs, atol=BF16_JAX_TOL)


def test_partial_refuses_traced_positions_and_both_kinds():
    """Tensors as ``static_positions`` raise ``TypeError`` (they are
    the traced ``positions``, held against JAX's in
    ``tests/test_torch_traced.py``), and so do both kinds at once."""
    q, k, v = _t(*make_qkv(1, 1, 128, 64, dtype=np.float32, seed=9))
    with pytest.raises(TypeError, match="traced"):
        flash_attention_splitkv_partial(
            q, k, v, causal=True, static_positions=(torch.tensor(128), 0))
    with pytest.raises(ValueError, match="OR"):
        flash_attention_splitkv_partial(q, k, v, positions=(1, 0),
                                        static_positions=(1, 0))
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_splitkv_partial(q, k[:, :, :64], v)


@pytest.mark.parametrize("lkv,block_kv,tiles,nkb", [
    (300, 64, 1, 5),       # spans of 64 keys: half an H1 tile
    (100, 512, 4, 1),      # block_kv' = 100: one span, 100 keys
])
def test_partial_spans_that_are_not_whole_h1_tiles(lkv, block_kv, tiles,
                                                   nkb):
    """The plain path takes spans off H1's 128-key tiles, as the JAX
    function does; the card refuses a multi-span one
    (``tests/test_torch_kernels.py``)."""
    q, k, v = make_qkv(1, 2, 64, 64, dtype=np.float32, seq_len_kv=lkv,
                       seed=13)
    jcfg, cfg = _cfgs(block_q=64, block_kv=block_kv,
                      kv_tiles_per_block=tiles)
    assert cfg.kv_span(lkv) == (64 if block_kv == 64 else lkv)
    o_p, lse = flash_attention_splitkv_partial(*_t(q, k, v), config=cfg)
    o_j, lse_j = jax_partial(*_j(q, k, v), config=jcfg)
    assert o_p.shape == o_j.shape == (1, 2, nkb, 64, 64)
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL)
    out = splitkv_combine(o_p, lse).numpy()
    assert error_stats(out, naive_attention(q, k, v))["max_abs"] < ORACLE_TOL


def test_splitkv_config_matches_jax():
    """The port's SplitKVConfig: JAX's fields and defaults, its validation
    and its span arithmetic."""
    jf = {f.name: f.default for f in dataclasses.fields(
        jconfigs.SplitKVConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(SplitKVConfig)}
    assert pf == jf
    for bad in ({"block_q": 96}, {"block_kv": 0}, {"softmax": "max"},
                {"head_fold": 3}, {"d_tile_qk": 64}, {"q_chunk": 12}):
        with pytest.raises(ValueError):
            jconfigs.SplitKVConfig(**bad)
        with pytest.raises(ValueError):
            SplitKVConfig(**bad)
    for kw in ({}, {"block_kv": 128, "kv_tiles_per_block": 3}):
        jc, pc = _cfgs(**kw)
        assert pc.kv_block_len == jc.kv_block_len
        for lkv in (1, 7, 100, 300, 512, 2049):
            assert pc.num_kv_blocks(lkv) == jc.num_kv_blocks(lkv)


def _partials(seed, shape, dead=()):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((*shape, 64)).astype(np.float32)
    lse = (rng.standard_normal(shape) * 4).astype(np.float32)
    for idx in dead:
        lse[idx] = -np.inf
        o[idx] = 0.0
    return o, lse


def test_merge_partials_matches_jax():
    """The same formula on both sides.  Where it needs no transcendental
    (either side empty, both empty, equal LSEs) the results are bitwise
    equal; elsewhere XLA's and PyTorch's CPU exp and log differ in the
    last bit for about one f32 input in ten (measured on 1e5 normal
    values), so O and LSE agree to 1e-6 abs."""
    shape = (2, 3, 40)
    o_a, lse_a = _partials(21, shape, dead=[(0, 0, slice(0, 10)),
                                            (1, 2, slice(5, 20))])
    o_b, lse_b = _partials(22, shape, dead=[(0, 0, slice(5, 15)),
                                            (1, 1, slice(0, 40))])
    lse_b[0, 1, :8] = lse_a[0, 1, :8]                 # equal LSEs
    with jax.default_device(jax.devices("cpu")[0]):
        o_j, lse_j = (np.asarray(x) for x in jax_merge_partials(
            *_j(o_a, lse_a, o_b, lse_b)))
    o, lse = merge_partials(*_t(o_a, lse_a, o_b, lse_b))
    o, lse = o.numpy(), lse.numpy()
    np.testing.assert_allclose(o, o_j, atol=1e-6)
    np.testing.assert_allclose(lse, lse_j, atol=1e-6)
    exact = (np.isneginf(lse_a) | np.isneginf(lse_b)
             | (lse_a == lse_b))
    assert exact.sum() > 70
    assert np.array_equal(o[exact], o_j[exact])
    assert np.array_equal(lse[exact], lse_j[exact])
    both = np.isneginf(lse_a) & np.isneginf(lse_b)
    assert both.any() and np.isneginf(lse[both]).all()
    assert (o[both] == 0).all()
    # the identity (0, -inf) leaves the other operand bitwise unchanged
    ident = (np.zeros_like(o_a), np.full_like(lse_a, -np.inf))
    o_i, lse_i = merge_partials(*_t(o_a, lse_a, *ident))
    assert np.array_equal(o_i.numpy(), o_a)
    assert np.array_equal(lse_i.numpy(), lse_a)
