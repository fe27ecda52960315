"""The port's ``flash_attention_v1`` and its LSE partials vs the JAX package.

The same NumPy inputs go through the JAX function (Pallas in interpret mode
on the CPU, as ``tests/test_attention_v1.py`` runs it) and through the
port's CPU path (kernel H1's plain version), in f32.  Each side is held
against the f64 oracle first, so that a failure names the side that
drifted, then the two against each other.

Tolerance: 2e-5 abs on f32 O and LSE, as ``tests/test_attention_v1.py``
uses: both sides compute in f32 and differ only in summation order (O is a
convex combination of O(1) values, LSE is O(1)).  The one bf16 case states
its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import SplitKVConfig
from exploring_flash_attention_tpu.ops.attention_v1 import (
    fits_onepass,
    flash_attention_v1 as jax_flash_attention_v1,
    flash_attention_v1_causal_partial as jax_causal_partial,
    flash_attention_v1_window_partial as jax_window_partial,
    onepass_span,
    window_onepass_eligible,
)
from exploring_flash_attention_tpu.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial as jax_splitkv_partial,
    splitkv_combine as jax_splitkv_combine,
)
from exploring_flash_attention_tpu.oracle.reference import (
    make_qkv as jax_make_qkv,
    naive_attention as jax_naive_attention,
)
from exploring_flash_attention_tpu.parallel.partials import (
    attention_partial_local as jax_attention_partial_local,
)
from exploring_flash_attention_tpu_torch.oracle import (
    make_qkv,
    naive_attention,
)
from exploring_flash_attention_tpu_torch.ops import (
    attention_partial_local,
    flash_attention_v1,
    flash_attention_v1_causal_partial,
    flash_attention_v1_window_partial,
    prefill_attention,
    splitkv_combine,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
    split_kv_span,
)

ATOL = 2e-5
LOG2E = 1.4426950408889634


def _qkv(seed, b, hq, hkv, lq, lkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lkv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lkv, d)).astype(np.float32)
    return q, k, v


def _rep(x, hq):
    return np.repeat(x, hq // x.shape[1], axis=1)


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _check_both(port, jax_out, ref, atol=ATOL, what="O"):
    for side, x in (("jax", np.asarray(jax_out)), ("port", port)):
        np.testing.assert_allclose(x, ref, atol=atol,
                                   err_msg=f"{side} {what} vs f64 oracle")
    np.testing.assert_allclose(port, np.asarray(jax_out), atol=atol,
                               err_msg=f"port {what} vs jax")


# (JAX route the case stands for, B, Hq, Hkv, Lq, Lkv, d, causal, window)
V1_CASES = [
    ("b1_fold_dense", 1, 4, 4, 128, 128, 64, False, None),
    ("b2_gqa", 1, 4, 2, 128, 128, 64, False, None),
    ("b2_ragged_kv", 1, 2, 2, 128, 200, 64, False, None),
    ("b3_ragged_q", 1, 2, 2, 100, 128, 64, False, None),
    ("cross_lq_lt_lkv", 1, 2, 1, 64, 256, 64, False, None),
    ("b4_causal", 1, 2, 2, 256, 256, 64, True, None),
    ("b4_causal_cross_gqa", 1, 4, 2, 128, 384, 64, True, None),
    ("b3_causal_ragged", 1, 2, 1, 100, 136, 64, True, None),
    ("b5_window_1", 1, 2, 2, 256, 256, 64, True, 1),
    ("b5_window_32", 1, 2, 2, 256, 256, 64, True, 32),
    ("b5_window_96", 1, 2, 2, 256, 256, 64, True, 96),
    ("b5_window_gqa_cross", 1, 4, 2, 128, 384, 64, True, 100),
    ("b3_window_ragged", 1, 2, 2, 100, 136, 64, True, 16),
    ("b6_d32_gqa", 1, 4, 2, 128, 128, 32, False, None),
    ("b7_d32_fold", 1, 4, 4, 256, 256, 32, False, None),
    ("b3_d32_causal", 1, 2, 2, 128, 128, 32, True, None),
]


@pytest.mark.parametrize("route,b,hq,hkv,lq,lkv,d,causal,window", V1_CASES)
def test_flash_attention_v1_matches_jax(route, b, hq, hkv, lq, lkv, d,
                                        causal, window):
    q, k, v = _qkv(sum(map(ord, route)), b, hq, hkv, lq, lkv, d)
    want = jax_flash_attention_v1(*_j(q, k, v), causal=causal, window=window)
    got = flash_attention_v1(*_t(q, k, v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    ref = naive_attention(q, _rep(k, hq), _rep(v, hq), causal=causal,
                          window=window)
    _check_both(got.numpy(), want, ref)


def test_flash_attention_v1_long_kv_split_route():
    """d=32 with Lkv past the JAX one-pass budget: the JAX package takes its
    split-KV span route (B8 partials merged by B10, ``:1680-1713``); the
    port splits too (one Q tile leaves the card short of blocks), H1's
    span partials merged by H2's plain version."""
    lq, lkv, d = 64, 4608, 32
    assert not fits_onepass(lkv, d) and onepass_span(lkv, d, 512)
    assert split_kv_span(1, 1, lq, lkv) == 512       # 9 spans
    q, k, v = _qkv(11, 1, 1, 1, lq, lkv, d)
    want = jax_flash_attention_v1(*_j(q, k, v))
    got = flash_attention_v1(*_t(q, k, v))
    _check_both(got.numpy(), want, naive_attention(q, k, v))


@pytest.mark.parametrize("b,hq,lq,lkv,span", [
    (32, 8, 1024, 1024, None),     # bench.py's shape: 2048 blocks
    (1, 8, 1024, 2048, 1024),      # 64 blocks: 2 spans fill one wave
    (1, 8, 1024, 8192, 4096),
    (1, 16, 1024, 8192, None),     # 128 blocks: one wave already
    (1, 1, 64, 4224, 640),         # one Q tile: 8 spans of whole 128-key
                                   # tiles, at least 512 keys each
    (1, 4, 128, 1000, None),       # too short to cut into two 512-key spans
])
def test_split_kv_span_fills_the_card(b, hq, lq, lkv, span):
    assert split_kv_span(b, hq, lq, lkv) == span


@pytest.mark.parametrize("route,hq,hkv,lq,lkv,span,causal", [
    ("b8_multi_span", 4, 2, 128, 512, 128, False),
    ("b9_ragged_span", 2, 2, 100, 500, 256, False),
    ("b9_causal_cross", 4, 2, 64, 320, 128, True),
])
def test_span_partials_match_jax_splitkv_partial(route, hq, hkv, lq, lkv,
                                                 span, causal):
    """H1's span mode (plain path) vs ``flash_attention_splitkv_partial``
    with the same spans: B8's multi-span form where the spans tile Lkv,
    B9 where the last one is ragged; each span's (O, LSE), with the f64
    oracle over the span's keys refereeing both sides."""
    q, k, v = _qkv(sum(map(ord, route)), 1, hq, hkv, lq, lkv, 64)
    cfg = SplitKVConfig(block_q=64, block_kv=64,
                        kv_tiles_per_block=span // 64)
    o_j, lse_j = jax_splitkv_partial(*_j(q, k, v), config=cfg, causal=causal)
    o, lse = prefill_attention(*_t(q, k, v), 0.125, lkv - lq, causal,
                               kv_span=span)
    nkb = -(-lkv // span)
    assert o.shape == (1, hq, nkb, lq, 64) and lse.shape == (1, hq, nkb, lq)
    assert o_j.shape == o.shape
    kr, vr = _rep(k, hq), _rep(v, hq)
    for i, s0 in enumerate(range(0, lkv, span)):
        o64, lse64 = _f64_banded(q, kr[:, :, s0:s0 + span],
                                 vr[:, :, s0:s0 + span],
                                 lkv - lq - s0 if causal else lkv, None)
        _check_both(o.numpy()[:, :, i], np.asarray(o_j)[:, :, i], o64)
        fin = np.isfinite(lse64)
        for side, x in (("jax", np.asarray(lse_j)[:, :, i]),
                        ("port", lse.numpy()[:, :, i])):
            assert (np.isfinite(x) == fin).all(), side
        _check_both(lse.numpy()[:, :, i][fin], np.asarray(lse_j)[:, :, i][fin],
                    lse64[fin], what="LSE")


@pytest.mark.parametrize("d,nkb", [(32, 4), (64, 33), (128, 2)])
def test_splitkv_combine_matches_jax(d, nkb):
    """H2's plain version vs ``splitkv_combine`` on partials whose rows
    include a span that saw nothing (0, -inf) and a row that saw nothing
    in any span (gives 0); the f64 merge referees both.  The (d, nkb)
    pairs are H2's three row layouts on the card (a row of d / 4 lanes),
    33 partials being more than a row's lanes."""
    rng = np.random.default_rng(22)
    o_p = rng.standard_normal((2, 3, nkb, 40, d)).astype(np.float32)
    lse = (3 * rng.standard_normal((2, 3, nkb, 40))).astype(np.float32)
    o_p[:, :, 1, :7] = 0
    lse[:, :, 1, :7] = -np.inf
    o_p[0, 0, :, 5] = 0
    lse[0, 0, :, 5] = -np.inf
    want = jax_splitkv_combine(*_j(o_p, lse))
    got = splitkv_combine(*_t(o_p, lse))
    m = np.max(lse, axis=2, keepdims=True)
    w = np.exp(lse.astype(np.float64) - np.where(np.isneginf(m), 0, m))
    w /= np.where(w.sum(2, keepdims=True) == 0, 1, w.sum(2, keepdims=True))
    ref = (o_p * w[..., None]).sum(2)
    _check_both(got.numpy(), want, ref)
    assert (got[0, 0, 5] == 0).all()
    assert splitkv_combine(*_t(o_p, lse), out_dtype=torch.bfloat16).dtype == \
        torch.bfloat16


def test_flash_attention_v1_scale_override():
    q, k, v = _qkv(12, 1, 2, 2, 128, 128, 64)
    want = jax_flash_attention_v1(*_j(q, k, v), scale=0.25)
    got = flash_attention_v1(*_t(q, k, v), scale=0.25)
    _check_both(got.numpy(), want, naive_attention(q, k, v, scale=0.25))


def test_flash_attention_v1_bf16_in_f32_out():
    """bf16 inputs with ``out_dtype=float32``, refereed on the bf16-rounded
    inputs.  The port's plain path computes in f32 (2e-5 of the oracle);
    the JAX kernel rounds P to bf16 before P V (``attention_v1.py:957``),
    as H1 does on the card, which moves O by up to ~2^-9 of its scale:
    1e-2 abs for that side and for the two against each other."""
    q, k, v = _qkv(13, 1, 4, 2, 256, 256, 64)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = flash_attention_v1(qb, kb, vb, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = np.asarray(jax_flash_attention_v1(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (qb, kb, vb)), out_dtype=jnp.float32))
    assert want.dtype == np.float32
    ref = naive_attention(qb, _rep(kb.float().numpy(), 4),
                          _rep(vb.float().numpy(), 4))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(want, ref, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2)
    assert flash_attention_v1(qb, kb, vb).dtype == torch.bfloat16


@pytest.mark.parametrize("window", [256, 257, 1000])
def test_flash_attention_v1_window_covering_every_key_is_causal(window):
    """A window of Lkv or more is plain causal (``attention_v1.py:1598``);
    Lkv = 256 here."""
    q, k, v = _t(*_qkv(14, 1, 2, 1, 192, 256, 64))
    want = flash_attention_v1(q, k, v, causal=True)
    assert torch.equal(
        flash_attention_v1(q, k, v, causal=True, window=window), want)


@pytest.mark.parametrize("case,kw,shapes", [
    ("k_shape", {}, ((1, 2, 8, 64), (1, 2, 8, 32), (1, 2, 8, 32))),
    ("v_shape", {}, ((1, 2, 8, 64), (1, 2, 8, 64), (1, 2, 9, 64))),
    ("gqa_ratio", {}, ((1, 3, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64))),
    ("window_no_causal", {"window": 4}, None),
    ("window_zero", {"causal": True, "window": 0}, None),
    ("window_negative", {"causal": True, "window": -3}, None),
])
def test_flash_attention_v1_raises_value_error_as_jax(case, kw, shapes):
    shapes = shapes or ((1, 2, 8, 64),) * 3
    rng = np.random.default_rng(15)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    with pytest.raises(ValueError):
        flash_attention_v1(*_t(*xs), **kw)
    with pytest.raises(ValueError):
        jax_flash_attention_v1(*_j(*xs), **kw)


@pytest.mark.parametrize("lq,lkv,positions", [
    (128, 128, None), (64, 200, None), (100, 100, (40, 0)),
])
def test_causal_partial_matches_jax(lq, lkv, positions):
    q, k, v = _qkv(16, 1, 4, 2, lq, lkv, 64)
    o_j, lse_j = jax_causal_partial(*_j(q, k, v), static_positions=positions)
    o, lse = flash_attention_v1_causal_partial(*_t(q, k, v),
                                               static_positions=positions)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    diag = (positions[0] - positions[1]) if positions else lkv - lq
    o64, lse64 = _f64_banded(q, _rep(k, 4), _rep(v, 4), diag, None)
    _check_both(o.numpy(), o_j, o64)
    _check_both(lse.numpy(), lse_j, lse64, what="LSE")


def _f64_banded(q, k, v, diag_off, window, scale=None):
    """f64 attention where row i sees keys j <= i + diag_off (and, with a
    window, j >= i + diag_off - window + 1); a row that sees nothing gives
    (0, -inf).  For offsets other than the decode convention, which
    :func:`naive_attention` fixes."""
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    scale = scale or 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("...qd,...kd->...qk", q64, k64) * scale
    last = np.arange(q.shape[-2])[:, None] + diag_off
    col = np.arange(k.shape[-2])[None, :]
    seen = col <= last
    if window is not None:
        seen &= col >= last - window + 1
    s = np.where(seen, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    m = np.where(np.isneginf(m), 0.0, m)
    w = np.exp(s - m)
    den = w.sum(axis=-1, keepdims=True)
    safe = np.where(den == 0.0, 1.0, den)
    with np.errstate(divide="ignore"):
        lse = np.where(den[..., 0] == 0.0, -np.inf,
                       m[..., 0] + np.log(safe[..., 0]))
    return np.einsum("...qk,...kd->...qd", w / safe, v64), lse


@pytest.mark.parametrize("lq,lkv,window,row_off", [
    (256, 256, 64, 0),
    (128, 256, 100, 0),          # cross: q rows are the last 128 positions
    (64, 256, 40, 64),           # suffix band: rows 39.. see no key
])
def test_window_partial_matches_jax(lq, lkv, window, row_off):
    q, k, v = _qkv(17, 1, 4, 2, lq, lkv, 64)
    o_j, lse_j = jax_window_partial(*_j(q, k, v), window, row_off=row_off)
    o, lse = flash_attention_v1_window_partial(*_t(q, k, v), window,
                                               row_off=row_off)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    o64, lse64 = _f64_banded(q, _rep(k, 4), _rep(v, 4),
                             lkv - lq + row_off, window)
    _check_both(o.numpy(), o_j, o64)
    fin = np.isfinite(lse64)
    for side, x in (("jax", np.asarray(lse_j)), ("port", lse.numpy())):
        assert (np.isfinite(x) == fin).all(), side
    _check_both(lse.numpy()[fin], np.asarray(lse_j)[fin], lse64[fin],
                what="LSE")
    if row_off:                  # the rows whose band misses the KV span
        blind = ~fin[0, 0]
        assert blind.any()
        assert (o.numpy()[..., blind, :] == 0).all()
        assert np.isneginf(lse.numpy()[..., blind]).all()


@pytest.mark.parametrize("causal,window", [
    (False, None), (True, 64), (True, 1), (True, 256),
])
def test_attention_partial_local_routes_match_jax(causal, window):
    """Non-causal, the windowed route (``parallel/partials.py:63-81``, B5
    in JAX) and a window covering every key (plain causal)."""
    lq = lkv = 256
    if window is not None and window < lkv:
        assert window_onepass_eligible(lq, lkv, 64, window)
    q, k, v = _qkv(18, 1, 4, 2, lq, lkv, 64)
    o_j, lse_j = jax_attention_partial_local(*_j(q, k, v), causal=causal,
                                             window=window)
    o, lse = attention_partial_local(*_t(q, k, v), causal=causal,
                                     window=window)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    o64, lse64 = naive_attention(q, _rep(k, 4), _rep(v, 4), causal=causal,
                                 window=window if causal else None,
                                 return_lse=True)
    _check_both(o.numpy(), o_j, o64)
    _check_both(lse.numpy(), lse_j, lse64, what="LSE")


def test_attention_partial_local_window_refusals():
    q, k, v = _t(*_qkv(19, 1, 2, 2, 64, 128, 64))
    with pytest.raises(NotImplementedError, match="positions"):
        attention_partial_local(q, k, v, causal=True, window=16,
                                static_positions=(0, 0))
    with pytest.raises(NotImplementedError, match="causal"):
        attention_partial_local(q, k, v, causal=False, window=16)
    # a window covering every key is causal at any static positions
    o, lse = attention_partial_local(q, k, v, causal=True, window=128,
                                     static_positions=(100, 0))
    o_c, lse_c = attention_partial_local(q, k, v, causal=True,
                                         static_positions=(100, 0))
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)


@pytest.mark.parametrize("lq,lkv,window", [
    (64, 64, 1), (64, 64, 17), (48, 80, 30), (64, 64, 64), (64, 64, 200),
])
def test_port_oracle_window_matches_jax_oracle(lq, lkv, window):
    q, k, v = _qkv(20, 1, 2, 2, lq, lkv, 32)
    want = jax_naive_attention(q, k, v, causal=True, window=window)
    got = naive_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="causal"):
        naive_attention(q, k, v, window=window)


def test_port_make_qkv_draws_what_jax_draws():
    """``chip_smoke.py`` makes bench.py's inputs with the port's copy."""
    for kw in ({}, {"seq_len_kv": 40, "seed": 3}):
        for got, want in zip(make_qkv(2, 3, 24, 32, **kw),
                             jax_make_qkv(2, 3, 24, 32, **kw)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    q, k, v = make_qkv(1, 4, 8, 16, heads_kv=2)
    assert q.shape == (1, 4, 8, 16) and k.shape == v.shape == (1, 2, 8, 16)


# chip_smoke.py's v1 limits on f32 O: bench.py's gate on the canonical
# shape, the further cases', and the window cases' (rows that see a
# handful of keys have |O| up to ~3)
CARD_GATE_TOL = 1e-3
CARD_O_TOL = 2e-3
CARD_WINDOW_O_TOL = 1e-2


def _h1_emulation(q, k, v, scale, causal, diag_off, window):
    """H1's arithmetic on the CPU: 128-key tiles, f32 S in the exp2 basis,
    an online softmax whose P is rounded to bf16 before P V and summed
    into l from the rounded values; f32 O and the natural-log LSE."""
    lq, lkv = q.shape[-2], k.shape[-2]
    m = torch.full(q.shape[:-1], float("-inf"))
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    last = torch.arange(lq)[:, None] + diag_off
    for kv0 in range(0, lkv, 128):
        s = q @ k[..., kv0:kv0 + 128, :].transpose(-1, -2) * (scale * LOG2E)
        col = torch.arange(kv0, min(kv0 + 128, lkv))[None, :]
        seen = torch.ones(lq, col.shape[1], dtype=torch.bool)
        if causal:
            seen &= col <= last
            if window is not None:
                seen &= col >= last - window + 1
        s = s.masked_fill(~seen, float("-inf"))
        m_new = torch.maximum(m, s.max(-1).values)
        m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp2(s - m_use[..., None]).bfloat16().float()
        alpha = torch.exp2(m - m_use)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p @ v[..., kv0:kv0 + 128, :]
        m = m_new
    den = torch.where(l == 0, 1.0, l)
    lse = torch.where(l == 0, float("-inf"), m / LOG2E + torch.log(den))
    return o / den[..., None], lse


@pytest.mark.parametrize("lq,lkv,d,causal,window,span,tol", [
    (1024, 1024, 128, False, None, None, CARD_GATE_TOL),  # canonical shape
    (1024, 1024, 32, False, None, None, CARD_GATE_TOL),   # d=32
    (250, 275, 128, False, None, None, CARD_O_TOL),       # ragged, cross
    (512, 1024, 128, True, None, None, CARD_O_TOL),       # causal, cross
    (1024, 1024, 128, True, 512, None, CARD_WINDOW_O_TOL),  # window
    (1024, 8192, 128, False, None, 4096, CARD_O_TOL),     # H1 spans + H2
])
def test_card_limits_hold_h1_roundings(lq, lkv, d, causal, window, span,
                                       tol):
    """The emulation (with ``span``, H1's span partials merged by H2's
    plain version) reads within half of chip_smoke.py's limit against the
    f64 oracle on the bf16-rounded inputs, one head at each of the v1
    phase's masks, while both known-wrong controls read beyond 5x: the
    scale off by 10%, and the last 64-key tile dropped."""
    gen = torch.Generator().manual_seed(21)
    q, k, v = (torch.randn(1, 1, n, d, generator=gen).bfloat16().float()
               for n in (lq, lkv, lkv))
    scale = 1.0 / np.sqrt(d)
    if span is None:
        emu = _h1_emulation(q, k, v, scale, causal, lkv - lq, window)[0]
    else:
        parts = [_h1_emulation(q, k[..., s:s + span, :], v[..., s:s + span, :],
                               scale, False, 0, None)
                 for s in range(0, lkv, span)]
        emu = splitkv_combine(torch.stack([p[0] for p in parts], 2),
                              torch.stack([p[1] for p in parts], 2))
    emu = emu.numpy()
    ref = naive_attention(q, k, v, causal=causal, window=window)
    bad = naive_attention(q, k, v, scale=1.1 * scale, causal=causal,
                          window=window)
    dropped, _ = _f64_banded(q.numpy(), k[..., :-64, :].numpy(),
                             v[..., :-64, :].numpy(),
                             lkv - lq if causal else lkv, window)
    assert np.abs(emu - ref).max() < tol / 2
    assert np.abs(emu - bad).max() > 5 * tol
    assert np.abs(emu - dropped).max() > 5 * tol
