"""Port paged INT8 cache and decode (kernel H6-decode's plain version) vs
the JAX package.

Both packages fill their caches from the same NumPy K/V through
``append_prompts`` and ``append_tokens``.  The JAX cache packs two heads
per 128-lane row at d=64 and the port's does not, so the caches are
compared through ``gather_kv`` (dequantized [Hkv, L, d]).  Under ``jit``,
XLA rewrites the JAX cache's ``absmax / 127`` into ``absmax * (1/127)``,
so a scale may differ from the port's division by one ulp: the
dequantized caches agree to rtol 1e-6 (the int8 codes are equal here).
Decode outputs agree to atol 1e-5 (f32, summation order only), with and
without a sliding window, and the split that H6-decode runs on the card
(page runs, then their merge in its last block) is emulated with the
plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.serving import kv_cache as jkv
from exploring_flash_attention_tpu.serving.decode import (
    paged_decode_attention as jax_paged_decode_attention,
)
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    splitkv_combine_plain,
)
from exploring_flash_attention_tpu_torch.serving import (
    PageAllocator,
    append_prompts,
    append_tokens,
    decode_split,
    gather_kv,
    make_cache,
    paged_decode_attention,
    paged_decode_partials,
    paged_decode_partials_plain,
    paged_decode_plain,
)
from exploring_flash_attention_tpu_torch.serving.kv_cache import (
    _quantize_rows,
)

ATOL = 1e-5
PS = 128


def _fill_both(seed, b, hkv, d, l_prompt, n_tokens, max_seqs=4, n_pages=12):
    """The same prompts and appended tokens in a JAX and a port cache;
    slot s owns pages [3s, 3s+3)."""
    rng = np.random.default_rng(seed)
    table = np.zeros((max_seqs, 3), np.int32)
    for s in range(b):
        table[s] = [3 * s + 2, 3 * s, 3 * s + 1]          # not in order
    kp = rng.standard_normal((b, l_prompt, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((b, l_prompt, hkv, d)).astype(np.float32)
    toks = [(rng.standard_normal((b, hkv, d)).astype(np.float32),
             rng.standard_normal((b, hkv, d)).astype(np.float32))
            for _ in range(n_tokens)]
    slots = np.arange(b, dtype=np.int32)

    jc = jkv.make_cache(hkv, d, n_pages, page_size=PS, max_seqs=max_seqs,
                        max_pages_per_seq=3)
    jc = jkv.PagedKVCache(jc.kv_pages, jc.kv_scales, jnp.asarray(table),
                          jc.seq_lens, jc.page_size, jc.head_pack)
    jc = jkv.append_prompts(jc, jnp.asarray(slots), jnp.asarray(kp),
                            jnp.asarray(vp))
    for k, v in toks:
        jc = jkv.append_tokens(jc, jnp.asarray(slots), jnp.asarray(k),
                               jnp.asarray(v))

    tc = make_cache(hkv, d, n_pages, page_size=PS, max_seqs=max_seqs,
                    max_pages_per_seq=3, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    tslots = torch.from_numpy(slots)
    append_prompts(tc, tslots, torch.from_numpy(kp), torch.from_numpy(vp))
    for k, v in toks:
        append_tokens(tc, tslots, torch.from_numpy(k), torch.from_numpy(v))
    return jc, tc, slots


def test_quantize_rows_matches_jax_bitwise():
    x = np.random.default_rng(0).standard_normal((5, 3, 64)).astype(
        np.float32) * 3
    x[1, 2] = 0.0                                         # all-zero row
    jq, js = jkv._quantize_rows(jnp.asarray(x))
    tq, ts = _quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("l_prompt,n_tokens", [(100, 3), (126, 5)])
def test_cache_matches_jax_through_gather(l_prompt, n_tokens):
    """(126, 5) crosses a page boundary during the token appends."""
    b, hkv, d = 2, 2, 64
    jc, tc, _ = _fill_both(0, b, hkv, d, l_prompt, n_tokens)
    for s in range(b):
        assert int(tc.seq_lens[s]) == l_prompt + n_tokens
        jk, jv = jkv.gather_kv(jc, s)
        tk, tv = gather_kv(tc, s)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2), (4, 4)])
def test_paged_decode_matches_jax(hq, hkv):
    b, d = 3, 64
    jc, tc, slots = _fill_both(1, b, hkv, d, 120, 4)
    q = np.random.default_rng(2).standard_normal((b, hq, d)).astype(
        np.float32)
    ref = jax_paged_decode_attention(jnp.asarray(q), jc, jnp.asarray(slots))
    got = paged_decode_attention(torch.from_numpy(q), tc,
                                 torch.from_numpy(slots))
    assert got.shape == (b, hq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_paged_decode_matches_f64_oracle_over_gathered_cache():
    b, hq, hkv, d = 2, 4, 2, 64
    _, tc, slots = _fill_both(3, b, hkv, d, 70, 2)
    q = np.random.default_rng(4).standard_normal((b, hq, d)).astype(
        np.float32)
    got = paged_decode_attention(torch.from_numpy(q), tc,
                                 torch.from_numpy(slots)).numpy()
    for s in range(b):
        k, v = gather_kv(tc, s)                          # [Hkv, L, d]
        ref = naive_attention(q[s].reshape(hkv, hq // hkv, d),
                              k.numpy(), v.numpy())
        np.testing.assert_allclose(got[s].reshape(hkv, hq // hkv, d), ref,
                                   atol=ATOL)


def test_paged_decode_empty_sequence_gives_zeros():
    tc = make_cache(2, 64, 4, page_size=PS, max_seqs=2, device="cpu")
    q = torch.ones((1, 4, 64))
    out = paged_decode_attention(q, tc, torch.tensor([1], dtype=torch.int32))
    assert (out == 0).all()


LENS = (450, 100, 800)            # tests/test_serving.py:170's contexts


def _fill_ragged(seed, hkv, d, lens, max_pages=7):
    """Ragged prompts (one ``append_prompts`` per slot) in a JAX and a port
    cache; slot s owns pages [7s, 7s+7) in a permuted order."""
    b = len(lens)
    rng = np.random.default_rng(seed)
    table = np.stack([np.roll(np.arange(max_pages), s + 2) + max_pages * s
                      for s in range(b)]).astype(np.int32)
    jc = jkv.make_cache(hkv, d, b * max_pages, page_size=PS, max_seqs=b,
                        max_pages_per_seq=max_pages)
    jc = jkv.PagedKVCache(jc.kv_pages, jc.kv_scales, jnp.asarray(table),
                          jc.seq_lens, jc.page_size, jc.head_pack)
    tc = make_cache(hkv, d, b * max_pages, page_size=PS, max_seqs=b,
                    max_pages_per_seq=max_pages, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    slots = np.arange(b, dtype=np.int32)
    for s, n in enumerate(lens):
        kp = rng.standard_normal((1, n, hkv, d)).astype(np.float32)
        vp = rng.standard_normal((1, n, hkv, d)).astype(np.float32)
        jc = jkv.append_prompts(jc, jnp.asarray(slots[s:s + 1]),
                                jnp.asarray(kp), jnp.asarray(vp))
        append_prompts(tc, torch.from_numpy(slots[s:s + 1]),
                       torch.from_numpy(kp), torch.from_numpy(vp))
    return jc, tc, slots


def _jax_cache_of(tc, jc):
    """A JAX cache holding the port cache's codes and scales, in the JAX
    layout (``jc.head_pack`` consecutive heads on one row's lanes), so
    that both decode functions read the same data: filled apart, a scale
    one ulp apart can move a code by one (a 1.5e-5 change of O over 4500
    tokens)."""
    n, _, hkv, ps, d = tc.kv_pages.shape
    pk = jc.head_pack
    pages = tc.kv_pages.numpy().reshape(n, 2, hkv // pk, pk, ps, d)
    pages = pages.transpose(0, 1, 2, 4, 3, 5).reshape(n, 2, hkv // pk, ps,
                                                      pk * d)
    return jkv.PagedKVCache(
        jnp.asarray(pages), jnp.asarray(tc.kv_scales.numpy()),
        jnp.asarray(tc.page_table.numpy()), jnp.asarray(tc.seq_lens.numpy()),
        jc.page_size, pk)


@pytest.mark.parametrize("window", [50, 200, 300, 1000])
def test_windowed_decode_matches_jax_and_banded_oracle(window):
    """tests/test_serving.py:170 on the port, against JAX's
    ``paged_decode_attention(window=)`` (atol 1e-5, f32 summation order)
    and the f64 oracle over each slot's band of the gathered cache.  The
    band lies inside one page (50 of 450), crosses pages (200, 300), or
    holds the whole context (1000, equal to no window); where it is
    narrower than the context the result must differ from full decode."""
    hq, hkv, d = 4, 2, 64
    jc, tc, slots = _fill_ragged(11, hkv, d, LENS)
    q = np.random.default_rng(12).standard_normal(
        (len(LENS), hq, d)).astype(np.float32)
    ref = np.asarray(jax_paged_decode_attention(
        jnp.asarray(q), jc, jnp.asarray(slots), window=window))
    got = paged_decode_attention(torch.from_numpy(q), tc,
                                 torch.from_numpy(slots), window=window)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    full = paged_decode_attention(torch.from_numpy(q), tc,
                                  torch.from_numpy(slots)).numpy()
    for s, n in enumerate(LENS):
        k, v = gather_kv(tc, s)                          # [Hkv, L, d]
        lo = max(0, n - window)
        oracle = naive_attention(q[s].reshape(hkv, hq // hkv, d),
                                 k.numpy()[:, lo:], v.numpy()[:, lo:])
        np.testing.assert_allclose(got[s].numpy().reshape(oracle.shape),
                                   oracle, atol=ATOL)
        if n > window:
            assert np.abs(got[s].numpy() - full[s]).max() > 1e-3, s
        else:
            np.testing.assert_array_equal(got[s].numpy(), full[s])


@pytest.mark.parametrize("window,n_sms,lens,max_pages", [
    pytest.param(None, 132, LENS + (0,), 7, id="None-132"),
    pytest.param(None, 8, LENS + (0,), 7, id="None-8"),
    pytest.param(None, 1, LENS + (0,), 7, id="None-1"),
    pytest.param(200, 132, LENS + (0,), 7, id="200-132"),
    pytest.param(60, 4, LENS + (0,), 7, id="60-4"),
    # B=1 over 36 of 40 pages: 40 runs of one page, more than the 32
    # lanes that hold a row's partials in H6-decode's merge
    pytest.param(None, 132, (4500,), 40, id="None-132-40-runs"),
])
def test_decode_split_partials_merge_to_plain_decode(window, n_sms, lens,
                                                     max_pages):
    """H6-decode's split, emulated with its plain versions: the planner's
    page runs, each run's (O, LSE), then the merge that H6-decode's last
    block does (``splitkv_combine_plain``) must give the unsplit plain
    decode (atol 1e-6: f32, the merge's summation order).  Runs cover
    every visible page; a run that sees no key (past the sequence, or a
    slot whose length is 0) is the merge identity (0, -inf).  With more
    than 32 runs the port's ``paged_decode_attention`` is also held
    against the JAX function's (atol 1e-5)."""
    hq, hkv, d = 4, 2, 64
    jc, tc, slots = _fill_ragged(13, hkv, d, lens, max_pages)
    q = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (len(slots), hq, d)).astype(np.float32))
    ts = torch.from_numpy(slots)
    n_split, per = decode_split(tc, len(slots), window, n_sms)
    span = (tc.max_pages_per_seq if window is None
            else min(tc.max_pages_per_seq, -(-window // PS) + 1))
    assert n_split * per >= span and (n_split - 1) * per < span
    assert n_split == 1 or len(slots) * hkv * n_split <= 2 * n_sms
    o, lse = paged_decode_partials_plain(q, tc, ts, 0.125, window, n_split,
                                         per)
    assert o.shape == (len(slots), hq, n_split, 1, d)
    assert lse.shape == (len(slots), hq, n_split, 1)
    merged = splitkv_combine_plain(o, lse)[:, :, 0]
    ref = paged_decode_plain(q, tc, ts, 0.125, window)
    torch.testing.assert_close(merged, ref, rtol=0, atol=1e-6)
    for s, n in enumerate(lens):
        first = max(n - window, 0) if window else 0
        n_runs = -(-(-(-n // PS) - first // PS) // per) if n else 0
        empty = slice(n_runs, None)
        assert (lse[s, :, empty] == float("-inf")).all(), s
        assert (o[s, :, empty] == 0).all(), s
        assert torch.isfinite(lse[s, :, :n_runs]).all(), s
    if n_sms == 132:                # what the CPU entry point plans
        got = paged_decode_partials(q, tc, ts, 0.125, window)
        torch.testing.assert_close(got[0], o, rtol=0, atol=0)
        torch.testing.assert_close(got[1], lse, rtol=0, atol=0)
    if max_pages > 32:
        assert n_split > 32
        want = jax_paged_decode_attention(jnp.asarray(q.numpy()),
                                          _jax_cache_of(tc, jc),
                                          jnp.asarray(slots), scale=0.125)
        got = paged_decode_attention(q, tc, ts, scale=0.125)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), merged.numpy(), atol=ATOL)


def test_paged_decode_refuses_a_window_below_one():
    tc = make_cache(2, 64, 4, page_size=PS, max_seqs=2, device="cpu")
    for bad in (0, -3):
        with pytest.raises(ValueError, match="window"):
            paged_decode_attention(torch.ones((1, 4, 64)), tc,
                                   torch.tensor([0], dtype=torch.int32),
                                   window=bad)


def test_allocator_exhaustion_and_reuse():
    alloc = PageAllocator(4)
    a = alloc.alloc(3)
    with pytest.raises(MemoryError):
        alloc.alloc(2)
    alloc.free(a)
    assert alloc.free_pages == 4
