"""Port paged INT8 cache and decode (kernel H6-decode's plain version) vs
the JAX package.

Both packages fill their caches from the same NumPy K/V through
``append_prompts`` and ``append_tokens``.  The JAX cache packs two heads
per 128-lane row at d=64 and the port's does not, so the caches are
compared through ``gather_kv`` (dequantized [Hkv, L, d]).  Under ``jit``,
XLA rewrites the JAX cache's ``absmax / 127`` into ``absmax * (1/127)``,
so a scale may differ from the port's division by one ulp: the
dequantized caches agree to rtol 1e-6 (the int8 codes are equal here).
Decode outputs agree to atol 1e-5 (f32, summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.serving import kv_cache as jkv
from exploring_flash_attention_tpu.serving.decode import (
    paged_decode_attention as jax_paged_decode_attention,
)
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.serving import (
    PageAllocator,
    append_prompts,
    append_tokens,
    gather_kv,
    make_cache,
    paged_decode_attention,
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


def test_paged_decode_refuses_window():
    tc = make_cache(2, 64, 4, page_size=PS, max_seqs=2, device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        paged_decode_attention(torch.ones((1, 4, 64)), tc,
                               torch.tensor([0], dtype=torch.int32),
                               window=16)


def test_allocator_exhaustion_and_reuse():
    alloc = PageAllocator(4)
    a = alloc.alloc(3)
    with pytest.raises(MemoryError):
        alloc.alloc(2)
    alloc.free(a)
    assert alloc.free_pages == 4
