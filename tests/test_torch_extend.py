"""Port multi-turn path vs the JAX package: ``append_chunks``, paged extend
attention (kernel H6-extend's plain version) and
``generate(hold=True)`` + ``continue_generation``.

Both packages fill their caches from the same NumPy K/V.  The JAX cache
packs two heads per 128-lane row at d=64 and the port's does not, so the
caches are compared through ``gather_kv`` (dequantized [Hkv, L, d]), to
rtol 1e-6: under ``jit`` XLA rewrites ``absmax / 127`` into a multiply,
so a scale may differ from the port's division by one ulp.  Extend
outputs agree to atol 1e-5 (both f32, O a convex combination of O(1)
values; they differ in summation order only), on both TPU routes (B22
one-pass and B21 streaming), with and without a sliding window, and
against the f64 oracle over the gathered cache.  At a small f32 config
both engines emit the same greedy tokens over two turns, the windowed
model's too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.models import generate as jgen
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.serving import decode as jdec
from exploring_flash_attention_tpu.serving import kv_cache as jkv
from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    ModelConfig,
    forward_collect_kv,
    init_params,
)
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.serving import (
    append_chunks,
    append_prompts,
    gather_kv,
    make_cache,
    paged_decode_plain,
    paged_extend_attention,
    paged_extend_plain,
)

ATOL = 1e-5
PS = 128
HIST = (100, 150)                 # ragged, not page-aligned


def _fill_both(seed, hkv, d, hist, c, max_pages=3):
    """The same ragged prompts and one C-token chunk in a JAX and a port
    cache; slot s owns pages [3s, 3s+3) in a permuted order."""
    b = len(hist)
    rng = np.random.default_rng(seed)
    table = np.zeros((b, max_pages), np.int32)
    for s in range(b):
        table[s] = np.roll(np.arange(max_pages), s + 1) + max_pages * s
    prompts = [(rng.standard_normal((1, n, hkv, d)).astype(np.float32),
                rng.standard_normal((1, n, hkv, d)).astype(np.float32))
               for n in hist]
    k_c = rng.standard_normal((b, c, hkv, d)).astype(np.float32)
    v_c = rng.standard_normal((b, c, hkv, d)).astype(np.float32)
    slots = np.arange(b, dtype=np.int32)

    jc = jkv.make_cache(hkv, d, b * max_pages, page_size=PS, max_seqs=b,
                        max_pages_per_seq=max_pages)
    jc = jkv.PagedKVCache(jc.kv_pages, jc.kv_scales, jnp.asarray(table),
                          jc.seq_lens, jc.page_size, jc.head_pack)
    tc = make_cache(hkv, d, b * max_pages, page_size=PS, max_seqs=b,
                    max_pages_per_seq=max_pages, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    tslots = torch.from_numpy(slots)
    for s, (kp, vp) in enumerate(prompts):
        jc = jkv.append_prompts(jc, jnp.asarray(slots[s:s + 1]),
                                jnp.asarray(kp), jnp.asarray(vp))
        append_prompts(tc, tslots[s:s + 1], torch.from_numpy(kp),
                       torch.from_numpy(vp))
    jc = jkv.append_chunks(jc, jnp.asarray(slots), jnp.asarray(k_c),
                           jnp.asarray(v_c))
    append_chunks(tc, tslots, torch.from_numpy(k_c), torch.from_numpy(v_c))
    return jc, tc, slots


@pytest.mark.parametrize("c", [1, 130])
def test_append_chunks_matches_jax_through_gather(c):
    """Chunks start at 100 and 150 (not page-aligned); at C=130 both cross
    a page boundary (128 and 256)."""
    hkv, d = 2, 64
    jc, tc, _ = _fill_both(0, hkv, d, HIST, c)
    for s, n in enumerate(HIST):
        assert int(tc.seq_lens[s]) == int(jc.seq_lens[s]) == n + c
        jk, jv = jkv.gather_kv(jc, s)
        tk, tv = gather_kv(tc, s)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
        # the rows past the chunk's end in its last page stay unwritten
        last = int(tc.page_table[s, (n + c - 1) // PS])
        tail = (n + c) % PS
        if tail:
            assert not tc.kv_pages[last, :, :, tail:].any()
            assert not tc.kv_scales[last, :, :, :, tail:].any()


@pytest.mark.parametrize("route", ["b22_onepass", "b21_streaming"])
def test_paged_extend_matches_jax(route, monkeypatch):
    """The JAX wrapper picks B22 when its VMEM estimate fits the budget;
    a zero budget forces B21, as tests/test_serving.py does."""
    if route == "b21_streaming":
        monkeypatch.setattr(jdec, "EXTEND_ONEPASS_MAX_BYTES", 0)
    hq, hkv, d, c = 4, 2, 64, 40
    jc, tc, slots = _fill_both(1, hkv, d, HIST, c)
    q = np.random.default_rng(2).standard_normal(
        (len(HIST), c, hq, d)).astype(np.float32)
    onepass = (jdec.extend_onepass_vmem_bytes(jc, jnp.float32)
               <= jdec.EXTEND_ONEPASS_MAX_BYTES)
    assert onepass == (route == "b22_onepass")
    ref = jdec.paged_extend_attention(jnp.asarray(q), jc, jnp.asarray(slots))
    got = paged_extend_attention(torch.from_numpy(q), tc,
                                 torch.from_numpy(slots))
    assert got.shape == (len(HIST), c, hq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("hq,hkv,c", [(4, 2, 40), (8, 2, 77), (4, 4, 1)])
def test_paged_extend_matches_f64_oracle(hq, hkv, c):
    """Every chunk row i against naive attention over the gathered cache's
    first n + i + 1 positions; C=1 is also exactly the decode version."""
    d = 64
    _, tc, slots = _fill_both(3, hkv, d, HIST, c)
    q = np.random.default_rng(4).standard_normal(
        (len(HIST), c, hq, d)).astype(np.float32)
    got = paged_extend_attention(torch.from_numpy(q), tc,
                                 torch.from_numpy(slots)).numpy()
    for s, n in enumerate(HIST):
        k, v = (x.numpy() for x in gather_kv(tc, s))      # [Hkv, L, d]
        for i in range(c):
            ref = naive_attention(q[s, i].reshape(hkv, hq // hkv, d),
                                  k[:, :n + i + 1], v[:, :n + i + 1])
            np.testing.assert_allclose(
                got[s, i].reshape(hkv, hq // hkv, d), ref, atol=ATOL)
    if c == 1:
        qt = torch.from_numpy(q)
        torch.testing.assert_close(
            paged_extend_plain(qt, tc, torch.from_numpy(slots), 0.125)[:, 0],
            paged_decode_plain(qt[:, 0], tc, torch.from_numpy(slots), 0.125),
            rtol=0, atol=0)


def test_paged_extend_chunk_over_empty_history_and_window():
    """A chunk that is the whole sequence is causal attention over itself,
    and under a window of 8 banded attention over itself (each row sees
    its last 8 positions, the f64 oracle's band)."""
    hq, hkv, d, c = 4, 2, 64, 20
    rng = np.random.default_rng(5)
    tc = make_cache(hkv, d, 2, page_size=PS, max_seqs=1, max_pages_per_seq=2,
                    device="cpu")
    tc.page_table[0] = torch.tensor([1, 0], dtype=torch.int32)
    k = rng.standard_normal((1, c, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, c, hkv, d)).astype(np.float32)
    slots = torch.zeros(1, dtype=torch.int32)
    append_chunks(tc, slots, torch.from_numpy(k), torch.from_numpy(v))
    q = rng.standard_normal((1, c, hq, d)).astype(np.float32)
    got = paged_extend_attention(torch.from_numpy(q), tc, slots).numpy()
    kf, vf = (x.numpy() for x in gather_kv(tc, 0))
    rep = lambda x: np.repeat(x, hq // hkv, axis=0)       # noqa: E731
    ref = naive_attention(q[0].transpose(1, 0, 2), rep(kf), rep(vf),
                          causal=True)                    # [Hq, C, d]
    np.testing.assert_allclose(got[0].transpose(1, 0, 2), ref, atol=ATOL)
    banded = paged_extend_attention(torch.from_numpy(q), tc, slots,
                                    window=8).numpy()
    ref = naive_attention(q[0].transpose(1, 0, 2), rep(kf), rep(vf),
                          causal=True, window=8)
    np.testing.assert_allclose(banded[0].transpose(1, 0, 2), ref, atol=ATOL)
    assert np.abs(banded[0, 8:] - got[0, 8:]).max() > 1e-3
    np.testing.assert_array_equal(banded[0, :8], got[0, :8])


@pytest.mark.parametrize("window", [30, 130, 500])
@pytest.mark.parametrize("route", ["b22_onepass", "b21_streaming"])
def test_windowed_paged_extend_matches_jax_and_banded_oracle(route, window,
                                                             monkeypatch):
    """``paged_extend_attention(window=)`` against JAX's on both TPU routes
    (atol 1e-5) and every chunk row against the f64 oracle over its band
    of the gathered cache.  Chunk rows sit at 100..139 and 150..189: a
    window of 30 lies inside a page for some rows and crosses 128 for
    others, 130 reaches back over a page boundary, 500 holds every key
    (equal to no window)."""
    if route == "b21_streaming":
        monkeypatch.setattr(jdec, "EXTEND_ONEPASS_MAX_BYTES", 0)
    hq, hkv, d, c = 4, 2, 64, 40
    jc, tc, slots = _fill_both(6, hkv, d, HIST, c)
    q = np.random.default_rng(7).standard_normal(
        (len(HIST), c, hq, d)).astype(np.float32)
    ref = jdec.paged_extend_attention(jnp.asarray(q), jc, jnp.asarray(slots),
                                      window=window)
    got = paged_extend_attention(torch.from_numpy(q), tc,
                                 torch.from_numpy(slots), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    for s, n in enumerate(HIST):
        k, v = (x.numpy() for x in gather_kv(tc, s))      # [Hkv, L, d]
        for i in range(0, c, 3):
            pos = n + i
            lo = max(0, pos - window + 1)
            oracle = naive_attention(q[s, i].reshape(hkv, hq // hkv, d),
                                     k[:, lo:pos + 1], v[:, lo:pos + 1])
            np.testing.assert_allclose(
                got[s, i].numpy().reshape(oracle.shape), oracle, atol=ATOL)
    if window >= max(HIST) + c:
        np.testing.assert_array_equal(
            got.numpy(), paged_extend_attention(
                torch.from_numpy(q), tc, torch.from_numpy(slots)).numpy())


KW = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=128,
          d_head=64, d_ff=256)


def _turns(seed, b, l_prompt, l_turn):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, KW["vocab_size"], (b, l_prompt)).astype(np.int32),
            rng.integers(0, KW["vocab_size"], (b, l_turn)).astype(np.int32))


def test_multi_turn_greedy_tokens_match_jax_engine():
    """Turn 2 starts at position 20 + 4 - 1 = 23 and crosses no page; the
    chunk reads the history of both turns through the extend path."""
    prompt, turn_new = _turns(0, 2, 20, 9)
    jcfg = jtf.ModelConfig(**KW)
    jeng = jgen.GenerationEngine(jtf.init_params(jcfg, seed=0), jcfg,
                                 max_seqs=2, max_len=256)
    j1 = np.asarray(jeng.generate(jnp.asarray(prompt), 4, hold=True))
    jturn = np.concatenate([j1[:, -1:], turn_new], axis=1)
    j2 = np.asarray(jeng.continue_generation(jnp.asarray(jturn), 3))
    jeng.release()

    eng = GenerationEngine(
        init_params(ModelConfig(**KW), seed=0, device="cpu"),
        ModelConfig(**KW), max_seqs=2, max_len=256)
    t1 = eng.generate(prompt, 4, hold=True)
    np.testing.assert_array_equal(t1, j1)
    t2 = eng.continue_generation(
        np.concatenate([t1[:, -1:], turn_new], axis=1), 3)
    assert t2.shape == (2, 3) and t2.dtype == np.int32
    np.testing.assert_array_equal(t2, j2)
    eng.release()
    assert eng.allocator.free_pages == eng.allocator.n_pages


def test_windowed_multi_turn_greedy_tokens_match_jax_engine():
    """The windowed model (window 48) on both engines: prompts of 128
    tokens (JAX's band prefill takes lane-aligned lengths), longer than
    the window, so every decode step and the second turn's chunk (at
    positions 130..139, inside one page) read only their band of the
    paged history; the greedy tokens of both turns are equal."""
    prompt, turn_new = _turns(3, 2, 128, 10)
    jcfg = jtf.ModelConfig(**KW, window=48)
    jeng = jgen.GenerationEngine(jtf.init_params(jcfg, seed=0), jcfg,
                                 max_seqs=2, max_len=256)
    j1 = np.asarray(jeng.generate(jnp.asarray(prompt), 3, hold=True))
    jturn = np.concatenate([j1[:, -1:], turn_new], axis=1)
    j2 = np.asarray(jeng.continue_generation(jnp.asarray(jturn), 4))
    jeng.release()

    cfg = ModelConfig(**KW, window=48)
    eng = GenerationEngine(init_params(cfg, seed=0, device="cpu"), cfg,
                           max_seqs=2, max_len=256)
    t1 = eng.generate(prompt, 3, hold=True)
    np.testing.assert_array_equal(t1, j1)
    t2 = eng.continue_generation(
        np.concatenate([t1[:, -1:], turn_new], axis=1), 4)
    np.testing.assert_array_equal(t2, j2)
    eng.release()


def test_multi_turn_cache_matches_forward_over_the_stream():
    """tests/test_generate.py:104-154 on the port: after the continuation
    every layer's cache holds the K/V a full forward gives over the
    concatenated stream (prompt ++ turn 1 ++ turn 2's user tokens ++ turn 2
    but its last token), within the int8 roundtrip tier 0.06.  The turn
    starts with turn 1's last token, which was never fed into the cache; a
    stream without it is one token short and must fail the same check."""
    cfg = ModelConfig(**KW)
    params = init_params(cfg, seed=0, device="cpu")
    eng = GenerationEngine(params, cfg, max_seqs=2, max_len=256)
    prompt, turn_new = _turns(1, 2, 120, 20)       # turn 2 crosses 128
    g1 = eng.generate(prompt, 3, hold=True)
    g2 = eng.continue_generation(
        np.concatenate([g1[:, -1:], turn_new], axis=1), 2)
    full = np.concatenate([prompt, g1, turn_new, g2[:, :-1]], axis=1)
    short = np.concatenate([prompt, g1[:, :-1], turn_new, g2[:, :-1]], 1)
    _, kvs = forward_collect_kv(params, torch.from_numpy(full), cfg)
    _, kvs_short = forward_collect_kv(params, torch.from_numpy(short), cfg)
    n = full.shape[1]
    for li, ((k_ref, v_ref), (k_bad, _)) in enumerate(zip(kvs, kvs_short)):
        for s in range(2):
            assert int(eng.caches[li].seq_lens[s]) == n
            k_got, v_got = gather_kv(eng.caches[li], s)   # [Hkv, L, d]
            assert (k_got - k_ref[s].transpose(0, 1)).abs().max() < 0.06
            assert (v_got - v_ref[s].transpose(0, 1)).abs().max() < 0.06
            err_bad = (k_got[:, :n - 1] - k_bad[s].transpose(0, 1)).abs()
            assert err_bad.max() > 0.5, (li, s)
    eng.release()
    assert eng.allocator.free_pages == eng.allocator.n_pages


def test_continue_generation_error_frees_the_slots(monkeypatch):
    from exploring_flash_attention_tpu_torch.models import generate as gen

    cfg = ModelConfig(**KW)
    eng = GenerationEngine(init_params(cfg, seed=2, device="cpu"), cfg,
                           max_seqs=2, max_len=64)
    prompt, turn = _turns(2, 2, 8, 4)
    eng.generate(prompt, 2, hold=True)
    assert eng.allocator.free_pages < eng.allocator.n_pages

    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(gen, "_extend_forward", boom)
    with pytest.raises(RuntimeError, match="boom"):
        eng.continue_generation(turn, 2)
    assert eng.allocator.free_pages == eng.allocator.n_pages
    with pytest.raises(RuntimeError, match="no held slots"):
        eng.continue_generation(turn, 2)
    monkeypatch.undo()
    np.testing.assert_array_equal(eng.generate(prompt, 2),
                                  GenerationEngine(eng.params, cfg, 2, 64)
                                  .generate(prompt, 2))
