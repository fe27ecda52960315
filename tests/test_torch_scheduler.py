"""The port's continuous-batching scheduler and the cache functions it
needs (``append_prompt``, ``append_prompts(page_ids=)``, ``set_seq_lens``
and ``append_tokens``' drop of out-of-range slots) vs the JAX package.

Both packages take the same NumPy inputs.  The caches are compared raw at
d = 128 (where the JAX cache packs no heads, so both layouts are the same
bits) and through ``gather_kv``: int8 codes, page tables and lengths
bitwise.  The scales are bitwise where JAX quantizes eagerly
(``append_prompt``); under ``jit`` XLA rewrites ``absmax / 127`` into
``absmax * (1/127)``, so there a scale may sit one ulp from the port's
(rtol 1e-6, as ``tests/test_torch_serving.py`` allows).

The scheduler stages q in bf16, the only q H6-decode takes, on the CPU
too, and returns the kernel's bf16-rounded O, where the JAX scheduler
attends with f32 q and returns f32.  Port vs JAX per step: 2e-2 abs, the
int8-cache tier of the JAX suite's scheduler gate
(``bench/suite.py:538``): q's rounding (2^-9 relative) moves a score by
~5e-3 at d = 64, and O's rounding adds one bf16 ulp of |O| <= 1.  The JAX
tests' own oracle checks keep their tolerance (0.05)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.oracle.reference import (
    error_stats,
    naive_attention,
)
from exploring_flash_attention_tpu.serving import kv_cache as jkv
from exploring_flash_attention_tpu.serving import scheduler as jsched
from exploring_flash_attention_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    Request,
    append_prompt,
    append_prompts,
    append_tokens,
    gather_kv,
    make_cache,
    set_seq_lens,
)

STEP_TOL = 2e-2
ORACLE_TOL = 0.05          # tests/test_serving.py:171, the int8 cache
PS = 128


def _np_prompt(rng, l, hkv, d):
    return (rng.standard_normal((l, hkv, d)).astype(np.float32),
            rng.standard_normal((l, hkv, d)).astype(np.float32))


def _request_pair(rid, kp, vp, n_new, inputs):
    """The same request for both schedulers: ``inputs[i]`` is step i's
    (q, k, v) as NumPy."""
    jreq = jsched.Request(
        rid, jnp.asarray(kp), jnp.asarray(vp), n_new,
        lambda i: tuple(jnp.asarray(x) for x in inputs[i]))
    treq = Request(
        rid, torch.from_numpy(kp), torch.from_numpy(vp), n_new,
        lambda i: tuple(torch.from_numpy(x) for x in inputs[i]))
    return jreq, treq


def _step_inputs(seed, n, hq, hkv, d):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((hq, d)).astype(np.float32),
             r.standard_normal((hkv, d)).astype(np.float32),
             r.standard_normal((hkv, d)).astype(np.float32))
            for _ in range(n)]


def _schedulers(hq, hkv, d, **kw):
    return (jsched.ContinuousBatchingScheduler(hq, hkv, d, **kw),
            ContinuousBatchingScheduler(hq, hkv, d, device="cpu", **kw))


def _same_steps(j_out, t_out):
    assert [rid for rid, _ in t_out] == [rid for rid, _ in j_out]
    for (_, a), (_, b) in zip(t_out, j_out):
        assert a.shape == np.asarray(b).shape and a.dtype == np.float32
        assert error_stats(a, np.asarray(b))["max_abs"] < STEP_TOL


def test_scheduler_continuous_batching():
    """tests/test_serving.py:106 on both schedulers: 3 requests, 2 slots
    and 6 pages, the third admitted when a slot frees."""
    rng = np.random.default_rng(3)
    hq, hkv, d = 4, 2, 64
    js, ts = _schedulers(hq, hkv, d, n_pages=6, page_size=PS, max_seqs=2)
    for rid, (plen, n_new) in enumerate([(100, 3), (100, 5), (100, 2)]):
        kp, vp = _np_prompt(rng, plen, hkv, d)
        jr, tr = _request_pair(rid, kp, vp, n_new,
                               _step_inputs(100 + rid, n_new, hq, hkv, d))
        js.submit(jr)
        ts.submit(tr)
    out, j_out = ts.step(), js.step()
    assert ts.num_active == 2 and ts.num_pending == 1
    assert {rid for rid, _ in out} == {0, 1}
    _same_steps(j_out, out)
    while js.pending or js.active:
        _same_steps(js.step(), ts.step())
    assert not ts.pending and not ts.active
    assert ts.completed == js.completed == {0: 3, 1: 5, 2: 2}
    assert ts.num_active == 0 and ts.num_pending == 0
    assert ts.allocator.free_pages == js.allocator.free_pages == 6


def test_scheduler_output_matches_unbatched_oracle():
    """tests/test_serving.py:144: one request, one step, against attention
    over the prompt and the appended token (the int8 cache bounds the
    error), and against the JAX scheduler's step."""
    rng = np.random.default_rng(4)
    hq, hkv, d = 2, 2, 64
    js, ts = _schedulers(hq, hkv, d, n_pages=4, page_size=PS, max_seqs=1)
    kp, vp = _np_prompt(rng, 64, hkv, d)
    inputs = _step_inputs(5, 1, hq, hkv, d)
    jr, tr = _request_pair(7, kp, vp, 1, inputs)
    js.submit(jr)
    ts.submit(tr)
    (rid, out), = ts.step()
    assert rid == 7
    q_step, k_step, v_step = inputs[0]
    k_full = np.concatenate([kp, k_step[None]], 0)
    v_full = np.concatenate([vp, v_step[None]], 0)
    ref = naive_attention(q_step[:, None, :], k_full.transpose(1, 0, 2),
                          v_full.transpose(1, 0, 2))[:, 0]
    assert error_stats(out, ref)["max_abs"] < ORACLE_TOL
    _same_steps(js.step(), [(rid, out)])


def test_scheduler_churn_matches_jax():
    """A small churn run: 7 requests of mixed prompt and output lengths
    over 3 slots and 14 pages, 3 up front and 2 more every 3 steps; every
    step's outputs, the completion map, the pages returned and the cache's
    page table and lengths as the JAX scheduler's.  ``sync=False`` on the
    port: each step's output is a tensor of its own."""
    rng = np.random.default_rng(7)
    hq, hkv, d = 4, 2, 64
    js, ts = _schedulers(hq, hkv, d, n_pages=14, page_size=PS, max_seqs=3,
                         max_pages_per_seq=4)
    lens = [(50, 3), (130, 5), (260, 8), (100, 3), (128, 5), (300, 8),
            (10, 4)]
    pairs = []
    for rid, (plen, n_new) in enumerate(lens):
        kp, vp = _np_prompt(rng, plen, hkv, d)
        pairs.append(_request_pair(rid, kp, vp, n_new, _step_inputs(
            200 + rid, n_new, hq, hkv, d)))
    arrival, steps, outs = 3, 0, []
    for jr, tr in pairs[:arrival]:
        js.submit(jr)
        ts.submit(tr)
    while js.pending or js.active or arrival < len(pairs):
        if steps % 3 == 0 and arrival < len(pairs):
            for jr, tr in pairs[arrival:arrival + 2]:
                js.submit(jr)
                ts.submit(tr)
            arrival = min(arrival + 2, len(pairs))
        rids, out = ts.step(sync=False)
        j_out = js.step()
        assert out.shape == (3, hq, d) and out.dtype == torch.float32
        outs.append((rids, out, j_out))
        steps += 1
        assert steps < 100
    for rids, out, j_out in outs:       # later steps left each one alone
        _same_steps(j_out, [(r, out[i].numpy()) for i, r in enumerate(rids)])
        assert (out[len(rids):] == 0).all()     # the pad rows
    assert ts.completed == js.completed == {r: n for r, (_, n)
                                            in enumerate(lens)}
    assert ts.allocator.free_pages == js.allocator.free_pages == 14
    np.testing.assert_array_equal(ts.cache.page_table.numpy(),
                                  np.asarray(js.cache.page_table))
    np.testing.assert_array_equal(ts.cache.seq_lens.numpy(),
                                  np.asarray(js.cache.seq_lens))


def test_scheduler_refuses_requests_that_never_fit():
    ts = ContinuousBatchingScheduler(2, 2, 64, n_pages=4, page_size=PS,
                                     max_seqs=1, max_pages_per_seq=2,
                                     device="cpu")
    kv = torch.zeros(300, 2, 64)
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        ts.submit(Request(0, kv, kv, 1, None))
    with pytest.raises(ValueError, match="could never be admitted"):
        ts.submit(Request(1, torch.zeros(600, 2, 64), kv, 1, None))
    assert ts.step() == [] and ts.step(sync=False) == ([], None)


def _caches(hkv, d, n_pages, max_seqs, max_pages):
    jc = jkv.make_cache(hkv, d, n_pages, page_size=PS, max_seqs=max_seqs,
                        max_pages_per_seq=max_pages)
    tc = make_cache(hkv, d, n_pages, page_size=PS, max_seqs=max_seqs,
                    max_pages_per_seq=max_pages, device="cpu")
    return jc, tc


def _with_table(jc, tc, table):
    tc.page_table.copy_(torch.from_numpy(table))
    return jkv.PagedKVCache(jc.kv_pages, jc.kv_scales, jnp.asarray(table),
                            jc.seq_lens, jc.page_size, jc.head_pack)


def _assert_caches(jc, tc, scales_bitwise):
    assert jc.head_pack == 1                       # d = 128: one layout
    np.testing.assert_array_equal(tc.kv_pages.numpy(),
                                  np.asarray(jc.kv_pages))
    np.testing.assert_array_equal(tc.page_table.numpy(),
                                  np.asarray(jc.page_table))
    np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))
    if scales_bitwise:
        np.testing.assert_array_equal(tc.kv_scales.numpy(),
                                      np.asarray(jc.kv_scales))
    else:
        np.testing.assert_allclose(tc.kv_scales.numpy(),
                                   np.asarray(jc.kv_scales), rtol=1e-6)
    for s in range(tc.seq_lens.shape[0]):
        if int(tc.seq_lens[s]):
            for a, b in zip(gather_kv(tc, s), jkv.gather_kv(jc, s)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6)


@pytest.mark.parametrize("start,l", [(None, 300), (128, 200), (256, 1)])
def test_append_prompt_matches_jax(start, l):
    """The host loop over pages, from the slot's length or an explicit
    page-aligned ``start``, through the page table or given page ids."""
    rng = np.random.default_rng(31)
    hkv, d = 2, 128
    jc, tc = _caches(hkv, d, 10, 3, 4)
    table = np.array([[7, 2, 9, 0], [1, 3, 5, 8], [4, 6, 0, 0]], np.int32)
    jc = _with_table(jc, tc, table)
    kp, vp = _np_prompt(rng, l, hkv, d)
    jc = jkv.append_prompt(jc, 1, jnp.asarray(kp), jnp.asarray(vp),
                           start=start)
    append_prompt(tc, 1, torch.from_numpy(kp), torch.from_numpy(vp),
                  start=start)
    k2, v2 = _np_prompt(rng, 90, hkv, d)
    jc = jkv.append_prompt(jc, 2, jnp.asarray(k2), jnp.asarray(v2),
                           page_ids=[6, 4])
    append_prompt(tc, 2, torch.from_numpy(k2), torch.from_numpy(v2),
                  page_ids=[6, 4])
    _assert_caches(jc, tc, scales_bitwise=True)
    with pytest.raises(ValueError, match="page boundary"):
        append_prompt(tc, 0, torch.from_numpy(kp), torch.from_numpy(vp),
                      start=5)


def test_append_prompts_with_page_ids_matches_jax():
    """The batched prefill onto given pages (here not the page table's),
    with a slot out of range that gets no length, as JAX drops it."""
    rng = np.random.default_rng(32)
    hkv, d, l = 2, 128, 200
    jc, tc = _caches(hkv, d, 10, 3, 4)
    kp = rng.standard_normal((2, l, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((2, l, hkv, d)).astype(np.float32)
    ids = np.array([0, 2], np.int32)
    pages = np.array([[5, 1], [8, 3]], np.int32)
    jc = jkv.append_prompts(jc, jnp.asarray(ids), jnp.asarray(kp),
                            jnp.asarray(vp), jnp.asarray(pages))
    append_prompts(tc, torch.from_numpy(ids), torch.from_numpy(kp),
                   torch.from_numpy(vp), torch.from_numpy(pages))
    _assert_caches(jc, tc, scales_bitwise=False)
    assert tc.seq_lens.tolist() == [l, 0, l]
    # slot 7 is out of range: its pages are written, no length is set
    jc = jkv.append_prompts(jc, jnp.asarray([7], jnp.int32),
                            jnp.asarray(kp[:1]), jnp.asarray(vp[:1]),
                            jnp.asarray([[9, 0]], jnp.int32))
    append_prompts(tc, torch.tensor([7], dtype=torch.int32),
                   torch.from_numpy(kp[:1]), torch.from_numpy(vp[:1]),
                   torch.tensor([[9, 0]], dtype=torch.int32))
    _assert_caches(jc, tc, scales_bitwise=False)


def test_set_seq_lens_matches_jax_and_drops_out_of_range():
    hkv, d = 2, 128
    jc, tc = _caches(hkv, d, 4, 4, 2)
    for ids, lens in (([0, 2, 3], [5, 7, 9]), ([6, 1], [3, 4]),
                      ([9, 3], [1, 2]), ([8], [6])):
        jc = jkv.set_seq_lens(jc, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(lens, jnp.int32))
        set_seq_lens(tc, torch.tensor(ids, dtype=torch.int32),
                     torch.tensor(lens, dtype=torch.int32))
        np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                      np.asarray(jc.seq_lens))
    assert tc.seq_lens.tolist() == [5, 4, 7, 2]


@pytest.mark.parametrize("ids", [
    [5, 2],          # the dropped row's clamped target is row 1's
    [2, 9, 0],       # a dropped row between two valid ones
    [4, 3],          # every row dropped (3 slots: 3 and 4 out of range)
])
def test_append_tokens_drops_out_of_range_rows(ids):
    """``append_tokens`` drops the rows whose slot is out of range: no page
    write and no length bump, bitwise as JAX's ``mode="drop"``, also
    where a dropped row, clamped, aims at the very slot a valid row
    writes."""
    rng = np.random.default_rng(33)
    hkv, d = 2, 128
    jc, tc = _caches(hkv, d, 6, 3, 2)
    table = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    jc = _with_table(jc, tc, table)
    for s, l in enumerate((10, 127, 40)):
        kp, vp = _np_prompt(rng, l, hkv, d)
        jc = jkv.append_prompt(jc, s, jnp.asarray(kp), jnp.asarray(vp))
        append_prompt(tc, s, torch.from_numpy(kp), torch.from_numpy(vp))
    before = (tc.kv_pages.clone(), tc.kv_scales.clone(), tc.seq_lens.clone())
    for _ in range(2):                  # the second crosses slot 1's page
        k = rng.standard_normal((len(ids), hkv, d)).astype(np.float32)
        v = rng.standard_normal((len(ids), hkv, d)).astype(np.float32)
        jc = jkv.append_tokens(jc, jnp.asarray(ids, jnp.int32),
                               jnp.asarray(k), jnp.asarray(v))
        append_tokens(tc, torch.tensor(ids, dtype=torch.int32),
                      torch.from_numpy(k), torch.from_numpy(v))
    _assert_caches(jc, tc, scales_bitwise=False)
    valid = [i for i in ids if i < 3]
    want = before[2].clone()
    want[valid] += 2
    assert torch.equal(tc.seq_lens, want)
    if not valid:
        assert torch.equal(tc.kv_pages, before[0])
        assert torch.equal(tc.kv_scales, before[1])
