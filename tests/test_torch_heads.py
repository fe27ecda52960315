"""The serving path at the head geometries the JAX model takes, vs the JAX
package: head dims 16, 80 and 256, a GQA group of 16 (one KV head), pages
of 256 and 512 tokens.

The same NumPy inputs go through the JAX function (Pallas in interpret
mode on the CPU, as the JAX package's tests run it) and through the port's
CPU path (the plain versions of H1, H2, H6-decode and H6-extend), in f32.
Tolerances are those of the JAX test of each function, stated in each
test; both sides compute in f32 and differ in summation order only.  The
paged caches hold the same codes and scales on both sides
(``_jax_cache_of``, as ``tests/test_torch_serving.py`` hands them over).

Also here: the rule the four kernels take (``kernel_head_dim``), and
``make_cache``'s page sizes, which are JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import SplitKVConfig as JSplitKV
from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import generate as jgen
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.ops.attention_v1 import (
    flash_attention_v1 as jax_flash_attention_v1,
)
from exploring_flash_attention_tpu.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial as jax_splitkv_partial,
    flash_attention_v2 as jax_flash_attention_v2,
)
from exploring_flash_attention_tpu.serving import kv_cache as jkv
from exploring_flash_attention_tpu.serving.decode import (
    paged_decode_attention as jax_paged_decode,
    paged_extend_attention as jax_paged_extend,
)
from exploring_flash_attention_tpu_torch.configs import SplitKVConfig
from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    ModelConfig,
    forward,
    params_from_jax,
)
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.ops import flash_attention_v1
from exploring_flash_attention_tpu_torch.ops.attention import (
    kernel_head_dim,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial,
    flash_attention_v2,
    splitkv_combine_plain,
)
from exploring_flash_attention_tpu_torch.serving import (
    append_chunks,
    append_prompts,
    decode_chunks,
    decode_split,
    gather_kv,
    make_cache,
    paged_decode_attention,
    paged_decode_partials_plain,
    paged_decode_plain,
    paged_extend_attention,
)

HEAD_DIMS = (16, 80, 256)
GROUP = 16                      # q heads over one KV head
PAGES = (256, 512)


def test_head_dim_rule_of_the_serving_kernels():
    """H1, H2, H6-decode and H6-extend take every d from 1 to 512 (those
    off the multiples of 16 too: ``tests/test_torch_heads_odd.py``; past
    256 ``tests/test_torch_heads_wide.py``) and nothing else."""
    assert all(kernel_head_dim(d) for d in range(1, 513))
    assert not any(kernel_head_dim(d) for d in (0, 513, 528))


@pytest.mark.parametrize("mode", ["none", "causal", "window"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_v1_head_dims_match_jax(d, mode):
    """``flash_attention_v1`` at d 16, 80 and 256, GQA 16/1, ragged and
    cross (Lq 100, Lkv 130): the port's plain path against JAX's kernels
    in interpret mode at ``tests/test_attention_v1.py``'s tolerance (2e-5
    abs, 1e-4 rel), each side first against the f64 oracle."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, GROUP, 100, d)).astype(np.float32)
    k = rng.standard_normal((1, 1, 130, d)).astype(np.float32)
    v = rng.standard_normal((1, 1, 130, d)).astype(np.float32)
    causal, window = mode != "none", 40 if mode == "window" else None
    ref = jax.device_get(jax_flash_attention_v1(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, window=window))
    got = flash_attention_v1(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, window=window).numpy()
    oracle = naive_attention(q, np.repeat(k, GROUP, 1), np.repeat(v, GROUP, 1),
                             causal=causal, window=window)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ref, oracle, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_splitkv_pair_at_d80_matches_jax(causal):
    """``flash_attention_splitkv_partial`` (3 spans of 128 keys, the last
    ragged) and ``flash_attention_v2`` at d=80 against JAX's, at
    ``tests/test_attention_v2.py``'s tolerance (1e-5 abs and rel; a span
    that sees nothing is (0, -inf) on both sides)."""
    rng = np.random.default_rng(80 + causal)
    q = rng.standard_normal((2, 4, 64, 80)).astype(np.float32)
    k = rng.standard_normal((2, 4, 300, 80)).astype(np.float32)
    v = rng.standard_normal((2, 4, 300, 80)).astype(np.float32)
    fields = dict(block_q=64, block_kv=64, kv_tiles_per_block=2)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    targs = [torch.from_numpy(x) for x in (q, k, v)]
    jo, jlse = jax.device_get(jax_splitkv_partial(
        *jargs, JSplitKV(**fields), causal=causal))
    to, tlse = flash_attention_splitkv_partial(
        *targs, SplitKVConfig(**fields), causal=causal)
    assert to.shape == jo.shape == (2, 4, 3, 64, 80)
    np.testing.assert_array_equal(np.isneginf(tlse.numpy()), np.isneginf(jlse))
    fin = np.isfinite(jlse)
    np.testing.assert_allclose(tlse.numpy()[fin], jlse[fin], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(to.numpy(), jo, atol=1e-5, rtol=1e-5)
    ref = jax.device_get(jax_flash_attention_v2(*jargs, JSplitKV(**fields),
                                                causal=causal))
    got = flash_attention_v2(*targs, SplitKVConfig(**fields), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        splitkv_combine_plain(to, tlse).numpy(), ref, atol=1e-5, rtol=1e-5)


def _fill_both(seed, d, ps, hist, c=0, hkv=1):
    """Ragged histories (and, with ``c``, one C-token chunk) in a port
    cache of pages ``ps`` in a permuted table, and the JAX cache holding
    its codes and scales.  Returns (JAX cache, port cache, slots)."""
    rng = np.random.default_rng(seed)
    b = len(hist)
    max_pages = -(-(max(hist) + c) // ps) + 1
    table = rng.permutation(b * max_pages).astype(np.int32).reshape(
        b, max_pages)
    tc = make_cache(hkv, d, b * max_pages, page_size=ps, max_seqs=b,
                    max_pages_per_seq=max_pages, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    slots = torch.arange(b, dtype=torch.int32)
    for s, n in enumerate(hist):
        kv = rng.standard_normal((2, 1, n, hkv, d)).astype(np.float32)
        append_prompts(tc, slots[s:s + 1], *torch.from_numpy(kv))
    if c:
        kv = rng.standard_normal((2, b, c, hkv, d)).astype(np.float32)
        append_chunks(tc, slots, *torch.from_numpy(kv))
    pk = jkv.head_pack_for(hkv, d)
    assert pk == 1                      # none of these geometries packs
    jc = jkv.PagedKVCache(
        jnp.asarray(tc.kv_pages.numpy()), jnp.asarray(tc.kv_scales.numpy()),
        jnp.asarray(table), jnp.asarray(tc.seq_lens.numpy()), ps, pk)
    return jc, tc, slots


@pytest.mark.parametrize("ps", PAGES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_decode_head_dims_groups_pages_match_jax(d, ps):
    """``paged_decode_attention`` at d 16, 80 and 256, a group of 16 and
    pages of 256 and 512, without and with a window of 100, against JAX's
    B20 in interpret mode on the same codes (1e-5 abs, f32, as
    ``tests/test_torch_serving.py``), the port against the f64 oracle over
    each band too; and H6-decode's split as the card runs it (its chunks
    of the group, page runs, their merge) emulated by the plain versions
    (1e-6 abs)."""
    hist = (300, 700)
    jc, tc, slots = _fill_both(d + ps, d, ps, hist)
    q = np.random.default_rng(d).standard_normal(
        (len(hist), GROUP, d)).astype(np.float32)
    for window in (None, 100):
        ref = jax.device_get(jax_paged_decode(
            jnp.asarray(q), jc, jnp.asarray(slots.numpy()), window=window))
        got = paged_decode_attention(torch.from_numpy(q), tc, slots,
                                     window=window).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
        for s, n in enumerate(hist):
            lo = max(0, n - window) if window else 0
            k, v = gather_kv(tc, s)                    # [1, n, d] f32
            oracle = naive_attention(q[s][None], k[:, lo:].numpy(),
                                     v[:, lo:].numpy())
            np.testing.assert_allclose(got[s], oracle[0], atol=1e-5)
        chunks = decode_chunks(GROUP, d)
        assert chunks == (4 if d > 128 else 2)
        n_split, per = decode_split(tc, len(hist), window, 132, chunks)
        assert n_split == 1 or len(hist) * chunks * n_split <= 2 * 132
        o, lse = paged_decode_partials_plain(
            torch.from_numpy(q), tc, slots, d ** -0.5, window, n_split, per)
        merged = splitkv_combine_plain(o, lse)[:, :, 0]
        np.testing.assert_allclose(merged.numpy(), paged_decode_plain(
            torch.from_numpy(q), tc, slots, d ** -0.5, window).numpy(),
            atol=1e-6)


@pytest.mark.parametrize("ps", PAGES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_extend_head_dims_groups_pages_match_jax(d, ps):
    """``paged_extend_attention`` (a 9-token chunk over ragged histories)
    at d 16, 80 and 256, a group of 16 and pages of 256 and 512, without
    and with a window of 100, against JAX's B21/B22 in interpret mode on
    the same codes (1e-5 abs, f32, as ``tests/test_torch_extend.py``)."""
    hist, c = (250, 600), 9
    jc, tc, slots = _fill_both(d + ps + 1, d, ps, hist, c)
    q = np.random.default_rng(d + 1).standard_normal(
        (len(hist), c, GROUP, d)).astype(np.float32)
    for window in (None, 100):
        ref = jax.device_get(jax_paged_extend(
            jnp.asarray(q), jc, jnp.asarray(slots.numpy()), window=window))
        got = paged_extend_attention(torch.from_numpy(q), tc, slots,
                                     window=window).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)


# the slice: a 2-layer LM at d_head 80 in a group of 16 over 256-token
# pages; its heads are wider than the model (16 * 80 = 1280 > d_model 128)
HEADS_KW = dict(vocab_size=128, n_layers=2, n_heads=16, n_kv_heads=1,
                d_model=128, d_head=80, d_ff=256)


def test_engine_at_d80_group16_gives_jax_tokens():
    """The slice as a whole: JAX's weights carried over by
    ``params_from_jax`` (every leaf's shape and value, the projections
    [E, H, d] and [H, d, E] with H d != E), the forward's logits (1e-4 abs,
    as ``tests/test_torch_model.py``), and ``GenerationEngine.generate``
    with 256-token pages giving JAX's greedy tokens."""
    jcfg = jtf.ModelConfig(**HEADS_KW,
                           tile=JTileConfig(block_q=64, block_kv=64))
    cfg = ModelConfig(**HEADS_KW)
    jparams = jtf.init_params(jcfg, seed=3)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    assert params["layers"][0]["wq"].shape == (128, 16, 80)
    assert params["layers"][0]["wk"].shape == (128, 1, 80)
    assert params["layers"][0]["wo"].shape == (16, 80, 128)
    for jl, tl in zip(jax.tree.leaves(jparams), jax.tree.leaves(params),
                      strict=True):
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    prompt = np.random.default_rng(3).integers(
        0, HEADS_KW["vocab_size"], (2, 40)).astype(np.int32)
    np.testing.assert_allclose(
        forward(params, torch.from_numpy(prompt), cfg).numpy(),
        np.asarray(jtf.forward(jparams, jnp.asarray(prompt), jcfg)),
        atol=1e-4)
    jeng = jgen.GenerationEngine(jparams, jcfg, max_seqs=2, max_len=512,
                                 page_size=256)
    ref = jeng.generate(jnp.asarray(prompt), max_new_tokens=5)
    eng = GenerationEngine(params, cfg, max_seqs=2, max_len=512,
                           page_size=256)
    got = eng.generate(prompt, max_new_tokens=5)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("page_size", [16, 64, 129, 200, 128, 384, 2 ** 15])
def test_make_cache_takes_the_page_sizes_jax_takes(page_size):
    """``make_cache`` refuses a page size that is not a multiple of 128 as
    JAX's ``make_cache`` does (``ValueError``, the same words), and one of
    2^15 or more, which JAX's cache takes and its decode refuses; both
    take the rest."""
    kw = dict(num_kv_heads=1, head_dim=16, n_pages=1, page_size=page_size,
              max_seqs=1)
    if page_size % 128:
        with pytest.raises(ValueError, match="multiple of 128") as jerr:
            jkv.make_cache(**kw)
        with pytest.raises(ValueError, match="multiple of 128") as terr:
            make_cache(**kw, device="cpu")
        assert str(jerr.value) in str(terr.value)
    elif page_size >= 2 ** 15:
        jc = jkv.make_cache(**kw)
        q = jnp.zeros((1, 1, 16), jnp.float32)
        with pytest.raises(ValueError, match="15-bit") as jerr:
            jax_paged_decode(q, jc, jnp.zeros((1,), jnp.int32))
        with pytest.raises(ValueError, match="15-bit") as terr:
            make_cache(**kw, device="cpu")
        assert str(jerr.value) in str(terr.value)
    else:
        jc = jkv.make_cache(**kw)
        tc = make_cache(**kw, device="cpu")
        assert tc.kv_pages.shape == jc.kv_pages.shape
