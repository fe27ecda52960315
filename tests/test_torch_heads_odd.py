"""The serving path at head dims that are not a multiple of 16, vs the JAX
package: d 1 to 250 through ``flash_attention_v1``, the split-KV pair at
d=72, the paged pair at five (d, group, page size) geometries, and a
heads72-style LM (d_head 72, SigLIP-so400m's and DiT-XL/2's heads)
generating JAX's greedy tokens.

The same NumPy inputs go through the JAX function (Pallas in interpret
mode on the CPU, as the JAX package's tests run it) and through the port's
CPU path (the plain versions of H1, H2, H6-decode and H6-extend), in f32,
at the tolerance of the JAX test of each function, stated in each test.
On the card these d run on the same kernels as the multiples of 16: H1
loads rows that are no multiple of 16 bytes itself instead of by TMA, H2
reads d at run time, the paged pair reads the codes at their rows'
alignment (``tests/test_torch_kernels.py`` holds them against these plain
versions there).

Also here: the head-dim rules, the serving kernels' at both dtypes (``d
from 1 to 512``), the one H3 and H4 share (``d from 1 to 256``), and H5's
(``d from 1 to 2048``).
"""

import re

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
from exploring_flash_attention_tpu_torch.ops import attention_bwd
from exploring_flash_attention_tpu_torch.ops import flash_attention_v1
from exploring_flash_attention_tpu_torch.ops import attention as ops_attention
from exploring_flash_attention_tpu_torch.ops.attention import (
    H5_HEAD_DIM_RULE,
    NARROW_HEAD_DIM_RULE,
    SERVING_HEAD_DIM_RULE,
    h4_instance,
    kernel_head_dim,
    narrow_head_dim,
)
from exploring_flash_attention_tpu_torch.ops.attention_kvquant import (
    kvquant_kernel,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial,
    flash_attention_v2,
    splitkv_combine_plain,
)
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.serving import (
    decode_chunks,
    decode_split,
    gather_kv,
    paged_decode_attention,
    paged_decode_partials_plain,
    paged_decode_plain,
    paged_extend_attention,
)
from f32_pieces import one_torch_thread  # noqa: F401 (autouse)
from test_torch_heads import _fill_both

# d off the multiples of 16: 1 (scale 1, one column), rows of 2-byte
# alignment in bf16 (33), 8-byte (36, 100), 16-byte (40, 72), 4-byte (250)
ODD_DIMS = (1, 33, 36, 40, 72, 100, 250)
# the paged pair's geometries (d, Hq, Hkv, page size): code rows of 8-byte
# alignment (72: heads72's own geometry; 40), 4-byte (36), 1-byte (33) and
# 2-byte (250); groups 1 to 16, pages 128 to 1024
PAGED_ODD = [(72, 16, 16, 128), (40, 8, 1, 256), (36, 32, 2, 512),
             (33, 16, 1, 1024), (250, 8, 4, 128)]


def test_h3_h4_rule_stays_the_multiples_of_16():
    """H4's rule of the multiples of 16 is retired (no ``HEAD_DIM_RULE``,
    no ``sixteen_head_dim``): H4-kvq and H4-int8 take the rule of H3-dkv
    and H3-dq (``narrow_head_dim``, which names itself
    ``NARROW_HEAD_DIM_RULE``), every d from 1 to 256; the serving kernels
    every d from 1 to 512 (``kernel_head_dim``, ``SERVING_HEAD_DIM_RULE``)
    and H5 every d from 1 to 2048."""
    assert NARROW_HEAD_DIM_RULE == "d from 1 to 256"
    assert SERVING_HEAD_DIM_RULE == "d from 1 to 512"
    assert H5_HEAD_DIM_RULE == "d from 1 to 2048"
    assert not hasattr(ops_attention, "HEAD_DIM_RULE")
    assert not hasattr(ops_attention, "sixteen_head_dim")
    assert [d for d in range(300) if narrow_head_dim(d)] == list(
        range(1, 257))
    assert [d for d in range(600) if kernel_head_dim(d)] == list(
        range(1, 513))
    assert [h4_instance(d) for d in (1, 64, 65, 128, 129, 256)] == [
        64, 64, 128, 128, 256, 256]


@pytest.mark.parametrize("d", [72, 8, 40, 250])
def test_h3_and_h4_still_refuse_d_off_sixteen(d, monkeypatch):
    """At a d off the multiples of 16, H4-kvq and H4-int8 (their instance,
    ``h4_instance``; ``kvquant_kernel``) now take it, on the smallest
    instance at or above it, as H3-dkv's and H3-dq's shared check (the
    device check passed on CPU tensors) does; all of them still refuse d 0
    and 257 (the quantized-KV op sends 257 to H5 and refuses only past
    2048) naming ``NARROW_HEAD_DIM_RULE``, which the serving kernels'
    wider rule leaves as it was."""
    rule = re.escape(NARROW_HEAD_DIM_RULE)
    assert h4_instance(d) == next(x for x in (64, 128, 256) if x >= d)
    assert kvquant_kernel(d) == "H4-kvq"
    assert kvquant_kernel(257) == "H5"
    for bad in (0, 257):
        with pytest.raises(ValueError, match=rule):
            h4_instance(bad)
    for bad in (0, 2049):
        with pytest.raises(ValueError, match=rule):
            kvquant_kernel(bad)
    monkeypatch.setattr(attention_bwd, "_check_cuda_inputs",
                        lambda *a: torch.float32)
    lse = torch.zeros(1, 2, 8)
    for name in ("H3-dkv", "H3-dq"):
        q = torch.zeros(1, 2, 8, d)
        attention_bwd._check_bwd_inputs(name, q, q, q, q, lse, lse)
        for bad in (0, 257):
            q = torch.zeros(1, 2, 8, bad)
            with pytest.raises(ValueError, match=rule):
                attention_bwd._check_bwd_inputs(name, q, q, q, q, lse, lse)


@pytest.mark.parametrize("mode", ["none", "causal", "window"])
@pytest.mark.parametrize("d", ODD_DIMS)
def test_flash_attention_v1_odd_head_dims_match_jax(d, mode):
    """``flash_attention_v1`` at d 1 to 250 off the multiples of 16, GQA
    8/2, ragged and cross (Lq 100, Lkv 130): the port's plain path against
    JAX's kernels in interpret mode at ``tests/test_attention_v1.py``'s
    tolerance (2e-5 abs, 1e-4 rel), each side first against the f64
    oracle."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 8, 100, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, 130, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, 130, d)).astype(np.float32)
    causal, window = mode != "none", 40 if mode == "window" else None
    ref = jax.device_get(jax_flash_attention_v1(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, window=window))
    got = flash_attention_v1(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, window=window).numpy()
    oracle = naive_attention(q, np.repeat(k, 4, 1), np.repeat(v, 4, 1),
                             causal=causal, window=window)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ref, oracle, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_splitkv_pair_at_d72_matches_jax(causal):
    """``flash_attention_splitkv_partial`` (3 spans of 128 keys, the last
    ragged) and ``flash_attention_v2`` at d=72 against JAX's, at
    ``tests/test_attention_v2.py``'s tolerance (1e-5 abs and rel; a span
    that sees nothing is (0, -inf) on both sides); H2's plain merge of
    the port's partials gives JAX's V2."""
    rng = np.random.default_rng(72 + causal)
    q = rng.standard_normal((2, 4, 64, 72)).astype(np.float32)
    k = rng.standard_normal((2, 4, 300, 72)).astype(np.float32)
    v = rng.standard_normal((2, 4, 300, 72)).astype(np.float32)
    fields = dict(block_q=64, block_kv=64, kv_tiles_per_block=2)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    targs = [torch.from_numpy(x) for x in (q, k, v)]
    jo, jlse = jax.device_get(jax_splitkv_partial(
        *jargs, JSplitKV(**fields), causal=causal))
    to, tlse = flash_attention_splitkv_partial(
        *targs, SplitKVConfig(**fields), causal=causal)
    assert to.shape == jo.shape == (2, 4, 3, 64, 72)
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


@pytest.mark.parametrize("d,hq,hkv,ps", PAGED_ODD)
def test_paged_decode_odd_head_dims_match_jax(d, hq, hkv, ps):
    """``paged_decode_attention`` at the PAGED_ODD geometries, without and
    with a window of 100, against JAX's B20 in interpret mode on the same
    codes (1e-5 abs, f32, as ``tests/test_torch_serving.py``), the port
    against the f64 oracle over each band too; and H6-decode's split as
    the card runs it (its chunks of the group, page runs, their merge)
    emulated by the plain versions (1e-6 abs)."""
    hist = (300, 1100)
    jc, tc, slots = _fill_both(d + ps, d, ps, hist, hkv=hkv)
    g = hq // hkv
    q = np.random.default_rng(d).standard_normal(
        (len(hist), hq, d)).astype(np.float32)
    for window in (None, 100):
        ref = jax.device_get(jax_paged_decode(
            jnp.asarray(q), jc, jnp.asarray(slots.numpy()), window=window))
        got = paged_decode_attention(torch.from_numpy(q), tc, slots,
                                     window=window).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
        for s, n in enumerate(hist):
            lo = max(0, n - window) if window else 0
            k, v = gather_kv(tc, s)                 # [Hkv, n, d] f32
            oracle = naive_attention(q[s].reshape(hkv, g, d),
                                     k[:, lo:].numpy(), v[:, lo:].numpy())
            np.testing.assert_allclose(got[s], oracle.reshape(hq, d),
                                       atol=1e-5)
        chunks = decode_chunks(g, d)
        n_split, per = decode_split(tc, len(hist), window, 132, chunks)
        assert n_split == 1 or len(hist) * hkv * chunks * n_split <= 2 * 132
        o, lse = paged_decode_partials_plain(
            torch.from_numpy(q), tc, slots, d ** -0.5, window, n_split, per)
        merged = splitkv_combine_plain(o, lse)[:, :, 0]
        np.testing.assert_allclose(merged.numpy(), paged_decode_plain(
            torch.from_numpy(q), tc, slots, d ** -0.5, window).numpy(),
            atol=1e-6)


@pytest.mark.parametrize("d,hq,hkv,ps", PAGED_ODD)
def test_paged_extend_odd_head_dims_match_jax(d, hq, hkv, ps):
    """``paged_extend_attention`` (a 9-token chunk over ragged histories)
    at the PAGED_ODD geometries, without and with a window of 100,
    against JAX's B21/B22 in interpret mode on the same codes (1e-5 abs,
    f32, as ``tests/test_torch_extend.py``)."""
    hist, c = (250, 600), 9
    jc, tc, slots = _fill_both(d + ps + 1, d, ps, hist, c, hkv=hkv)
    q = np.random.default_rng(d + 1).standard_normal(
        (len(hist), c, hq, d)).astype(np.float32)
    for window in (None, 100):
        ref = jax.device_get(jax_paged_extend(
            jnp.asarray(q), jc, jnp.asarray(slots.numpy()), window=window))
        got = paged_extend_attention(torch.from_numpy(q), tc, slots,
                                     window=window).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)


# heads72's geometry at a narrow width: 4 q heads over 4 KV heads of 72
# (heads72 serves 16 over 16 at d_model 1024), 128-token pages
HEADS72_KW = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=4,
                  d_model=128, d_head=72, d_ff=256)


def test_engine_at_d72_gives_jax_tokens():
    """The slice as a whole at d_head 72: JAX's weights carried over by
    ``params_from_jax`` (every leaf's shape and value), the forward's
    logits (1e-4 abs, as ``tests/test_torch_model.py``), and
    ``GenerationEngine.generate`` with 128-token pages giving JAX's greedy
    tokens."""
    jcfg = jtf.ModelConfig(**HEADS72_KW,
                           tile=JTileConfig(block_q=64, block_kv=64))
    cfg = ModelConfig(**HEADS72_KW)
    jparams = jtf.init_params(jcfg, seed=5)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    assert params["layers"][0]["wq"].shape == (128, 4, 72)
    assert params["layers"][0]["wo"].shape == (4, 72, 128)
    for jl, tl in zip(jax.tree.leaves(jparams), jax.tree.leaves(params),
                      strict=True):
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    prompt = np.random.default_rng(5).integers(
        0, HEADS72_KW["vocab_size"], (2, 40)).astype(np.int32)
    np.testing.assert_allclose(
        forward(params, torch.from_numpy(prompt), cfg).numpy(),
        np.asarray(jtf.forward(jparams, jnp.asarray(prompt), jcfg)),
        atol=1e-4)
    jeng = jgen.GenerationEngine(jparams, jcfg, max_seqs=2, max_len=256,
                                 page_size=128)
    ref = jeng.generate(jnp.asarray(prompt), max_new_tokens=5)
    eng = GenerationEngine(params, cfg, max_seqs=2, max_len=256,
                           page_size=128)
    got = eng.generate(prompt, max_new_tokens=5)
    np.testing.assert_array_equal(got, np.asarray(ref))
