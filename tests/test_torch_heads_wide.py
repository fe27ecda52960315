"""The serving path at head dims past 256, vs the JAX package: d 257 to 512
through ``flash_attention_v1`` and ``flash_attention_v2``, the paged pair
over ragged batches, and a 2-layer LM at d_head 512 generating JAX's
greedy tokens.

The same NumPy inputs go through the JAX function (Pallas in interpret
mode on the CPU, as the JAX package's tests run it) and through the port's
CPU path (the plain versions of H1, H2, H6-decode and H6-extend), in f32,
at the tolerance of the JAX test of each function, stated in each test.
On the card these d run on H5's blocks of d-chunks (H1 and H6-extend:
``csrc/wide_attention.cuh`` at bf16, H5's f32 block in clusters of two at
f32), H2's instances up to 512 and H6-decode's D=512 instances
(``tests/test_torch_kernels.py`` holds them against these plain versions
there).  JAX takes any head dim; the port's serving kernels take
``SERVING_HEAD_DIM_RULE`` (d from 1 to 512) at both dtypes, the backward
and quantized kernels ``NARROW_HEAD_DIM_RULE`` (1 to 256).
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
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.ops import attention as ops_attention
from exploring_flash_attention_tpu_torch.ops import flash_attention_v1
from exploring_flash_attention_tpu_torch.ops.attention import (
    NARROW_HEAD_DIM_RULE,
    SERVING_HEAD_DIM_RULE,
    kernel_head_dim,
    narrow_head_dim,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    flash_attention_v2,
)
from exploring_flash_attention_tpu_torch.serving import (
    decode as serving_decode,
)
from exploring_flash_attention_tpu_torch.serving import (
    decode_chunks,
    gather_kv,
    paged_decode_attention,
    paged_extend_attention,
)
from f32_pieces import one_torch_thread  # noqa: F401 (autouse)
from test_torch_heads import _fill_both

# past 256: a row of 514 bytes in bf16 (257, odd: 2-byte alignment), 528
# (264: 16-byte rows, codes of 8-byte alignment), 600 (300: 8-byte rows,
# 4-byte codes) and 1024 (512, the widest instance)
WIDE_DIMS = (257, 264, 300, 512)
PAGED_WIDE = (264, 512)
GROUP = 2                       # q heads over one KV head, as heads512


def test_serving_and_narrow_rules():
    """The serving kernels take every d from 1 to 512 at bf16 and at f32
    (no check of their own at f32: ``check_f32_head_dim`` is gone); H3
    and H4 every d from 1 to 256, each rule under its own name; H6-decode
    cuts a group into chunks of 2 q heads past 256."""
    assert not hasattr(ops_attention, "check_f32_head_dim")
    assert not hasattr(serving_decode, "check_f32_head_dim")
    assert SERVING_HEAD_DIM_RULE == "d from 1 to 512"
    assert NARROW_HEAD_DIM_RULE == "d from 1 to 256"
    assert [d for d in range(1, 600) if kernel_head_dim(d)] == list(
        range(1, 513))
    assert [d for d in range(1, 600) if narrow_head_dim(d)] == list(
        range(1, 257))
    assert [decode_chunks(16, d) for d in (128, 256, 257, 512)] == [
        2, 4, 8, 8]


@pytest.mark.parametrize("mode", ["none", "causal", "window"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_flash_attention_v1_wide_head_dims_match_jax(d, mode):
    """``flash_attention_v1`` at d 257, 264, 300 and 512, GQA 4/2, ragged
    and cross (Lq 48, Lkv 80), under each mask: the port's plain path
    against JAX's kernels in interpret mode at
    ``tests/test_attention_v1.py``'s tolerance (2e-5 abs, 1e-4 rel), each
    side first against the f64 oracle."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 4, 48, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, 80, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, 80, d)).astype(np.float32)
    causal, window = mode != "none", 20 if mode == "window" else None
    ref = jax.device_get(jax_flash_attention_v1(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, window=window))
    got = flash_attention_v1(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, window=window).numpy()
    oracle = naive_attention(q, np.repeat(k, 2, 1), np.repeat(v, 2, 1),
                             causal=causal, window=window)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ref, oracle, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", PAGED_WIDE)
def test_flash_attention_v2_wide_head_dims_match_jax(d, causal):
    """``flash_attention_v2`` (H1's spans of 128 keys, the last ragged,
    merged by H2) at d 264 and 512 against JAX's, at
    ``tests/test_attention_v2.py``'s tolerance (1e-5 abs and rel)."""
    rng = np.random.default_rng(d + causal)
    q = rng.standard_normal((1, 2, 64, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, 300, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, 300, d)).astype(np.float32)
    fields = dict(block_q=64, block_kv=64, kv_tiles_per_block=2)
    ref = jax.device_get(jax_flash_attention_v2(
        *(jnp.asarray(x) for x in (q, k, v)), JSplitKV(**fields),
        causal=causal))
    got = flash_attention_v2(*(torch.from_numpy(x) for x in (q, k, v)),
                             SplitKVConfig(**fields), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", PAGED_WIDE)
def test_paged_decode_wide_head_dims_match_jax(d):
    """``paged_decode_attention`` at d 264 and 512, a group of 2, a ragged
    batch (histories 130 and 300 over 128-token pages), without and with a
    window of 100, against JAX's B20 in interpret mode on the same codes
    (1e-5 abs, f32, as ``tests/test_torch_serving.py``), the port against
    the f64 oracle over each band too."""
    hist = (130, 300)
    jc, tc, slots = _fill_both(d, d, 128, hist)
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


@pytest.mark.parametrize("d", PAGED_WIDE)
def test_paged_extend_wide_head_dims_match_jax(d):
    """``paged_extend_attention`` (a 5-token chunk over ragged histories 100
    and 260, 128-token pages) at d 264 and 512, a group of 2, without and
    with a window of 100, against JAX's B21/B22 in interpret mode on the
    same codes (1e-5 abs, f32, as ``tests/test_torch_extend.py``)."""
    hist, c = (100, 260), 5
    jc, tc, slots = _fill_both(d + 1, d, 128, hist, c)
    q = np.random.default_rng(d + 1).standard_normal(
        (len(hist), c, GROUP, d)).astype(np.float32)
    for window in (None, 100):
        ref = jax.device_get(jax_paged_extend(
            jnp.asarray(q), jc, jnp.asarray(slots.numpy()), window=window))
        got = paged_extend_attention(torch.from_numpy(q), tc, slots,
                                     window=window).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)


# the slice: a 2-layer LM with heads512's attention (2 heads of 512 over
# one KV head), narrow elsewhere
WIDE_KW = dict(vocab_size=128, n_layers=2, n_heads=2, n_kv_heads=1,
               d_model=128, d_head=512, d_ff=256)


def test_engine_at_d512_gives_jax_tokens():
    """The slice as a whole at d_head 512: JAX's weights carried over by
    ``params_from_jax`` (the projections [E, H, d] and [H, d, E] with H d
    = 1024 > E), the forward's logits (1e-4 abs, as
    ``tests/test_torch_model.py``), and ``GenerationEngine.generate`` with
    128-token pages giving JAX's greedy tokens."""
    jcfg = jtf.ModelConfig(**WIDE_KW,
                           tile=JTileConfig(block_q=64, block_kv=64))
    cfg = ModelConfig(**WIDE_KW)
    jparams = jtf.init_params(jcfg, seed=5)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    assert params["layers"][0]["wq"].shape == (128, 2, 512)
    assert params["layers"][0]["wo"].shape == (2, 512, 128)
    for jl, tl in zip(jax.tree.leaves(jparams), jax.tree.leaves(params),
                      strict=True):
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    prompt = np.random.default_rng(5).integers(
        0, WIDE_KW["vocab_size"], (2, 40)).astype(np.int32)
    np.testing.assert_allclose(
        forward(params, torch.from_numpy(prompt), cfg).numpy(),
        np.asarray(jtf.forward(jparams, jnp.asarray(prompt), jcfg)),
        atol=1e-4)
    jeng = jgen.GenerationEngine(jparams, jcfg, max_seqs=2, max_len=256,
                                 page_size=128)
    ref = jeng.generate(jnp.asarray(prompt), max_new_tokens=4)
    eng = GenerationEngine(params, cfg, max_seqs=2, max_len=256,
                           page_size=128)
    got = eng.generate(prompt, max_new_tokens=4)
    np.testing.assert_array_equal(got, np.asarray(ref))
