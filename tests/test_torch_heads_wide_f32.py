"""The serving path at f32 past head dim 256, vs the JAX package: a 2-layer
f32 LM at d_head 512 under a window serving two turns, and the paged
extend at d 300 under windows.

f32 is the JAX ``ModelConfig``'s default dtype, and the JAX package serves
it at f32 (its kernels at HIGHEST, its paged kernels in q's dtype).  The
same NumPy inputs and JAX's weights (``params_from_jax``) go through the
JAX functions (Pallas in interpret mode on the CPU, as the JAX package's
tests run it) and the port's CPU path (the plain versions of H1,
H6-decode and H6-extend), in f32, at the tolerance of the JAX test of each
function, stated in each test.  On the card these d run at f32 on H5's
f32 block in clusters of two (H1 and H6-extend,
``csrc/prefill_attention_wide_f32.cu``, ``csrc/paged_extend_wide_f32.cu``)
and on H6-decode's f32 D=512 instances (``tests/test_torch_kernels.py``
holds them against these plain versions there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import generate as jgen
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.serving import decode as jdec
from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    ModelConfig,
    forward,
    params_from_jax,
)
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.serving import (
    gather_kv,
    paged_extend_attention,
)
from f32_pieces import one_torch_thread  # noqa: F401 (autouse)
from test_torch_heads import _fill_both

GROUP = 2                       # q heads over one KV head, as heads512

# the slice: a 2-layer f32 LM with heads512's attention (2 heads of 512
# over one KV head) under a window of 48 keys, narrow elsewhere
WIDE_WINDOW_KW = dict(vocab_size=128, n_layers=2, n_heads=2, n_kv_heads=1,
                      d_model=128, d_head=512, d_ff=256, window=48)


def test_f32_engine_at_d512_under_a_window_gives_jax_tokens():
    """The slice as a whole at f32, d_head 512 and a window of 48 over
    128-token prompts (the JAX windowed forward takes a key count that is
    a multiple of 128): JAX's weights carried over by ``params_from_jax``,
    the forward's logits within 1e-4 abs (``tests/test_torch_model.py``'s
    tier), and two turns of ``GenerationEngine`` (``generate`` held, then
    ``continue_generation`` of a 9-token turn, 128-token pages) giving
    JAX's greedy tokens."""
    jcfg = jtf.ModelConfig(**WIDE_WINDOW_KW,
                           tile=JTileConfig(block_q=64, block_kv=64))
    cfg = ModelConfig(**WIDE_WINDOW_KW)
    assert jcfg.dtype == jnp.float32 and cfg.dtype == torch.float32
    jparams = jtf.init_params(jcfg, seed=7)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 128, (2, 128)).astype(np.int32)
    turn = rng.integers(0, 128, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        forward(params, torch.from_numpy(prompt), cfg).numpy(),
        np.asarray(jtf.forward(jparams, jnp.asarray(prompt), jcfg)),
        atol=1e-4)
    jeng = jgen.GenerationEngine(jparams, jcfg, max_seqs=2, max_len=256,
                                 page_size=128)
    j1 = np.asarray(jeng.generate(jnp.asarray(prompt), 4, hold=True))
    j2 = np.asarray(jeng.continue_generation(
        jnp.asarray(np.concatenate([j1[:, -1:], turn], axis=1)), 3))
    jeng.release()
    eng = GenerationEngine(params, cfg, max_seqs=2, max_len=256,
                           page_size=128)
    t1 = eng.generate(prompt, 4, hold=True)
    np.testing.assert_array_equal(t1, j1)
    t2 = eng.continue_generation(
        np.concatenate([t1[:, -1:], turn], axis=1), 3)
    np.testing.assert_array_equal(t2, j2)
    eng.release()


@pytest.mark.parametrize("window", [1, 77])
@pytest.mark.parametrize("onepass", [False, True])
def test_paged_extend_d300_under_a_window_matches_jax(onepass, window):
    """``paged_extend_attention`` at d 300 (code rows of 4-byte alignment)
    with f32 q, a group of 2, a 5-token chunk over ragged histories 100 and
    260 on 128-token pages, under windows of 1 and 77 keys: against JAX's
    B21 (page streaming) and B22 (one pass) in interpret mode on the same
    codes (1e-5 abs, f32, as ``tests/test_torch_extend.py``), and each
    chunk row against the f64 oracle over its band of the dequantized
    cache."""
    d, hist, c = 300, (100, 260), 5
    jc, tc, slots = _fill_both(d + window, d, 128, hist, c)
    q = np.random.default_rng(d + window).standard_normal(
        (len(hist), c, GROUP, d)).astype(np.float32)
    ref = jax.device_get(jdec._paged_extend_attention(
        jnp.asarray(q), jc, jnp.asarray(slots.numpy()), scale=None,
        interpret=None, window=window, onepass=onepass))
    got = paged_extend_attention(torch.from_numpy(q), tc, slots,
                                 window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    for s, n in enumerate(hist):
        k, v = gather_kv(tc, s)                        # [1, n + c, d] f32
        for i in range(c):
            pos = n + i
            lo = max(0, pos - window + 1)
            oracle = naive_attention(q[s, i][None], k[:, lo:pos + 1].numpy(),
                                     v[:, lo:pos + 1].numpy())
            np.testing.assert_allclose(got[s, i].numpy(), oracle[0],
                                       atol=1e-5)
