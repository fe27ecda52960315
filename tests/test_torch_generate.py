"""Port generation (prefill + paged INT8 decode) vs the JAX engine.

At a small f32 config both engines must emit the same greedy tokens from
the same weights and prompt.  The decode path must also reproduce the
port's own full forward at every step, up to INT8 cache error (agreement,
or a near-tie under a 0.15 logit gap, as tests/test_generate.py states).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import generate as jgen
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    ModelConfig,
    forward,
    forward_collect_kv,
    init_params,
)
from exploring_flash_attention_tpu_torch.utils.profile_generate import (
    eager_generate,
)

REPO = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=128,
          d_head=64, d_ff=256)
CFG = ModelConfig(**KW)
JCFG = jtf.ModelConfig(**KW, tile=JTileConfig(block_q=64, block_kv=64))


def _prompt(seed, b, l):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, l)).astype(np.int32)


def test_greedy_tokens_match_jax_engine():
    prompt = _prompt(0, 2, 24)
    jeng = jgen.GenerationEngine(jtf.init_params(JCFG, seed=0), JCFG,
                                 max_seqs=2, max_len=256)
    ref = jeng.generate(jnp.asarray(prompt), max_new_tokens=5)
    eng = GenerationEngine(init_params(CFG, seed=0, device="cpu"), CFG,
                           max_seqs=2, max_len=256)
    got = eng.generate(prompt, max_new_tokens=5)
    assert got.shape == (2, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_forward_collect_kv_matches_jax_and_forward():
    params = init_params(CFG, seed=1, device="cpu")
    toks = _prompt(1, 2, 32)
    logits, kvs = forward_collect_kv(params, torch.from_numpy(toks), CFG)
    full = forward(params, torch.from_numpy(toks), CFG)
    torch.testing.assert_close(logits, full, rtol=0, atol=1e-6)
    _, jkvs = jgen.forward_collect_kv(jtf.init_params(JCFG, seed=1),
                                      jnp.asarray(toks), JCFG)
    assert len(kvs) == CFG.n_layers
    for (k, v), (jk, jv) in zip(kvs, jkvs):
        assert k.shape == (2, 32, CFG.n_kv_heads, CFG.d_head)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4)


def test_decode_matches_full_forward_logits():
    params = init_params(CFG, seed=2, device="cpu")
    prompt = _prompt(2, 2, 17)
    out = GenerationEngine(params, CFG, max_seqs=2, max_len=64).generate(
        prompt, max_new_tokens=4)
    seq = prompt
    for t in range(4):
        logits = forward(params, torch.from_numpy(seq), CFG)[:, -1].numpy()
        nxt = logits.argmax(-1)
        for b in range(2):
            if nxt[b] != out[b, t]:
                gap = abs(logits[b, nxt[b]] - logits[b, out[b, t]])
                assert gap < 0.15, (t, b, gap)
        seq = np.concatenate([seq, out[:, t:t + 1]], axis=1)


def test_temperature_sampling_reproducible_from_seed():
    params = init_params(CFG, seed=3, device="cpu")
    prompt = _prompt(3, 1, 8)
    a = GenerationEngine(params, CFG, max_seqs=1, max_len=32).generate(
        prompt, 3, temperature=0.8, seed=7)
    b = GenerationEngine(params, CFG, max_seqs=1, max_len=32).generate(
        prompt, 3, temperature=0.8, seed=7)
    np.testing.assert_array_equal(a, b)


def test_engine_reusable_and_pages_released():
    params = init_params(CFG, seed=4, device="cpu")
    prompt = _prompt(4, 1, 8)
    eng = GenerationEngine(params, CFG, max_seqs=1, max_len=32)
    a = eng.generate(prompt, 2)
    assert eng.allocator.free_pages == eng.allocator.n_pages
    np.testing.assert_array_equal(a, eng.generate(prompt, 2))


def test_engine_refuses_over_capacity_and_hold():
    """Slots are held only between ``generate(hold=True)`` and
    ``release()``: a second ``generate`` then raises, ``continue_generation``
    raises without them, and a wrong batch or an overflowing turn raises
    while leaving them held.  A slot holds 2 pages of 128 tokens."""
    eng = GenerationEngine(init_params(CFG, seed=0, device="cpu"), CFG,
                           max_seqs=1, max_len=256, page_size=128)
    with pytest.raises(ValueError, match="max_seqs"):
        eng.generate(np.zeros((2, 4), np.int32), 2)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((1, 254), np.int32), 4)
    with pytest.raises(RuntimeError, match="no held slots"):
        eng.continue_generation(np.zeros((1, 4), np.int32), 2)
    assert eng.allocator.free_pages == eng.allocator.n_pages

    eng.generate(np.zeros((1, 4), np.int32), 2, hold=True)      # 5 cached
    held = eng.allocator.free_pages
    assert held < eng.allocator.n_pages
    with pytest.raises(RuntimeError, match="release"):
        eng.generate(np.zeros((1, 4), np.int32), 2)
    with pytest.raises(ValueError, match="held slots"):
        eng.continue_generation(np.zeros((2, 4), np.int32), 2)
    with pytest.raises(ValueError, match="max_len"):
        eng.continue_generation(np.zeros((1, 251), np.int32), 2)
    assert eng.allocator.free_pages == held
    eng.continue_generation(np.zeros((1, 249), np.int32), 2)    # 255 cached
    eng.release()
    eng.release()                                   # a second one is a no-op
    assert eng.allocator.free_pages == eng.allocator.n_pages
    assert eng.generate(np.zeros((1, 4), np.int32), 2).shape == (1, 2)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import exploring_flash_attention_tpu_torch as p\n"
        "import exploring_flash_attention_tpu_torch.kernels\n"
        "import exploring_flash_attention_tpu_torch.oracle\n"
        "import exploring_flash_attention_tpu_torch.utils\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'exploring_flash_attention_tpu.'))\n"
        "             or m == 'exploring_flash_attention_tpu')\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_eager_reference_matches_generate_and_reseeds():
    """``eager_generate`` (the loop over ``_decode_forward`` that the card's
    replayed decode graph is held to, bitwise) gives ``generate``'s greedy
    tokens, and so the JAX engine's; one engine re-seeds its generator at
    every call, so a temperature call repeats from its seed."""
    prompt = _prompt(0, 2, 24)
    eng = GenerationEngine(init_params(CFG, seed=0, device="cpu"), CFG,
                           max_seqs=2, max_len=256)
    ref = jgen.GenerationEngine(jtf.init_params(JCFG, seed=0), JCFG,
                                max_seqs=2, max_len=256).generate(
        jnp.asarray(prompt), max_new_tokens=5)
    got = eager_generate(eng, prompt, 5)
    np.testing.assert_array_equal(got, eng.generate(prompt, 5))
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert eng.allocator.free_pages == eng.allocator.n_pages
    hot = [eng.generate(prompt, 4, temperature=0.8, seed=s)
           for s in (7, 7, 8)]
    np.testing.assert_array_equal(hot[0], hot[1])
