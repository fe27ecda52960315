"""The port's speculative decoding (``models/speculative.py``) and draft
distillation (``models/distill.py``) against target-only decoding and the
JAX package.

Mirrors every test of ``tests/test_speculative.py`` on the port (CPU, f32):
greedy speculative output equals the port's target-only greedy output
exactly, for paged and dense drafts at gamma 2 and 4; a self-draft accepts
everything, greedy and sampled; a distinct draft at temperature > 0 gives
valid tokens and partial acceptance; the engine validates and frees its
pages.  Then, against the JAX package on the same weights and prompts:
greedy speculative tokens (gamma 4, paged) equal JAX's exactly;
``_dense_draft_step``'s logits over a prefill and a few steps, with a
ring that wraps and a rollback, within 2e-5 absolute (f32, attention
summed in a different order); ``distill_draft`` over 3 steps gives the
same corpus and labels exactly, the same agreement (exactly, as fractions
of 96 positions) and a final loss within 1e-4 (f32 Adam on both sides).

The card tests (``tests/test_torch_kernels.py``) replay a captured round
after a rollback, bitwise against the same round run eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import distill as jdistill
from exploring_flash_attention_tpu.models import speculative as jspec
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.serving import kv_cache as jkv
from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    ModelConfig,
    SpeculativeEngine,
    distill_draft,
    init_params,
    params_from_jax,
    target_labeled_corpus,
)
from exploring_flash_attention_tpu_torch.models.speculative import (
    _dense_draft_prefill,
    _dense_draft_step,
)
from exploring_flash_attention_tpu_torch.serving import (
    append_chunks,
    append_prompts,
    make_cache,
)

TKW = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=4, d_model=64,
           d_head=16, d_ff=128)
DKW = dict(TKW, n_layers=1)
TCFG, DCFG = ModelConfig(**TKW), ModelConfig(**DKW)
JTILE = JTileConfig(block_q=32, block_kv=32)


def _prompt(rng, b, l):
    return rng.integers(0, 128, (b, l)).astype(np.int32)


def _params(cfg, seed):
    return init_params(cfg, seed=seed, device="cpu")


def _vanilla(params, cfg, prompt, n):
    return GenerationEngine(params, cfg, max_seqs=2, max_len=256).generate(
        prompt, max_new_tokens=n)


@pytest.mark.parametrize("mode", ["paged", "dense"])
@pytest.mark.parametrize("gamma", [2, 4])
def test_greedy_spec_matches_target_only(mode, gamma):
    """A shallow draft, paged or dense (window 64 < the context): greedy
    speculative output equals the target's own greedy output, token for
    token; the dense draft changes only the acceptance rate."""
    rng = np.random.default_rng(0 if mode == "paged" else 4)
    tparams, dparams = _params(TCFG, 0), _params(DCFG, 7)
    prompt = _prompt(rng, 2, 32)
    want = _vanilla(tparams, TCFG, prompt, 24)
    spec = SpeculativeEngine(tparams, TCFG, dparams, DCFG, max_seqs=2,
                             max_len=256, draft_mode=mode, draft_window=64)
    got, stats = spec.generate(prompt, max_new_tokens=24, gamma=gamma)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert 0.0 <= stats["acceptance_rate"] <= 1.0
    assert stats["rounds"] >= 1


def test_self_draft_accepts_everything_greedy():
    """draft == target: every proposal is the verifier's argmax, so
    acceptance is 1 and each round emits gamma + 1 tokens."""
    rng = np.random.default_rng(1)
    params = _params(TCFG, 0)
    prompt = _prompt(rng, 2, 32)
    spec = SpeculativeEngine(params, TCFG, params, TCFG, max_seqs=2,
                             max_len=256)
    got, stats = spec.generate(prompt, max_new_tokens=20, gamma=4)
    np.testing.assert_array_equal(got, _vanilla(params, TCFG, prompt, 20))
    assert stats["acceptance_rate"] >= 0.99, stats
    # full acceptance: ceil(19 / (gamma + 1)) rounds after the prefill token
    assert stats["rounds"] <= int(np.ceil(19 / 5)) + 1, stats


def test_stochastic_self_draft_acceptance_identity():
    """draft == target at temperature > 0: min(1, p_t / p_d) = 1, so
    rejection sampling accepts (numerics aside) every proposal."""
    rng = np.random.default_rng(2)
    params = _params(TCFG, 0)
    spec = SpeculativeEngine(params, TCFG, params, TCFG, max_seqs=2,
                             max_len=256)
    got, stats = spec.generate(_prompt(rng, 2, 32), max_new_tokens=16,
                               gamma=3, temperature=0.8, seed=3)
    assert got.shape == (2, 16)
    assert ((0 <= got) & (got < TCFG.vocab_size)).all()
    assert stats["acceptance_rate"] >= 0.98, stats


def test_stochastic_distinct_draft_runs():
    """A distinct draft at temperature > 0: valid tokens, sane stats, and a
    partial acceptance that runs the rollback; a seed repeats."""
    rng = np.random.default_rng(3)
    spec = SpeculativeEngine(_params(TCFG, 0), TCFG, _params(DCFG, 9), DCFG,
                             max_seqs=2, max_len=256)
    prompt = _prompt(rng, 2, 32)
    got, stats = spec.generate(prompt, max_new_tokens=16, gamma=4,
                               temperature=1.0, seed=5)
    assert got.shape == (2, 16)
    assert ((0 <= got) & (got < TCFG.vocab_size)).all()
    assert 0.0 <= stats["acceptance_rate"] < 0.9, stats
    again, _ = spec.generate(prompt, max_new_tokens=16, gamma=4,
                             temperature=1.0, seed=5)
    np.testing.assert_array_equal(got, again)


def test_engine_reusable_and_validates():
    rng = np.random.default_rng(4)
    tparams, dparams = _params(TCFG, 0), _params(DCFG, 7)
    spec = SpeculativeEngine(tparams, TCFG, dparams, DCFG, max_seqs=2,
                             max_len=128)
    with pytest.raises(ValueError, match="max_len"):
        spec.generate(_prompt(rng, 2, 64), max_new_tokens=64, gamma=4)
    with pytest.raises(ValueError, match="max_seqs"):
        spec.generate(_prompt(rng, 3, 8), max_new_tokens=4)
    # failed validation leaks no page: valid calls still work
    out, _ = spec.generate(_prompt(rng, 2, 32), max_new_tokens=8, gamma=2)
    assert out.shape == (2, 8)
    out2, _ = spec.generate(_prompt(rng, 1, 32), max_new_tokens=8, gamma=2)
    assert out2.shape == (1, 8)
    assert spec.t_alloc.free_pages == spec.t_alloc.n_pages
    assert spec.d_alloc.free_pages == spec.d_alloc.n_pages
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeEngine(tparams, TCFG, _params(ModelConfig(
            **dict(DKW, vocab_size=64)), 0), ModelConfig(
                **dict(DKW, vocab_size=64)))
    windowed = ModelConfig(**dict(DKW, window=16))
    with pytest.raises(ValueError, match="windowed"):
        SpeculativeEngine(tparams, TCFG, dparams, windowed)
    with pytest.raises(ValueError, match="draft_mode"):
        SpeculativeEngine(tparams, TCFG, dparams, DCFG, draft_mode="ring")


def test_dense_draft_self_acceptance_with_covering_window():
    """A dense self-draft whose window covers the whole context proposes
    the target's argmaxes: acceptance ~1, and output == target-only."""
    rng = np.random.default_rng(5)
    params = _params(TCFG, 0)
    prompt = _prompt(rng, 2, 24)
    spec = SpeculativeEngine(params, TCFG, params, TCFG, max_seqs=2,
                             max_len=256, draft_mode="dense",
                             draft_window=128)
    got, stats = spec.generate(prompt, max_new_tokens=16, gamma=4)
    np.testing.assert_array_equal(got, _vanilla(params, TCFG, prompt, 16))
    assert stats["acceptance_rate"] >= 0.9, stats


def _jax_cfgs():
    return (jtf.ModelConfig(**TKW, tile=JTILE),
            jtf.ModelConfig(**DKW, tile=JTILE))


def test_greedy_spec_tokens_match_jax():
    jt, jd = _jax_cfgs()
    jtp, jdp = jtf.init_params(jt, seed=0), jtf.init_params(jd, seed=7)
    prompt = _prompt(np.random.default_rng(6), 2, 32)
    want, jstats = jspec.SpeculativeEngine(
        jtp, jt, jdp, jd, max_seqs=2, max_len=256).generate(
            jnp.asarray(prompt), max_new_tokens=24, gamma=4)
    spec = SpeculativeEngine(
        params_from_jax(jax.device_get(jtp), device="cpu"), TCFG,
        params_from_jax(jax.device_get(jdp), device="cpu"), DCFG,
        max_seqs=2, max_len=256)
    got, stats = spec.generate(prompt, max_new_tokens=24, gamma=4)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == jstats


def test_dense_draft_step_matches_jax():
    """The prefill's ring (16 slots under a 24-token prompt: it wraps) and
    four steps, the last two after a rollback of two positions."""
    _, jd = _jax_cfgs()
    jdp = jtf.init_params(jd, seed=8)
    dparams = params_from_jax(jax.device_get(jdp), device="cpu")
    rng = np.random.default_rng(7)
    prompt = _prompt(rng, 2, 24)
    jbufs, jslot = jspec._dense_draft_prefill(jdp, jd, jnp.asarray(prompt),
                                              16, None)
    bufs, slot = _dense_draft_prefill(dparams, DCFG, torch.from_numpy(prompt),
                                      16)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    for (k, v), (jk, jv) in zip(bufs, jbufs):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=2e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2e-5)
    toks = _prompt(rng, 2, 4)
    for i, p in enumerate((24, 25, 24, 25)):
        pos = np.array([p, p + 3], np.int32)        # per-row positions
        jlg, jbufs, jslot = jspec._dense_draft_step(
            jdp, jd, jnp.asarray(toks[:, i]), jbufs, jslot, jnp.asarray(pos))
        lg, bufs, slot = _dense_draft_step(
            dparams, DCFG, torch.from_numpy(toks[:, i]), bufs, slot,
            torch.from_numpy(pos))
        assert lg.dtype == torch.float32
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=2e-5)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))


def test_distill_three_steps_match_jax():
    jt, jd = _jax_cfgs()
    jtp, jdp = jtf.init_params(jt, seed=0), jtf.init_params(jd, seed=7)
    kw = dict(n_seqs=4, prompt_len=8, seq_len=24, seed=0)
    jtok, jlab = jdistill.target_labeled_corpus(jtp, jt, **kw)
    _, jstats = jdistill.distill_draft(jtp, jt, jdp, jd, steps=3, batch=4,
                                       **kw)
    tparams = params_from_jax(jax.device_get(jtp), device="cpu")
    tok, lab = target_labeled_corpus(tparams, TCFG, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    dparams = params_from_jax(jax.device_get(jdp), device="cpu")
    _, stats = distill_draft(tparams, TCFG, dparams, DCFG, steps=3, batch=4,
                             **kw)
    assert stats["steps"] == jstats["steps"] == 3
    assert stats["agree_first"] == pytest.approx(jstats["agree_first"],
                                                 abs=1e-6)
    assert stats["agree_last"] == pytest.approx(jstats["agree_last"],
                                                abs=1e-6)
    assert abs(stats["loss_last"] - jstats["loss_last"]) < 1e-4, (
        stats, jstats)


def test_append_chunks_past_the_last_page_clamps_as_jax():
    """A sequence that runs ahead of the others keeps appending after its
    tokens are out; past its last mapped page ``append_chunks`` writes into
    that page, as JAX's clamped page-table gather sends the rows (codes and
    lengths bitwise, scales to 1e-6: XLA may multiply by a reciprocal)."""
    rng = np.random.default_rng(9)
    hkv, d, ps = 2, 128, 128
    table = np.array([[0, 1], [2, 3]], np.int32)
    jc = jkv.make_cache(hkv, d, 4, page_size=ps, max_seqs=2,
                        max_pages_per_seq=2)
    jc = jkv.PagedKVCache(jc.kv_pages, jc.kv_scales, jnp.asarray(table),
                          jc.seq_lens, jc.page_size, jc.head_pack)
    tc = make_cache(hkv, d, 4, page_size=ps, max_seqs=2, max_pages_per_seq=2,
                    device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    slots = np.array([0, 1], np.int32)
    kp = rng.standard_normal((2, 250, hkv, d)).astype(np.float32)
    jc = jkv.append_prompts(jc, jnp.asarray(slots), jnp.asarray(kp),
                            jnp.asarray(kp))
    append_prompts(tc, torch.from_numpy(slots), torch.from_numpy(kp),
                   torch.from_numpy(kp))
    for _ in range(2):                  # 250..258, then 259..267
        k = rng.standard_normal((2, 9, hkv, d)).astype(np.float32)
        jc = jkv.append_chunks(jc, jnp.asarray(slots), jnp.asarray(k),
                               jnp.asarray(k))
        append_chunks(tc, torch.from_numpy(slots), torch.from_numpy(k),
                      torch.from_numpy(k))
    assert tc.seq_lens.tolist() == [268, 268]
    np.testing.assert_array_equal(tc.kv_pages.numpy(),
                                  np.asarray(jc.kv_pages))
    np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))
    np.testing.assert_allclose(tc.kv_scales.numpy(), np.asarray(jc.kv_scales),
                               rtol=1e-6)
