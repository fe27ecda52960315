"""The port's tile and precision surface against the JAX package, on the CPU.

- ``TileConfig``, ``SplitKVConfig(TileConfig)``, ``Precision``,
  ``round_up`` and the canonical constants: JAX's fields, defaults and
  validation; ``ModelConfig.tile``'s default and a model forward with a
  tile passed through.
- ``TileConfig(softmax="bound")`` through ``flash_attention_v1``'s plain
  path: every bound case of JAX's ``tests/test_attention_v1.py:430-600``
  at its shapes and limits (f32 inputs at 2e-5 against the f64 oracle and
  against JAX's output on the same inputs; the bf16 tier at 2e-3), and the
  whole-tile causal invariance bitwise.  The plain path computes H1's
  statistic (``ops/attention.bound_kmax`` and ``bound_shift``): each row's
  shift from ``||q_i||`` and the prefix maximum of ``||k_j||^2`` over
  128-key tiles, at the tile the last row of the row's 128-row group sees.
- ``utils/``: every case of JAX's ``tests/test_utils.py`` against the
  port's ``utils`` (the autotuner's disk cache monkeypatched to
  ``tmp_path``), the signatures' order, ``trace`` and ``kernel_report``.

The card's forms of these (H1's bound launch, the 64-row Q tile) are
``tests/test_torch_kernels.py``'s ``test_h1_bound_*`` and
``test_h1_q_tile_*``, and ``chip_smoke.py --only tiles``.
"""

import dataclasses
import inspect
import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu import configs as jconfigs
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.ops import (
    flash_attention_v1 as jax_flash_attention_v1,
)
from exploring_flash_attention_tpu.oracle.reference import (
    make_qkv as jax_make_qkv,
)
from exploring_flash_attention_tpu.utils import autotune as jautotune
from exploring_flash_attention_tpu.utils import benchmark as jbenchmark
from exploring_flash_attention_tpu.utils import profiling as jprofiling
import exploring_flash_attention_tpu_torch as port
from exploring_flash_attention_tpu_torch import configs
from exploring_flash_attention_tpu_torch.configs import (
    Precision,
    SplitKVConfig,
    TileConfig,
)
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    forward,
    init_params,
)
from exploring_flash_attention_tpu_torch.ops import (
    flash_attention_v1,
    prefill_attention,
    quantize_int8,
)
from exploring_flash_attention_tpu_torch.ops.attention import (
    BOUND_SHIFT,
    bound_kmax,
    bound_shift,
    h1_q_rows,
    traced_pair,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
    split_kv_span,
)
from exploring_flash_attention_tpu_torch.oracle import (
    error_stats,
    naive_attention,
)
from exploring_flash_attention_tpu_torch.utils import autotune as at
from exploring_flash_attention_tpu_torch.utils import benchmark
from exploring_flash_attention_tpu_torch.utils import profiling
from exploring_flash_attention_tpu_torch.utils import (
    attention_flops,
    autotune_dtiled,
    autotune_splitkv,
    autotune_v1,
    autotune_window,
    kernel_report,
    roofline_attention_tflops,
    roofline_tflops,
    time_fn_chained,
    time_fn_chained_windows,
    trace,
)

F32_TOL = 2e-5          # JAX's f32 bound limit (interpret mode and plain)
BF16_TOL = 2e-3         # JAX's bf16 bound tier (test_attention_v1.py:441)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _jax(q, k, v, cfg, **kw):
    return np.asarray(jax_flash_attention_v1(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        config=jconfigs.TileConfig(**cfg), **kw))


# ---- configs ----

def test_tile_config_fields_defaults_and_validation_match_jax():
    """TileConfig and SplitKVConfig: JAX's fields in JAX's order with its
    defaults; the same bad values raise on both sides; SplitKVConfig is a
    TileConfig; round_up and the canonical constants are JAX's."""
    for ours, theirs in ((TileConfig, jconfigs.TileConfig),
                         (SplitKVConfig, jconfigs.SplitKVConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
                == [(f.name, f.default) for f in dataclasses.fields(theirs)])
    assert issubclass(SplitKVConfig, TileConfig)
    for bad in ({"block_q": 96}, {"block_kv": 0}, {"block_q": -64},
                {"softmax": "fast"}, {"head_fold": 3}, {"head_fold": 0},
                {"d_tile_qk": 64}, {"d_tile_v": 0}, {"q_chunk": 12},
                {"q_chunk": 0}):
        for cls in (TileConfig, SplitKVConfig, jconfigs.TileConfig):
            with pytest.raises(ValueError):
                cls(**bad)
    for cls in (TileConfig, jconfigs.TileConfig):
        with pytest.raises(ValueError, match="softmax"):
            cls(softmax="fast")
        cfg = cls(d_tile_qk=128, d_tile_v=256)
        cfg.validate_for(64, 64, 256)
        with pytest.raises(ValueError):
            cfg.validate_for(64, 64, 384)
    for x, m in ((0, 8), (1, 8), (8, 8), (1000, 128), (1025, 128)):
        assert configs.round_up(x, m) == jconfigs.round_up(x, m)
    for name in ("CANONICAL_B", "CANONICAL_H", "CANONICAL_L",
                 "CANONICAL_D_V1", "CANONICAL_D_TILED"):
        assert getattr(configs, name) == getattr(jconfigs, name)


def test_precision_matches_jax():
    """Precision: JAX's fields and defaults in torch's dtypes, and its
    softmax scale."""
    ours = {f.name: f.default for f in dataclasses.fields(Precision)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jconfigs.Precision)}
    assert list(ours) == list(theirs)
    assert ours["storage"] == torch.bfloat16 and ours["accum"] == torch.float32
    assert np.dtype(theirs["storage"]).name == "bfloat16"
    assert np.dtype(theirs["accum"]).name == "float32"
    for scale in (None, 0.25):
        for d in (32, 128):
            assert (Precision(scale=scale).softmax_scale(d)
                    == jconfigs.Precision(scale=scale).softmax_scale(d))


def test_top_level_exports_match_jax():
    """The JAX package's top-level names the port has a meaning for, with
    the oracle helpers working on tensors (naive_attention_jax is the
    oracle on JAX arrays and is not ported)."""
    import exploring_flash_attention_tpu as jpkg

    for name in set(jpkg.__all__) - {"naive_attention_jax"}:
        assert name in port.__all__ and callable(getattr(port, name)), name
    q, k, v = make_inputs(1, 2, 64, 32, seed=0)
    ref = port.naive_attention(q, k, v)
    out = flash_attention_v1(*_t(q, k, v))
    assert port.check_accuracy(out, ref, max_abs_tol=F32_TOL)["max_abs"] \
        < F32_TOL
    buf = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(buf):
        port.print_comparison(out, ref, name="v1")
    assert "--- v1 vs oracle ---" in buf.getvalue()
    assert "worst @" in buf.getvalue()


def test_model_config_tile_default_and_forward_passes_it():
    """ModelConfig.tile is JAX's default (128-row tiles: H1's default Q
    tile), and a forward with a 64-row tile passed through gives JAX's
    logits (JAX's model runs its kernels at that tile)."""
    tile = ModelConfig().tile
    assert isinstance(tile, TileConfig)
    assert (dataclasses.astuple(tile)
            == dataclasses.astuple(jtf.ModelConfig().tile))
    assert h1_q_rows(tile) == 128
    kw = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2,
              d_model=128, d_head=64, d_ff=256)
    cfg = ModelConfig(**kw, tile=TileConfig(block_q=64, block_kv=64))
    jcfg = jtf.ModelConfig(**kw, tile=jconfigs.TileConfig(block_q=64,
                                                          block_kv=64))
    assert h1_q_rows(cfg.tile) == 64
    toks = np.random.default_rng(2).integers(0, 128, (2, 32)).astype(np.int32)
    ref = np.asarray(jtf.forward(jtf.init_params(jcfg, seed=2),
                                 jnp.asarray(toks), jcfg))
    got = forward(init_params(cfg, seed=2, device="cpu"),
                  torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    default = forward(init_params(ModelConfig(**kw), seed=2, device="cpu"),
                      torch.from_numpy(toks), ModelConfig(**kw))
    assert torch.equal(got, default)


# ---- the bound statistic ----

def make_inputs(b, h, l, d, seed, lkv=None, dtype=np.float32):
    return jax_make_qkv(b, h, l, d, dtype=dtype, seed=seed, seq_len_kv=lkv)


# JAX's bound cases (tests/test_attention_v1.py:430-600): (id, B, H, L, d,
# seed, Lkv, KV heads, JAX config, causal, window)
BOUND_CASES = [
    ("oracle", 2, 4, 512, 128, 3, None, None,
     dict(block_q=512, block_kv=512), False, None),
    ("head_folded", 4, 4, 1024, 128, 4, None, None,
     dict(block_q=1024, block_kv=1024), False, None),
    ("ragged_kv", 1, 2, 256, 128, 5, 200, None,
     dict(block_q=256, block_kv=256), False, None),
    ("causal", 2, 4, 512, 128, 6, None, None,
     dict(block_q=512, block_kv=512), True, None),
    ("pvt_d32", 2, 4, 512, 32, 7, None, None,
     dict(block_q=1024, block_kv=1024), False, None),
    ("pvt_d32_ragged", 1, 2, 256, 32, 8, 200, None,
     dict(block_q=1024, block_kv=1024), False, None),
    ("streaming", 2, 2, 384, 64, 9, None, None,
     dict(block_q=128, block_kv=128, one_pass=False), False, None),
    ("streaming_causal", 2, 2, 384, 64, 9, None, None,
     dict(block_q=128, block_kv=128, one_pass=False), True, None),
    ("streaming_gqa_ragged", 1, 4, 256, 64, 10, 200, 2,
     dict(block_q=128, block_kv=128, one_pass=False), False, None),
    ("streaming_window", 1, 2, 384, 64, 12, None, None,
     dict(block_q=128, block_kv=128, one_pass=False), True, 100),
]


@pytest.mark.parametrize(
    "b,h,l,d,seed,lkv,hkv,jcfg,causal,window",
    [c[1:] for c in BOUND_CASES], ids=[c[0] for c in BOUND_CASES])
def test_bound_matches_oracle_and_jax(b, h, l, d, seed, lkv, hkv, jcfg,
                                      causal, window):
    """The port's bound path (f32 inputs) against the f64 oracle and JAX's
    bound output on the same inputs, each within JAX's 2e-5."""
    q, k, v = make_inputs(b, h, l, d, seed, lkv)
    if hkv is not None:
        k, v = k[:, :hkv], v[:, :hkv]
    kw = dict(causal=causal, window=window)
    out = flash_attention_v1(*_t(q, k, v), TileConfig(softmax="bound"),
                             **kw).numpy()
    group = h // k.shape[1]
    ref = naive_attention(q, np.repeat(k, group, 1), np.repeat(v, group, 1),
                          **kw)
    assert error_stats(out, ref)["max_abs"] < F32_TOL
    jout = _jax(q, k, v, dict(jcfg, softmax="bound"), **kw)
    assert error_stats(out, jout)["max_abs"] < F32_TOL
    # the exact path differs from the bound one only by rounding
    exact = flash_attention_v1(*_t(q, k, v), **kw).numpy()
    assert error_stats(out, exact)["max_abs"] < F32_TOL


def test_bound_bf16_tier_matches_jax():
    """bf16 inputs (JAX's storage tier): the port's bound O (f32 math over
    the bf16 values, as H1's plain version) and JAX's both within 2e-3 of
    the oracle on the bf16-rounded inputs."""
    q, k, v = make_inputs(2, 4, 512, 128, seed=3)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = naive_attention(*(np.asarray(x.astype(jnp.float32))
                            for x in (qb, kb, vb)))
    cfg = jconfigs.TileConfig(block_q=512, block_kv=512, softmax="bound")
    jout = np.asarray(jax_flash_attention_v1(qb, kb, vb, config=cfg,
                                             out_dtype=jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (qb, kb, vb))
    out = flash_attention_v1(tq, tk, tv, TileConfig(softmax="bound"),
                             out_dtype=torch.float32)
    assert error_stats(jout, ref)["max_abs"] < BF16_TOL
    assert error_stats(out, ref)["max_abs"] < BF16_TOL


def _extend(x, key, n, d):
    """x grown along the sequence by n rows of jax.random.normal(key)."""
    ext = np.asarray(jax.random.normal(jax.random.PRNGKey(key),
                                       (*x.shape[:2], n, d)), np.float32)
    return np.concatenate([x, ext], axis=2)


# (id, B, H, L, d, seed, grown by, PRNG keys of the q, k, v extension):
# JAX's invariance cases (:467-491, :528-543, :581-600)
GROW_CASES = [("one_pass", 2, 4, 512, 128, 6, 128, (0, 1, 2)),
              ("streaming", 1, 2, 256, 64, 11, 128, (0, 1, 2)),
              ("misaligned_whole_tile", 1, 2, 256, 64, 12, 256,
               (80, 81, 82)),
              ("misaligned_sub_tile", 1, 2, 256, 64, 12, 128, (90, 91, 92))]


@pytest.mark.parametrize("b,h,l,d,seed,grow,keys",
                         [c[1:] for c in GROW_CASES],
                         ids=[c[0] for c in GROW_CASES])
def test_bound_causal_invariance_to_whole_tiles(b, h, l, d, seed, grow,
                                                keys):
    """Causal bound outputs are bitwise unchanged when K/V (and q) grow by
    whole 128-key tiles: the statistic never reads past the tile the last
    row of a 128-row group sees.  The grown call stays within 2e-5 of the
    oracle.  (JAX's sub-tile case is not invariant at its block_kv of
    256; the port's tiles are 128 keys, so a 128-key growth is whole.)"""
    q, k, v = make_inputs(b, h, l, d, seed)
    grown = [_extend(x, key, grow, d) for x, key in zip((q, k, v), keys)]
    cfg = TileConfig(softmax="bound")
    out = flash_attention_v1(*_t(q, k, v), cfg, causal=True)
    out2 = flash_attention_v1(*_t(*grown), cfg, causal=True)
    assert torch.equal(out2[:, :, :l], out)
    assert error_stats(out2, naive_attention(*grown, causal=True))[
        "max_abs"] < F32_TOL


def test_bound_statistic_is_the_prefix_tile_max():
    """bound_kmax is the cummax over 128-key tiles of each tile's largest
    ||k||^2 (zero-filled tail keys count 0), per KV head; bound_shift reads
    it at the tile the last row of each 128-row group sees, shifted by 64
    bits below the Cauchy-Schwarz bound, whatever the Q tile."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 2, 300, 32)).astype(np.float32)
    k[:, :, 140:150] *= 3.0                       # a large tile in the middle
    pk = bound_kmax(torch.from_numpy(k)).numpy()
    ksq = np.pad((k.astype(np.float64) ** 2).sum(-1), ((0, 0), (0, 0),
                                                        (0, 84)))
    want = np.maximum.accumulate(ksq.reshape(2, 2, 3, 128).max(-1), axis=-1)
    np.testing.assert_allclose(pk, want, rtol=1e-5)
    q = rng.standard_normal((2, 4, 260, 32)).astype(np.float32)
    scale = 0.2
    for causal, diag in ((False, 0), (True, 40), (True, -200)):
        shift = bound_shift(torch.from_numpy(q), torch.from_numpy(pk),
                            scale, causal, diag).numpy()
        rows = np.arange(260)
        last = np.minimum(rows // 128 * 128 + 128, 260) - 1
        idx = (np.clip((last + diag) // 128, 0, 2) if causal
               else np.full(260, 2))
        kk = np.repeat(pk, 2, axis=1)[:, :, idx]
        qsq = (q.astype(np.float64) ** 2).sum(-1)
        np.testing.assert_allclose(
            shift, np.sqrt(qsq * kk) * scale - BOUND_SHIFT * math.log(2),
            rtol=1e-5)
        # traced positions give the static statistic, bitwise
        if causal:
            pair = traced_pair((torch.tensor(diag + 5), torch.tensor(5)),
                               torch.device("cpu"))
            assert torch.equal(torch.from_numpy(shift), bound_shift(
                torch.from_numpy(q), torch.from_numpy(pk), scale, True,
                pair))


@pytest.mark.parametrize("causal,pos", [(False, (0, 0)), (True, (300, 100)),
                                        (True, (0, 400))])
def test_bound_spans_and_traced_positions_on_h1s_plain_path(causal, pos):
    """prefill_attention's bound form (H1's plain version): traced
    positions bitwise the static ones; over KV spans every span shares the
    row's shift, and the spans merged equal one span within 2e-5; a row
    that sees no key gives (0, -inf)."""
    from exploring_flash_attention_tpu_torch.ops import splitkv_combine

    q, k, v = _t(*make_inputs(1, 4, 200, 64, seed=13, lkv=520))
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
    scale = 0.125
    diag = pos[0] - pos[1]
    static = prefill_attention(q, k, v, scale, diag, causal,
                               softmax="bound")
    traced = prefill_attention(q, k, v, scale,
                               traced_pair([torch.tensor(p) for p in pos],
                                           q.device),
                               causal, softmax="bound")
    assert all(torch.equal(a, b) for a, b in zip(static, traced))
    spans = prefill_attention(q, k, v, scale, diag, causal, kv_span=128,
                              softmax="bound")
    merged = splitkv_combine(*spans)
    assert (merged - static[0]).abs().max() < F32_TOL
    exact = prefill_attention(q, k, v, scale, diag, causal)
    fin = torch.isfinite(exact[1])
    assert torch.equal(torch.isfinite(static[1]), fin)
    assert (static[0] - exact[0]).abs().max() < F32_TOL
    if fin.any():
        assert (static[1] - exact[1])[fin].abs().max() < F32_TOL
    if not fin.all():
        assert (static[0][~fin] == 0).all()


def test_q_tile_leaves_the_plain_result_and_counts_blocks():
    """block_q picks H1's Q tile (64 rows at <= 64, else 128) and leaves
    the plain result unchanged; split_kv_span counts blocks at the tile
    used (64-row tiles fill a wave where 128-row ones leave it half
    empty)."""
    assert [h1_q_rows(TileConfig(block_q=bq)) for bq in (8, 32, 64, 128,
                                                         512)] \
        == [64, 64, 64, 128, 128]
    q, k, v = _t(*make_inputs(2, 2, 200, 64, seed=14))
    for kw in ({}, {"causal": True}, {"causal": True, "window": 50}):
        a = flash_attention_v1(q, k, v, TileConfig(block_q=64), **kw)
        b = flash_attention_v1(q, k, v, TileConfig(block_q=128), **kw)
        assert torch.equal(a, b)
    assert split_kv_span(1, 8, 1024, 8192) == 4096
    assert split_kv_span(1, 8, 1024, 8192, q_rows=64) is None
    assert split_kv_span(1, 4, 1024, 8192, q_rows=64) == 4096


# ---- utils ----

def test_autotune_returns_valid_config_and_caches(tmp_path, monkeypatch):
    """JAX's test_utils case: a candidate comes back, the in-process cache
    answers the second call, the disk cache the third."""
    monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / "cache.json"))
    at._CACHE.clear()
    q, k, v = _t(*make_inputs(1, 1, 64, 32, seed=0))
    cands = [TileConfig(block_q=32, block_kv=32),
             TileConfig(block_q=64, block_kv=64)]
    cfg = autotune_v1(q, k, v, candidates=cands, iters=1)
    assert cfg in cands
    assert autotune_v1(q, k, v, candidates=[], iters=1) == cfg
    at._CACHE.clear()
    assert autotune_v1(q, k, v, candidates=[cands[0]], iters=1) == cfg
    key = next(iter(json.loads((tmp_path / "cache.json").read_text())))
    assert key.startswith("v1|cpu|(1, 1, 64, 32)|64|float32")


def test_default_candidates_cover_both_q_tiles():
    """The port's counterpart of JAX's candidate test: the v1 candidates
    are H1's two Q tiles, and every block_q is within JAX's cap."""
    cands = at.default_candidates_v1(1024, 1024, 128)
    assert sorted(h1_q_rows(c) for c in cands) == [64, 128]
    assert all(c.block_q <= 1024 for c in cands)
    assert all(c.softmax == "exact" for c in cands)


def test_roofline_model():
    """JAX's roofline cases at the H100's published peaks."""
    assert roofline_tflops(10**15, 10**6) == 989.0
    assert abs(roofline_tflops(10**9, 10**9) - 3.35) < 1e-9
    # the JAX model's numbers at JAX's v5e peaks
    assert roofline_tflops(10**15, 10**6, 197.0, 819.0) \
        == jprofiling.roofline_tflops(10**15, 10**6)
    assert roofline_attention_tflops(32, 8, 1024, 128, 2, 197.0, 819.0) \
        == jbenchmark.roofline_attention_tflops(32, 8, 1024, 128)
    for causal in (False, True):
        assert attention_flops(2, 8, 100, 300, 64, causal) \
            == jbenchmark.attention_flops(2, 8, 100, 300, 64, causal)


def test_autotune_dtiled_and_splitkv(tmp_path, monkeypatch):
    """JAX's test_utils case: the d-tiled tuner returns a candidate and
    round-trips through the disk cache; the split-KV tuner returns a
    SplitKVConfig that does too."""
    monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / "tune.json"))
    at._CACHE.clear()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1, 256, 256)))
               .float() for _ in range(3))
    cands = [TileConfig(block_q=128, block_kv=128,
                        d_tile_qk=128, d_tile_v=128)]
    cfg = autotune_dtiled(q, k, v, candidates=cands, iters=1)
    assert cfg in cands
    at._CACHE.clear()
    assert autotune_dtiled(q, k, v, candidates=[], iters=1) == cfg

    q2, k2, v2 = (torch.from_numpy(rng.standard_normal((1, 1, 512, 128)))
                  .float() for _ in range(3))
    scfg = autotune_splitkv(q2, k2, v2, iters=1)
    assert isinstance(scfg, SplitKVConfig)
    assert scfg.kv_span(512) % 128 == 0
    at._CACHE.clear()
    assert autotune_splitkv(q2, k2, v2, iters=1) == scfg


def test_autotune_dtiled_quantized_kv(tmp_path, monkeypatch):
    """JAX's test_utils case: quantized K/V pin block_kv to the quant
    block, and their cache entry does not collide with the bf16 one."""
    monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / "tune.json"))
    at._CACHE.clear()
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1, 256, 256)))
               .float() for _ in range(3))
    bf16_cfg = autotune_dtiled(
        q, k, v, candidates=[TileConfig(block_q=128, block_kv=128,
                                        d_tile_qk=128, d_tile_v=128)],
        iters=1)
    kq, vq = quantize_int8(k, block=256), quantize_int8(v, block=256)
    qcfg = autotune_dtiled(q, kq, vq, iters=1)
    assert qcfg.block_kv == 256
    at._CACHE.clear()
    assert autotune_dtiled(q, kq, vq, iters=1) == qcfg
    assert autotune_dtiled(q, k, v, candidates=[], iters=1) == bf16_cfg


def test_autotune_window_and_failing_candidates(tmp_path, monkeypatch):
    """autotune_window returns one of H1's Q tiles and caches it; a sweep
    whose every candidate fails raises and caches nothing."""
    monkeypatch.setattr(at, "_CACHE_PATH", str(tmp_path / "tune.json"))
    at._CACHE.clear()
    q, k, v = _t(*make_inputs(1, 2, 128, 32, seed=2))
    cfg = autotune_window(q, k, v, window=16, iters=1)
    assert h1_q_rows(cfg) in (64, 128)
    at._CACHE.clear()
    assert autotune_window(q, k, v, window=16, iters=1) == cfg
    with pytest.raises(RuntimeError, match="every candidate"):
        autotune_v1(q, k[:, :, :, :16], v, iters=1,
                    candidates=[TileConfig()])
    assert not any(key.startswith("v1|") for key in at._CACHE)


def test_time_fn_chained_calibration_positive():
    """JAX's test_utils case: the calibrated chain never differences to a
    negative time, even for a tiny op whose cost per call dwarfs its
    work."""
    x = torch.ones((8, 128), dtype=torch.float32)
    secs = time_fn_chained_windows(lambda a: a * 1.0000001 + 1e-9,
                                   x, windows=3, target_long_sec=0.05)
    assert all(s > 0 for s in secs), secs
    assert all(s < 0.1 for s in secs), secs
    assert 0 < time_fn_chained(lambda a: a + 1.0, x, n_long=8,
                               n_short=2, reps=2) < 0.1


def test_kernel_report_and_trace_on_the_cpu(tmp_path):
    """kernel_report prints JAX's table and returns its keys; trace writes
    a Chrome trace of what ran inside it."""
    q, k, v = _t(*make_inputs(1, 2, 64, 32, seed=3))
    flop = attention_flops(1, 2, 64, 64, 32)
    buf = io.StringIO()
    res = kernel_report([("v1", lambda x: flash_attention_v1(x, k, v), q,
                          flop, 4 * 2 * 64 * 32 * 4)], file=buf)
    lines = buf.getvalue().splitlines()
    assert lines[0].split() == ["kernel", "ms", "TFLOP/s", "roofline%"]
    assert lines[1].split()[0] == "v1"
    assert set(res["v1"]) == {"ms", "tflops", "roofline_pct"}
    assert res["v1"]["ms"] > 0
    with trace(str(tmp_path / "t")) as tr:
        flash_attention_v1(q, k, v)
    assert tr == str(tmp_path / "t")
    assert os.path.getsize(tr.path) > 0
    events = json.loads(open(tr.path).read())["traceEvents"]
    assert any("einsum" in str(e.get("name", "")) for e in events)


UTILS_PAIRS = [
    (at.autotune_v1, jautotune.autotune_v1, ()),
    (at.autotune_window, jautotune.autotune_window, ()),
    (at.autotune_splitkv, jautotune.autotune_splitkv, ()),
    (at.autotune_dtiled, jautotune.autotune_dtiled, ()),
    (at.default_candidates_v1, jautotune.default_candidates_v1, ()),
    (at.default_candidates_dtiled, jautotune.default_candidates_dtiled, ()),
    (benchmark.time_fn_chained, jbenchmark.time_fn_chained, ()),
    (benchmark.time_fn_chained_windows, jbenchmark.time_fn_chained_windows,
     ()),
    (benchmark.attention_flops, jbenchmark.attention_flops, ()),
    (benchmark.roofline_attention_tflops,
     jbenchmark.roofline_attention_tflops, ("peak_tflops", "hbm_gbps")),
    (profiling.roofline_tflops, jprofiling.roofline_tflops,
     ("peak_tflops", "hbm_gbps")),
    (profiling.kernel_report, jprofiling.kernel_report, ()),
    (profiling.trace, jprofiling.trace, ("logdir",)),
]


@pytest.mark.parametrize("ours,theirs,own_defaults", UTILS_PAIRS,
                         ids=[p[0].__name__ for p in UTILS_PAIRS])
def test_utils_signatures_match_jax(ours, theirs, own_defaults):
    """The port's utils take JAX's parameters in JAX's order with JAX's
    defaults, apart from the H100's peaks (JAX's are the v5e's) and the
    trace directory (under the temp dir the caller's environment names)."""
    a = inspect.signature(ours).parameters
    b = inspect.signature(theirs).parameters
    assert list(a) == list(b)
    for name in a:
        if name not in own_defaults:
            assert a[name].default == b[name].default, name
    assert benchmark.H100_PEAK_BF16_TFLOPS == 989.0
    assert benchmark.H100_HBM_GBPS == 3350.0
