"""Hand-written Hopper kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA sm_90 card and skips without one (decided
in the ``cuda_device`` fixture, never at import time, so every test worker
collects the same tests).  Run them on the card with
``python -m pytest tests/test_torch_kernels.py -m cuda``.

Tolerances (bf16 inputs, f32 accumulation on both sides):
- H1 vs plain: O to 2e-2 abs (the kernel rounds P and O to bf16, one bf16
  ulp of an O(1) value is 7.8e-3); LSE to 4e-3 (l sums P rounded to bf16,
  each term within 2^-9 relative, so ln(l) moves by at most ~2e-3).
- H2 (the split-KV combine) vs plain: 1e-5 abs on the same f32 partials
  (both merge in f32, in different orders) for f32 O; bf16 O one rounding
  more, 2^-8 of |O| plus 1e-5.
- H6-decode's own merge (its last block per sequence and KV head) vs the
  plain merge of the kernel's own partials: one bf16 ulp of max|O| (one
  rounding to bf16 of an f32 merge that differs by summation order).
- H6-decode (its split-KV partials merged in the kernel) vs plain: 5e-3 abs on O
  (P rounded to bf16 before P V, O rounded to bf16; O is an average over
  ~270 tokens, so its rounding errors stay near one bf16 ulp of |O| <
  0.5); under a window, and in H6-extend's matrix of cases, 5e-3 abs plus
  2^-7 of |O|, as for H6-extend: a window of 1 leaves one key, |O| up to
  ~4.
- H6-extend vs plain: 5e-3 abs plus 2^-7 of |O|.  Each chunk row is a
  decode row over its own causal prefix, but a row that sees only a few
  keys (a short history) has |O| up to ~3, where rounding O to bf16 alone
  moves it by up to 2^-8 of |O| (a kernel-exact emulation on the CPU
  reads 1.18e-2 at |O| = 2.24 in the ragged case, as the card does).
- H3 (H3-dkv + H3-dq) vs plain: 2e-2 of max|ref| per gradient, under
  each of the three masks.  The kernels round P and dS to bf16 before
  their products and the gradients to bf16; a CPU emulation of those
  roundings reads 3e-3..7e-3 of max|ref| at these shapes, and known-wrong
  masks (each row's diagonal key hidden; the last 64 keys dropped; the
  window one key narrower) read beyond it (``tests/test_torch_bwd.py``
  rehearses both).  On an H100, ``chip_smoke.py``'s bwd phase reads
  3.4e-3..5.7e-3 at L=1024, a ragged cross case and L=3072 (WMMA, causal).
- H4-kvq vs plain and the oracle over the dequantized K/V: 5e-4 abs on f32
  O (P rounded to fp16 as p * v_scale / vmax, vmax the largest V scale of
  each 128-key tile; a CPU emulation of those roundings reads <= 8.1e-5,
  ``tests/test_torch_quant.py``).
- H4-int8 vs plain (B18's function, which the plain version reproduces):
  1e-3 abs in either ``pv_mode`` (summation order and a rare flip of a P
  rounding); vs the oracle 1.5e-3 (``pv_mode`` bf16) and 3e-2 (int8, at
  the JAX test's shape), and never further than the plain version plus
  1e-3.
- f32 inputs (H1's f32 kernel, bf16x6 on wgmma; H6-extend's, bf16x3
  against the exact codes; H6-decode's f32 instances, f32 FMA): H1 within 1e-5 of an f64
  run of the plain version at bench/suite.py's referee row (B=2, H=4,
  L=256, d=128) and 2e-5 at d 1-512 on a group of 16 (the JAX package's
  f32 tiers, ``tests/test_attention_v1.py:24-27``), V2 within 1e-4, the
  paged pair within 1e-5 of their plain f32 versions; H3-dkv and H3-dq
  (bf16x6 on wgmma, d up to 128) within 1e-4 of max|ref| per gradient of
  the plain f32 backward.  Each beside the same inputs rounded to bf16
  through the bf16 kernel, which must read beyond the limit
  (``tests/test_torch_f32.py`` and ``tests/test_torch_bwd_f32.py``
  rehearse both on the CPU).  H4-kvq with f32 q and H5 with f32 inputs
  (bf16x3 against the codes, bf16x6 on f32 K/V) within 2e-5 of an f64 run
  of the plain version and of the plain f32 version, the JAX tests' tier
  (``tests/test_torch_f32_ops.py`` rehearses both).
- H5 vs plain and the oracle: 4e-3 abs on f32 O (p * v_scale rounded to
  bf16 per 64-key tile, as B19 does; a CPU emulation reads <= 9.5e-4 on a
  head or two, ``tests/test_torch_dtiled.py``, an H100 1.32e-3 over 32
  heads), at d 16 to 2048 (past 512, f32 past 256, a cluster of blocks
  that split d's chunks).  Two H5 runs are bitwise equal: one warpgroup
  sums S over the block's d-chunks in a fixed order, and a cluster adds
  its ranks' partials in rank order.
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu_torch import SplitKVConfig, TileConfig
from exploring_flash_attention_tpu_torch.graphs import StepGraph
from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    ModelConfig,
    Seq2SeqConfig,
    SpeculativeEngine,
    init_params,
    init_seq2seq_params,
    make_mlm_train_step,
    make_seq2seq_train_step,
    make_train_step,
    make_trainable,
    mask_tokens,
    seq2seq_loss,
    tree_leaves,
    tree_map,
)
from exploring_flash_attention_tpu_torch.models import seq2seq as s2s
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.ops.attention import (
    H5_HEAD_DIM_RULE,
    NARROW_HEAD_DIM_RULE,
    SERVING_HEAD_DIM_RULE,
    attention_partial_local,
    attention_plain,
    flash_attention,
    prefill_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
    flash_attention_v1,
    flash_attention_v1_window_partial,
    split_kv_span,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial,
    flash_attention_v2,
    splitkv_combine,
    splitkv_combine_plain,
)
from exploring_flash_attention_tpu_torch.ops import (
    QuantizedTensor,
    attention_dtiled_plain,
    attention_int8_plain,
    attention_kvquant_plain,
    dequantize,
    flash_attention_int8,
    flash_attention_kvquant,
    flash_attention_v1_dtiled,
    quantize_fp8,
    quantize_int8,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    attention_bwd_dkv,
    attention_bwd_dq,
    attention_bwd_plain,
    flash_attention_bwd,
)
from exploring_flash_attention_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    Request,
    append_chunks,
    append_prompts,
    decode_split,
    gather_kv,
    make_cache,
    paged_decode_attention,
    paged_decode_partials,
    paged_decode_partials_plain,
    paged_decode_plain,
    paged_extend_attention,
    paged_extend_plain,
    reserve_tickets,
    ticket_buffer,
)
from exploring_flash_attention_tpu_torch.serving.scheduler import _fused_step
from exploring_flash_attention_tpu_torch.utils.profile_generate import (
    eager_generate,
)

pytestmark = pytest.mark.cuda

O_TOL = 2e-2
LSE_TOL = 4e-3
DECODE_O_TOL = 5e-3
EXTEND_O_TOL = 5e-3
BWD_REL_TOL = 2e-2
H2_O_TOL = 1e-5
KVQ_O_TOL = 5e-4
INT8_PLAIN_TOL = 1e-3
INT8_ORACLE_TOL = {"bf16": 1.5e-3, "int8": 3e-2}
DTILED_O_TOL = 4e-3
QUANT = {"int8": quantize_int8, "fp8": quantize_fp8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; none is visible")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _qkv(dev, b, hq, hkv, lq, lkv, d, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dev, torch.bfloat16)  # noqa: E731
    return mk(b, hq, lq, d), mk(b, hkv, lkv, d), mk(b, hkv, lkv, d)


@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d", [
    (8, 8, 4, 256, 256, 128),     # the generation slice's prefill
    (2, 8, 4, 200, 216, 128),     # ragged, Lq != Lkv
    (2, 4, 2, 17, 17, 64),        # ragged below one tile, d=64
    (1, 4, 4, 80, 48, 128),       # Lq > Lkv: 32 rows see no key
])
def test_prefill_kernel_matches_plain_and_oracle(cuda_device, b, hq, hkv,
                                                 lq, lkv, d):
    q, k, v = _qkv(cuda_device, b, hq, hkv, lq, lkv, d)
    scale = 1.0 / math.sqrt(d)
    o, lse = prefill_attention(q, k, v, scale, lkv - lq)
    torch.cuda.synchronize()
    o_ref, lse_ref = attention_plain(q, k, v, scale, True, lkv - lq)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert (o.float() - o_ref).abs().max().item() < O_TOL
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_ref[fin]).abs().max().item() < LSE_TOL
    group = hq // hkv
    oracle = naive_attention(q, k.repeat_interleave(group, 1),
                             v.repeat_interleave(group, 1), causal=True)
    assert np.abs(o.float().cpu().numpy() - oracle).max() < O_TOL


def test_prefill_kernel_counts_launches_and_refuses_f16(cuda_device):
    """bf16 and f32 each run one launch (f32 on the f32 kernel, O f32);
    f16 and f64 raise before any launch."""
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 64)
    before = prefill_attention.launches
    prefill_attention(q, k, v, 0.125, 0)
    assert prefill_attention.launches == before + 1
    o, _ = prefill_attention(q.float(), k.float(), v.float(), 0.125, 0)
    assert o.dtype == torch.float32
    assert prefill_attention.launches == before + 2
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bf16 or f32"):
            prefill_attention(q.to(dt), k.to(dt), v.to(dt), 0.125, 0)
    assert prefill_attention.launches == before + 2


# head dims of the rule (ops.attention.kernel_head_dim) on every instance of
# H1 (32, 64, 128, 256): the instances' own, and d below them on
# zero-filled columns (16, 48, 80, 96, 144; 144 leaves a whole 64-column
# box of the D=256 instance past d); then d whose rows are no multiple of
# 16 bytes: by TMA at 8, 40, 72 and 104 (rows a multiple of 8 columns),
# by the staged producer at 1 (scale 1, 31 zero columns on D=32), 33 and
# 255 (rows 2-byte aligned), 36 and 100 (8-byte), 250 (4-byte)
HEAD_DIMS = [16, 32, 48, 64, 80, 96, 128, 144, 256,
             1, 8, 33, 36, 40, 72, 100, 104, 250, 255]
# the same beyond the multiples of 16, for the forms each d runs through
ODD_DIMS = [1, 33, 36, 72, 250]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mode", ["none", "causal", "window"])
def test_h1_modes_match_plain_and_oracle(cuda_device, mode, d):
    """Each mask at each head dim, ragged and cross (Lq=200, Lkv=330), GQA
    4/2, through ``flash_attention_v1``: one launch, bf16 O."""
    b, hq, hkv, lq, lkv = 2, 4, 2, 200, 330
    causal, window = mode != "none", 100 if mode == "window" else None
    q, k, v = _qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=8)
    before = prefill_attention.launches
    o = flash_attention_v1(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    o_ref, _ = attention_plain(q, k, v, 1.0 / math.sqrt(d), causal,
                               lkv - lq, window)
    assert (o.float() - o_ref).abs().max().item() < O_TOL
    oracle = naive_attention(q, k.repeat_interleave(2, 1),
                             v.repeat_interleave(2, 1), causal=causal,
                             window=window)
    assert np.abs(o.float().cpu().numpy() - oracle).max() < O_TOL


# past 256 (bf16): H1 on H5's block of d-chunks (3 at d 257-384, 4 at
# 385-512), rows by TMA (264, 384, 512) or by the staged producer (257 and
# 385 2-byte aligned, 300 8-byte)
WIDE_DIMS = [257, 264, 300, 384, 385, 512]


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("mode", ["none", "causal", "window"])
def test_h1_wide_head_dims_match_plain_and_oracle(cuda_device, mode, d):
    """H1 past 256 under each mask, ragged and cross (Lq=200, Lkv=330),
    GQA 4/2, a window band crossing its 64-key tiles: through
    ``flash_attention_v1`` (one launch, bf16 O) against the plain version
    and the f64 oracle (O_TOL), and with the LSE and f32 O (LSE_TOL)."""
    b, hq, hkv, lq, lkv = 2, 4, 2, 200, 330
    causal, window = mode != "none", 100 if mode == "window" else None
    q, k, v = _qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=9)
    scale = 1.0 / math.sqrt(d)
    before = prefill_attention.launches
    o = flash_attention_v1(q, k, v, causal=causal, window=window)
    o32, lse = prefill_attention(q, k, v, scale, lkv - lq, causal, window,
                                 out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 2
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    o_ref, lse_ref = attention_plain(q, k, v, scale, causal, lkv - lq,
                                     window)
    assert (o.float() - o_ref).abs().max().item() < O_TOL
    assert (o32 - o_ref).abs().max().item() < O_TOL
    assert torch.equal(o32.bfloat16(), o)     # one rounding of one sum
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_ref[fin]).abs().max().item() < LSE_TOL
    oracle = naive_attention(q, k.repeat_interleave(2, 1),
                             v.repeat_interleave(2, 1), causal=causal,
                             window=window)
    assert np.abs(o32.cpu().numpy() - oracle).max() < O_TOL


@pytest.mark.parametrize("d", [264, 300, 512])
@pytest.mark.parametrize("mode", ["none", "causal", "window"])
def test_h1_wide_forms_match_plain(cuda_device, mode, d):
    """H1's forms past 256: the bound statistic against its plain version
    (O_TOL on f32 O), the 64-row and 128-row Q tiles bitwise equal (both
    run 64-row tiles there), and the KV-span mode (spans of 256 keys, the
    last ragged) against the plain version over each span, one launch
    each."""
    b, hq, hkv, lq, lkv = 1, 4, 2, 200, 700
    causal, window = mode != "none", 100 if mode == "window" else None
    q, k, v = _qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=10)
    scale = 1.0 / math.sqrt(d)
    before = prefill_attention.launches
    ob, _ = prefill_attention(q, k, v, scale, lkv - lq, causal, window,
                              out_dtype=torch.float32, softmax="bound")
    o64 = prefill_attention(q, k, v, scale, lkv - lq, causal, window,
                            q_rows=64)
    o128 = prefill_attention(q, k, v, scale, lkv - lq, causal, window)
    os_, lses = prefill_attention(q, k, v, scale, lkv - lq, causal,
                                  out_dtype=torch.float32, kv_span=256)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 4
    ref, _ = _bound_plain(q, k, v, scale, causal, lkv - lq, window)
    assert (ob - ref).abs().max().item() < O_TOL
    assert all(torch.equal(a, c) for a, c in zip(o64, o128))
    ro, rl = prefill_attention(q.cpu(), k.cpu(), v.cpu(), scale, lkv - lq,
                               causal, out_dtype=torch.float32, kv_span=256)
    assert (os_.cpu() - ro).abs().max().item() < O_TOL
    fin = torch.isfinite(rl)
    assert torch.equal(torch.isfinite(lses.cpu()), fin)
    assert (lses.cpu()[fin] - rl[fin]).abs().max().item() < LSE_TOL


def _bound_plain(q, k, v, scale, causal, diag_off, window=None):
    from exploring_flash_attention_tpu_torch.ops.attention import (
        bound_kmax,
        bound_shift,
    )
    shift = bound_shift(q, bound_kmax(k), scale, causal, diag_off)
    return attention_plain(q, k, v, scale, causal, diag_off, window, shift)


@pytest.mark.parametrize("d", [32, 64, 80, 128, 256] + ODD_DIMS)
@pytest.mark.parametrize("mode", ["none", "causal", "window"])
@pytest.mark.parametrize("block_q", [64, 128])
def test_h1_bound_matches_plain_and_oracle(cuda_device, mode, d, block_q):
    """H1's bound form (``TileConfig(softmax="bound")``) under each mask at
    each head dim and both Q tiles, ragged and cross (Lq=200, Lkv=330),
    GQA 4/2: one H1 launch, f32 O and LSE against the plain bound version
    (O_TOL, LSE_TOL) and O against the f64 oracle."""
    b, hq, hkv, lq, lkv = 2, 4, 2, 200, 330
    causal, window = mode != "none", 100 if mode == "window" else None
    q, k, v = _qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=21)
    scale = 1.0 / math.sqrt(d)
    before = prefill_attention.launches
    o, lse = prefill_attention(q, k, v, scale, lkv - lq, causal, window,
                               out_dtype=torch.float32,
                               q_rows=64 if block_q == 64 else 128,
                               softmax="bound")
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    o_ref, lse_ref = _bound_plain(q, k, v, scale, causal, lkv - lq, window)
    assert (o - o_ref).abs().max().item() < O_TOL
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_ref[fin]).abs().max().item() < LSE_TOL
    oracle = naive_attention(q, k.repeat_interleave(2, 1),
                             v.repeat_interleave(2, 1), causal=causal,
                             window=window)
    assert np.abs(o.cpu().numpy() - oracle).max() < O_TOL
    o_v1 = flash_attention_v1(q, k, v, TileConfig(block_q=block_q,
                                                  softmax="bound"),
                              causal=causal, window=window,
                              out_dtype=torch.float32)
    assert torch.equal(o_v1, o)


@pytest.mark.parametrize("causal,positions", [
    (False, (0, 0)), (True, (100, 0)), (True, (1024, 512)),
    (True, (0, 700))])
def test_h1_bound_traced_positions_equal_static(cuda_device, causal,
                                                positions):
    """The bound form at traced positions (a device pair) is bitwise the
    static launch, over one span and over 128-key spans; a call whose
    rows see no key gives (0, -inf)."""
    q, k, v = _qkv(cuda_device, 2, 8, 4, 256, 640, 128, seed=22)
    scale = 1.0 / math.sqrt(128)
    pair = torch.tensor(positions, dtype=torch.int32, device=cuda_device)
    diag = positions[0] - positions[1]
    for span in (None, 256):
        static = prefill_attention(q, k, v, scale, diag, causal,
                                   out_dtype=torch.float32, kv_span=span,
                                   softmax="bound")
        traced = prefill_attention(q, k, v, scale, pair if causal else 0,
                                   causal, out_dtype=torch.float32,
                                   kv_span=span, softmax="bound")
        assert all(torch.equal(a, b) for a, b in zip(static, traced))
    if causal and diag < -q.shape[2]:
        assert (static[0] == 0).all() and torch.isneginf(static[1]).all()


@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d,causal,window", [
    (1, 8, 8, 1024, 1024, 128, True, None),
    (2, 8, 4, 200, 330, 64, False, None),
    (2, 4, 2, 333, 333, 32, True, 100),
    (1, 8, 4, 1024, 8192, 128, False, None),
    (1, 16, 1, 333, 600, 256, True, 100),
    (1, 16, 1, 333, 600, 80, False, None),
])
def test_h1_q_tile_64_is_bitwise_the_128_tile(cuda_device, b, hq, hkv, lq,
                                              lkv, d, causal, window):
    """The 64-row Q tile (one consumer warpgroup, 256 threads) gives O and
    the LSE of the 128-row tile bitwise, exact and bound: each row meets
    the same K/V tiles in the same order, and a tile wholly masked for a
    row adds p = 0 at alpha = 1."""
    q, k, v = _qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=23)
    scale = 1.0 / math.sqrt(d)
    for softmax in ("exact", "bound"):
        got = [prefill_attention(q, k, v, scale, lkv - lq, causal, window,
                                 out_dtype=torch.float32, q_rows=rows,
                                 softmax=softmax) for rows in (64, 128)]
        assert torch.equal(got[0][0], got[1][0])
        assert torch.equal(got[0][1], got[1][1])


def test_h1_bound_causal_rows_keep_their_bits_when_kv_grows(cuda_device):
    """Causal bound outputs are bitwise unchanged when q and K/V grow by a
    whole 128-key tile, at both Q tiles."""
    q, k, v = _qkv(cuda_device, 2, 8, 4, 640, 640, 128, seed=24)
    for block_q in (64, 128):
        cfg = TileConfig(block_q=block_q, softmax="bound")
        short = flash_attention_v1(*(x[:, :, :512].contiguous()
                                     for x in (q, k, v)), cfg, causal=True)
        grown = flash_attention_v1(q, k, v, cfg, causal=True)
        assert torch.equal(grown[:, :, :512], short)


def test_h1_window_suffix_band_gives_merge_identity(cuda_device):
    """The window partial with the rows past the KV span (``row_off`` =
    Lq): f32 O and LSE against the plain version; rows whose band misses
    every key give (0, -inf)."""
    lq, lkv, window = 128, 256, 100
    q, k, v = _qkv(cuda_device, 1, 8, 4, lq, lkv, 128, seed=9)
    o, lse = flash_attention_v1_window_partial(q, k, v, window, row_off=lq)
    torch.cuda.synchronize()
    o_ref, lse_ref = attention_plain(q, k, v, 1.0 / math.sqrt(128), True,
                                     lkv, window)
    assert o.dtype == torch.float32
    blind = torch.isneginf(lse_ref)
    assert blind.any() and torch.equal(torch.isneginf(lse), blind)
    assert (o[blind] == 0).all()
    assert (o - o_ref).abs().max().item() < O_TOL
    assert (lse[~blind] - lse_ref[~blind]).abs().max().item() < LSE_TOL


def test_partial_returns_f32_o_written_by_h1(cuda_device):
    """``attention_partial_local`` gets O from H1 in f32, not bf16 cast up:
    O is not bf16-representable everywhere, and its largest error against
    the f64 oracle stays below half a bf16 ulp at max|O| (rounding O to
    bf16 alone could cost that much)."""
    q, k, v = _qkv(cuda_device, 2, 8, 4, 512, 512, 128, seed=10)
    o, lse = attention_partial_local(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert not torch.equal(o, o.bfloat16().float())
    oracle = naive_attention(q, k.repeat_interleave(2, 1),
                             v.repeat_interleave(2, 1), causal=True)
    half_ulp = 2.0 ** (np.floor(np.log2(np.abs(oracle).max())) - 8)
    assert np.abs(o.cpu().numpy() - oracle).max() < half_ulp


def test_h1_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 513)
    before = prefill_attention.launches
    with pytest.raises(ValueError, match=re.escape(SERVING_HEAD_DIM_RULE)):
        flash_attention_v1(q, k, v)
    # f32 takes SERVING_HEAD_DIM_RULE too: d=300 launches H1, 513 raises
    q, k, v = (x.float() for x in _qkv(cuda_device, 1, 2, 2, 64, 64, 300))
    assert flash_attention_v1(q, k, v).dtype == torch.float32
    q, k, v = (x.float() for x in _qkv(cuda_device, 1, 2, 2, 64, 64, 513))
    with pytest.raises(ValueError, match=re.escape(SERVING_HEAD_DIM_RULE)):
        flash_attention_v1(q, k, v)
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 64)
    with pytest.raises(TypeError, match="bf16"):
        flash_attention_v1(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="f32"):
        flash_attention_v1(q, k, v, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="multiple of 128"):
        prefill_attention(q, k, v, 0.125, 0, kv_span=64)   # half a K/V tile
    assert prefill_attention.launches == before + 1


@pytest.mark.parametrize("causal,lq,lkv,span,d", [
    (False, 200, 1000, 256, 128),  # 4 spans, the last ragged (232 keys)
    (True, 512, 512, 128, 128),    # spans past a row's diagonal: (0, -inf)
    (False, 200, 1000, 384, 128),  # spans of three 128-key tiles
    (True, 1000, 1000, 384, 128),  # causal, the last span 232 keys
    # the D=256 instance's 64-key tiles, two a span tile; d=80 on D=128
    (True, 1000, 1000, 384, 256),
    (False, 200, 1000, 256, 256),
    (True, 1000, 1000, 384, 80),
    (False, 200, 1000, 256, 16),
    # rows by TMA at d=72, by the staged producer at 33 and 250
    (True, 1000, 1000, 384, 72),
    (False, 200, 1000, 256, 33),
    (True, 1000, 1000, 256, 250),
])
def test_h1_span_partials_match_plain(cuda_device, causal, lq, lkv, span,
                                      d):
    """H1's span mode: one launch writes every span's f32 O and LSE, as
    the plain version over each span computes them."""
    q, k, v = _qkv(cuda_device, 1, 4, 2, lq, lkv, d, seed=11)
    scale = 1.0 / math.sqrt(d)
    before = prefill_attention.launches
    o, lse = prefill_attention(q, k, v, scale, lkv - lq, causal,
                               out_dtype=torch.float32, kv_span=span)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    o_ref, lse_ref = prefill_attention(q.cpu(), k.cpu(), v.cpu(), scale,
                                       lkv - lq, causal,
                                       out_dtype=torch.float32, kv_span=span)
    nkb = -(-lkv // span)
    assert o.shape == (1, 4, nkb, lq, d) and lse.shape == (1, 4, nkb, lq)
    assert (o.cpu() - o_ref).abs().max().item() < O_TOL
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse.cpu()), fin)
    assert (lse.cpu()[fin] - lse_ref[fin]).abs().max().item() < LSE_TOL
    if causal:
        assert not fin.all() and (o.cpu()[~fin] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("lq,lkv", [
    (127, 127), (128, 128), (129, 129), (257, 257), (127, 257), (257, 129),
])
def test_h1_ragged_edges_of_128_tiles(cuda_device, lq, lkv, d, causal):
    """Lq and Lkv at and around H1's 128-row Q tile and 128-key K/V tile:
    the TMA box past a head's end is zero-filled and the columns past Lkv
    are masked in registers.  GQA 4/2, f32 O and LSE against the plain
    version, O against the f64 oracle."""
    q, k, v = _qkv(cuda_device, 2, 4, 2, lq, lkv, d, seed=30)
    scale = 1.0 / math.sqrt(d)
    o, lse = prefill_attention(q, k, v, scale, lkv - lq, causal,
                               out_dtype=torch.float32)
    torch.cuda.synchronize()
    o_ref, lse_ref = attention_plain(q, k, v, scale, causal, lkv - lq)
    assert (o - o_ref).abs().max().item() < O_TOL
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_ref[fin]).abs().max().item() < LSE_TOL
    oracle = naive_attention(q, k.repeat_interleave(2, 1),
                             v.repeat_interleave(2, 1), causal=causal)
    assert np.abs(o.cpu().numpy() - oracle).max() < O_TOL


@pytest.mark.parametrize("lq,lkv,window", [
    (512, 512, 100),       # band edges inside every 128-key tile
    (300, 700, 129),       # one key wider than a tile, cross
    (256, 256, 127),       # one key narrower than a tile
])
def test_h1_window_band_crosses_kv_tiles(cuda_device, lq, lkv, window):
    """A sliding window whose band edges cross 128-key tiles: the tiles
    outside every row's band are skipped, the edges masked per row."""
    q, k, v = _qkv(cuda_device, 1, 8, 4, lq, lkv, 128, seed=31)
    before = prefill_attention.launches
    o = flash_attention_v1(q, k, v, causal=True, window=window,
                           out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    o_ref, _ = attention_plain(q, k, v, 1.0 / math.sqrt(128), True,
                               lkv - lq, window)
    assert (o - o_ref).abs().max().item() < O_TOL
    oracle = naive_attention(q, k.repeat_interleave(2, 1),
                             v.repeat_interleave(2, 1), causal=True,
                             window=window)
    assert np.abs(o.cpu().numpy() - oracle).max() < O_TOL


def test_h2_combine_matches_plain_and_counts(cuda_device):
    g = torch.Generator().manual_seed(12)
    o_p = torch.randn(2, 4, 5, 300, 64, generator=g)
    lse = 3 * torch.randn(2, 4, 5, 300, generator=g)
    o_p[:, :, 2, :50] = 0
    lse[:, :, 2, :50] = float("-inf")     # a span that saw nothing
    o_p[0, 0, :, 7] = 0
    lse[0, 0, :, 7] = float("-inf")       # a row that saw nothing at all
    ref = splitkv_combine_plain(o_p, lse)
    o_p, lse = o_p.to(cuda_device), lse.to(cuda_device)
    before = splitkv_combine.launches
    got = splitkv_combine(o_p, lse)
    got16 = splitkv_combine(o_p, lse, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert splitkv_combine.launches == before + 2
    assert got.dtype == torch.float32 and got16.dtype == torch.bfloat16
    assert (got.cpu() - ref).abs().max().item() < H2_O_TOL
    assert ((got16.float().cpu() - ref).abs()
            <= H2_O_TOL + 2 ** -8 * ref.abs()).all()
    assert (got[0, 0, 7] == 0).all()
    with pytest.raises(TypeError, match="f32"):
        splitkv_combine(o_p.bfloat16(), lse)
    assert splitkv_combine.launches == before + 2


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nkb", [1, 2, 3, 33])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 128, 144, 256, 1, 8, 33,
                               36, 40, 72, 100, 250, 257, 264, 300, 384,
                               385, 512])
def test_h2_row_layouts_match_plain(cuda_device, d, nkb, out_dtype):
    """H2 at each row layout (a row is d / 4 lanes: 4, 2 or 1 rows a warp;
    at d 16, 48 and 80 the next power of two of lanes, some idle; at d
    144 and 256 two 16-byte chunks a lane, past 256 three or four; a d
    off the multiples of 16 on
    its lanes' instance with d read at run time, 16-byte loads at d % 4 ==
    0, else a float at a time) and partial count (one; a few;
    33, more than a row's lanes at every d),
    f32 and bf16 O, over 2 x 3 x 37 = 222 rows, no multiple of a block's
    16, 8 or 4 rows, against its plain version: a span that saw nothing
    weighs 0, a row whose partials are all (0, -inf) gives 0."""
    g = torch.Generator().manual_seed(40 + d + nkb)
    o_p = torch.randn(2, 3, nkb, 37, d, generator=g)
    lse = 3 * torch.randn(2, 3, nkb, 37, generator=g)
    o_p[:, :, -1, :9] = 0
    lse[:, :, -1, :9] = float("-inf")     # the last span saw nothing
    o_p[1, 2, :, 36] = 0
    lse[1, 2, :, 36] = float("-inf")      # the last row saw nothing at all
    ref = splitkv_combine_plain(o_p, lse)
    before = splitkv_combine.launches
    got = splitkv_combine(o_p.to(cuda_device), lse.to(cuda_device),
                          out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert splitkv_combine.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (2, 3, 37, d)
    err = (got.float().cpu() - ref).abs()
    if out_dtype == torch.float32:
        assert err.max().item() < H2_O_TOL
    else:
        assert (err <= H2_O_TOL + 2 ** -8 * ref.abs()).all()
    assert (got[1, 2, 36] == 0).all()


def test_flash_attention_v1_long_kv_runs_h1_spans_and_h2(cuda_device):
    """A long non-causal KV over few Q tiles: one H1 launch over 8 spans
    of 512 keys and one H2 launch, against the plain version and the
    oracle."""
    lq, lkv = 128, 4096
    assert split_kv_span(1, 4, lq, lkv) == 512
    q, k, v = _qkv(cuda_device, 1, 4, 2, lq, lkv, 128, seed=13)
    before = (prefill_attention.launches, splitkv_combine.launches)
    o = flash_attention_v1(q, k, v)
    torch.cuda.synchronize()
    assert (prefill_attention.launches, splitkv_combine.launches) == (
        before[0] + 1, before[1] + 1)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    o_ref, _ = attention_plain(q, k, v, 1.0 / math.sqrt(128), False)
    assert (o.float() - o_ref).abs().max().item() < O_TOL
    oracle = naive_attention(q, k.repeat_interleave(2, 1),
                             v.repeat_interleave(2, 1))
    assert np.abs(o.float().cpu().numpy() - oracle).max() < O_TOL


@pytest.mark.parametrize("hq,hkv,d", [(8, 4, 128), (8, 2, 64)])
def test_decode_kernel_matches_plain_and_oracle(cuda_device, hq, hkv, d):
    b, ps = 8, 128
    lens = [257 + 3 * i for i in range(b)]                 # 257 .. 278
    max_pages = 4
    cache = make_cache(hkv, d, b * max_pages, page_size=ps, max_seqs=b,
                       max_pages_per_seq=max_pages, device=cuda_device)
    perm = torch.randperm(b * max_pages,
                          generator=torch.Generator().manual_seed(0))
    cache.page_table.copy_(perm.view(b, max_pages).to(torch.int32))
    g = torch.Generator().manual_seed(1)
    slots = torch.arange(b, dtype=torch.int32, device=cuda_device)
    for s, n in enumerate(lens):
        kp = torch.randn(1, n, hkv, d, generator=g).to(cuda_device)
        vp = torch.randn(1, n, hkv, d, generator=g).to(cuda_device)
        append_prompts(cache, slots[s:s + 1], kp, vp)
    q = torch.randn(b, hq, d, generator=g).to(cuda_device, torch.bfloat16)
    before = (paged_decode_partials.launches, splitkv_combine.launches)
    o = paged_decode_attention(q, cache, slots)
    torch.cuda.synchronize()
    assert (paged_decode_partials.launches,
            splitkv_combine.launches) == (before[0] + 1, before[1])
    ref = paged_decode_plain(q, cache, slots, 1.0 / math.sqrt(d))
    assert o.dtype == torch.bfloat16 and o.shape == (b, hq, d)
    assert (o.float() - ref).abs().max().item() < DECODE_O_TOL
    for s in range(b):
        kf, vf = gather_kv(cache, s)
        oracle = naive_attention(q[s].view(hkv, hq // hkv, d), kf, vf)
        got = o[s].float().view(hkv, hq // hkv, d).cpu().numpy()
        assert np.abs(got - oracle).max() < DECODE_O_TOL


def _paged_case(dev, hq, hkv, d, ps, lens, c=0, seed=3, max_pages=None):
    """Ragged histories ``lens`` (0 for an empty sequence) through
    append_prompts in a permuted page table of ``max_pages`` pages a slot
    (by default one more than the longest sequence takes), then, with
    ``c``, one C-token chunk through append_chunks; the rows past each
    sequence's end in its last page then get old codes and scales, as a
    freed and reused page holds.  Returns (cache, bf16 q [B, Hq, d] or [B,
    C, Hq, d], slots)."""
    b = len(lens)
    max_pages = max_pages or -(-(max(lens) + c) // ps) + 1
    cache = make_cache(hkv, d, b * max_pages, page_size=ps, max_seqs=b,
                       max_pages_per_seq=max_pages, device=dev)
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(b * max_pages, generator=g)
    cache.page_table.copy_(perm.view(b, max_pages).to(torch.int32))
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    for s, n in enumerate(lens):
        if n:
            append_prompts(cache, slots[s:s + 1],
                           torch.randn(1, n, hkv, d, generator=g).to(dev),
                           torch.randn(1, n, hkv, d, generator=g).to(dev))
    if c:
        append_chunks(cache, slots,
                      torch.randn(b, c, hkv, d, generator=g).to(dev),
                      torch.randn(b, c, hkv, d, generator=g).to(dev))
    for s, n in enumerate(lens):
        end = n + c
        page = int(cache.page_table[s, end // ps])
        off = end % ps
        cache.kv_pages[page, :, :, off:] = torch.randint(
            -127, 128, cache.kv_pages[page, :, :, off:].shape,
            generator=g).to(dev, torch.int8)
        cache.kv_scales[page, :, :, :, off:] = 1e3
    shape = (b, c, hq, d) if c else (b, hq, d)
    return cache, torch.randn(*shape, generator=g).to(dev, torch.bfloat16), \
        slots


def _paged_close(got, ref):
    """5e-3 abs plus 2^-7 of |O|: P * v_scale and O rounded to bf16; a row
    that sees a key or two (a window of 1, a short history) has |O| up to
    ~4, where rounding O alone moves it by up to 2^-9 of |O|."""
    err = (got.float() - ref.float()).abs()
    return bool((err <= DECODE_O_TOL + 2 ** -7 * ref.float().abs()).all())


DECODE_LENS = [0, 1, 127, 128, 129, 300, 700, 1000]


@pytest.mark.parametrize("window", [None, 1, 100, 300])
@pytest.mark.parametrize("ps", [128, 256])
@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (8, 4, 128), (8, 1, 64),
                                      (6, 2, 64)])
def test_decode_kernel_masks_pages_groups(cuda_device, hq, hkv, d, ps,
                                          window):
    """H6-decode (one launch, its merge inside) against the plain version
    and the f64 oracle over each sequence's band of the gathered cache:
    every mask, page sizes 128 and 256, d 64 and 128, groups 1, 2, 8 and
    3, ragged lengths around the 128-token tiles and pages, an empty
    sequence (zeros), a reused page with old codes past each tail, and a
    row whose slot is -1 (zeros)."""
    cache, q, slots = _paged_case(cuda_device, hq, hkv, d, ps, DECODE_LENS)
    scale = 1.0 / math.sqrt(d)
    o = paged_decode_attention(q, cache, slots, window=window)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    ref = paged_decode_plain(q, cache, slots, scale, window)
    assert _paged_close(o, ref)
    assert (o[0] == 0).all()                               # empty sequence
    g = hq // hkv
    for s, n in enumerate(DECODE_LENS):
        if not n:
            continue
        kf, vf = gather_kv(cache, s)
        lo = max(0, n - window) if window else 0
        oracle = naive_attention(q[s].view(hkv, g, d), kf[:, lo:],
                                 vf[:, lo:])
        assert _paged_close(o[s].float().view(hkv, g, d).cpu(),
                            torch.from_numpy(oracle)), s
    bad = slots.clone()
    bad[3] = -1
    o_bad = paged_decode_attention(q, cache, bad, window=window)
    assert (o_bad[3] == 0).all()
    assert torch.equal(o_bad[4:], o[4:])


@pytest.mark.parametrize("window", [None, 100])
def test_decode_kernel_partials_and_reruns(cuda_device, window):
    """H6-decode's partials against their plain version, run by run (f32
    O to 5e-3 + 2^-7 |O|, LSE to 4e-3), runs past a sequence's band the
    merge identity (0, -inf) exactly, and two runs bitwise equal."""
    cache, q, slots = _paged_case(cuda_device, 8, 4, 128, 128, DECODE_LENS)
    scale = 1.0 / math.sqrt(128)
    o, lse = paged_decode_partials(q, cache, slots, scale, window)
    o2, lse2 = paged_decode_partials(q, cache, slots, scale, window)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    n_split, per = decode_split(cache, len(DECODE_LENS), window,
                                torch.cuda.get_device_properties(0)
                                .multi_processor_count)
    o_ref, lse_ref = paged_decode_partials_plain(q, cache, slots, scale,
                                                 window, n_split, per)
    assert o.shape == o_ref.shape and lse.shape == lse_ref.shape
    assert _paged_close(o, o_ref)
    empty = torch.isneginf(lse_ref)
    assert torch.equal(torch.isneginf(lse), empty)
    assert (o[empty] == 0).all()
    assert (lse[~empty] - lse_ref[~empty]).abs().max().item() < LSE_TOL


def test_decode_kernel_refuses_what_it_cannot_take(cuda_device):
    cache, q, slots = _paged_case(cuda_device, 8, 4, 128, 128, [5, 9])
    for bad in (dict(window=0), dict(q=q.half())):
        before = paged_decode_partials.launches
        with pytest.raises((ValueError, TypeError)):
            paged_decode_attention(bad.get("q", q), cache, slots,
                                   window=bad.get("window"))
        assert paged_decode_partials.launches == before
    odd, q64, s64 = _paged_case(cuda_device, 8, 4, 128, 128, [5, 9])
    odd.page_size = 64
    with pytest.raises(ValueError, match="page sizes"):
        paged_decode_attention(q64, odd, s64)


@pytest.mark.parametrize("d", [0, 72, 513])
def test_kernels_refuse_head_dims_outside_the_rule(cuda_device, d):
    """H1, H2, H6-decode and H6-extend raise ``ValueError`` naming their
    rule (``SERVING_HEAD_DIM_RULE``, d from 1 to 512) for d 0 and 513, and
    H3-dkv and H3-dq naming theirs (``NARROW_HEAD_DIM_RULE``, d from 1 to
    256), on CUDA tensors, and launch nothing; at d=72, which they take,
    so do H4-kvq and H4-int8, which launch once each there (their PACKED
    instances), while H4-int8 refuses d 0 and 257 and the quantized-KV op
    d 0 and 2049, naming ``NARROW_HEAD_DIM_RULE`` and launching nothing."""
    counted = (prefill_attention, splitkv_combine, paged_decode_partials,
               paged_extend_attention, attention_bwd_dkv, attention_bwd_dq,
               flash_attention_kvquant, flash_attention_int8)
    before = [fn.launches for fn in counted]
    q, k, v = _qkv(cuda_device, 1, 4, 2, 64, 64, d)
    lse = torch.zeros(1, 4, 64, device=cuda_device)
    if d == 72:
        q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, d)     # H4: no GQA
        kq, vq = quantize_int8(k, 64), quantize_int8(v, 64)
        flash_attention_kvquant(q, kq, vq)
        flash_attention_int8(quantize_int8(q, 64), kq, vq)
        torch.cuda.synchronize()
        assert [fn.launches for fn in counted] == before[:6] + [
            before[6] + 1, before[7] + 1]
        rule = re.escape(NARROW_HEAD_DIM_RULE)
        for bad in (0, 257, 2049):
            q, k, v = _qkv(cuda_device, 1, 1, 1, 64, 64, bad)
            # (no quantizer takes a row of no values: d=0 built by hand)
            quant = (lambda x: QuantizedTensor(  # noqa: E731
                x.to(torch.int8), torch.ones(1, 1, 1, device=cuda_device),
                64)) if bad == 0 else (lambda x: quantize_int8(x, 64))
            qq, kq, vq = quant(q), quant(k), quant(v)
            if bad != 257:          # 257 runs on H5's quantized form
                with pytest.raises(ValueError, match=rule):
                    flash_attention_kvquant(q, kq, vq, scale=1.0)
            if bad != 2049:
                with pytest.raises(ValueError, match=rule):
                    flash_attention_int8(qq, kq, vq, scale=1.0)
        torch.cuda.synchronize()
        assert [fn.launches for fn in counted] == before[:6] + [
            before[6] + 1, before[7] + 1]
        return
    rule = re.escape(SERVING_HEAD_DIM_RULE)
    with pytest.raises(ValueError, match=rule):
        prefill_attention(q, k, v, 0.125, 0)
    with pytest.raises(ValueError, match=rule):
        splitkv_combine(torch.zeros(1, 2, 2, 8, d, device=cuda_device),
                        torch.zeros(1, 2, 2, 8, device=cuda_device))
    cache = make_cache(2, d, 4, max_seqs=1, device=cuda_device)
    slots = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    # the scale given: the default 1 / sqrt(d) has no value at d=0
    with pytest.raises(ValueError, match=rule):
        paged_decode_attention(q[:, :, 0].contiguous(), cache, slots, 1.0)
    with pytest.raises(ValueError, match=rule):
        paged_extend_attention(q.transpose(1, 2).contiguous(), cache, slots,
                               1.0)
    with pytest.raises(ValueError, match=re.escape(NARROW_HEAD_DIM_RULE)):
        flash_attention_bwd(q, k, v, q, q, lse, scale=1.0, causal=True)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == before


def test_wide_head_dims_split_the_rules(cuda_device):
    """At d=300 the serving kernels take bf16 and f32 (one launch each of
    H1, H2, H6-decode and H6-extend at each dtype), while H3-dkv and H3-dq
    refuse it naming ``NARROW_HEAD_DIM_RULE`` and launch nothing."""
    counted = (prefill_attention, splitkv_combine, paged_decode_partials,
               paged_extend_attention, attention_bwd_dkv, attention_bwd_dq)
    before = [fn.launches for fn in counted]
    q, k, v = _qkv(cuda_device, 1, 4, 2, 64, 300, 300)
    o, lse = prefill_attention(q, k, v, 0.05, 0, False, kv_span=128)
    splitkv_combine(o.float(), lse)
    cache, qd, slots = _paged_case(cuda_device, 4, 2, 300, 128, [200, 7])
    paged_decode_attention(qd, cache, slots)
    paged_extend_attention(qd[:, None].contiguous(), cache, slots)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [
        x + 1 for x in before[:4]] + before[4:]
    o, lse = prefill_attention(q.float(), k.float(), v.float(), 0.05, 0,
                               False, kv_span=128)
    assert splitkv_combine(o, lse).dtype == torch.float32
    assert paged_decode_attention(qd.float(), cache, slots).dtype == (
        torch.float32)
    paged_extend_attention(qd[:, None].float().contiguous(), cache, slots)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [
        x + 2 for x in before[:4]] + before[4:]
    narrow = re.escape(NARROW_HEAD_DIM_RULE)
    lse = torch.zeros(1, 4, 64, device=cuda_device)
    for dt in (torch.bfloat16, torch.float32):
        x, kx, vx = q.to(dt), k.to(dt), v.to(dt)
        with pytest.raises(ValueError, match=narrow):
            flash_attention_bwd(x, kx, vx, x, x, lse, scale=1.0, causal=True)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [
        x + 2 for x in before[:4]] + before[4:]


# (hq, hkv, d, page size) of the paged kernels at the rule's new points:
# every d of 16, 80 and 256, every group of 1, 16 and 32 (chunked over
# blocks of at most 8 q heads, 4 at d=256) and every page size of 128, 512
# and 1024 appear
PAGED_HEADS = [(16, 1, 80, 512), (32, 1, 16, 1024), (4, 4, 256, 128),
               (32, 2, 256, 512), (16, 1, 16, 128), (2, 2, 80, 1024),
               # d off the multiples of 16: code rows 8-byte aligned (72,
               # 40), 4-byte (36), 2-byte (250), 1-byte (33)
               (16, 16, 72, 128), (8, 1, 40, 256), (32, 2, 36, 512),
               (16, 1, 33, 1024), (8, 4, 250, 128)]
# past 256 (bf16, and f32 q in the f32 tests): heads512's geometry, a
# group of 16 in chunks of 2 q heads, code rows of 16 (384, 512), 8 (264),
# 4 (300) and 1-byte (257, 385) alignment
PAGED_WIDE = [(2, 1, 512, 256), (16, 1, 512, 128), (4, 4, 264, 512),
              (8, 2, 300, 128), (4, 1, 257, 1024), (8, 8, 385, 128),
              (2, 2, 384, 256)]


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("hq,hkv,d,ps", PAGED_HEADS + PAGED_WIDE)
def test_decode_kernel_head_dims_groups_pages(cuda_device, hq, hkv, d, ps,
                                              window):
    """H6-decode, fused, at the rule's new head dims, GQA groups past 8
    (blocks of a group chunk, a ticket each) and pages past 256, over
    ragged lengths to 2300 (runs of several pages): O against the plain
    version and the f64 oracle over each band; zeros for an empty
    sequence and a slot of -1; the fused O within one bf16 ulp of the
    plain merge of the kernel's own partials; every ticket zero after."""
    lens = [0, 1, 127, 513, 1100, 2300]
    cache, q, slots = _paged_case(cuda_device, hq, hkv, d, ps, lens, seed=60)
    scale = 1.0 / math.sqrt(d)
    before = paged_decode_partials.launches
    o = paged_decode_attention(q, cache, slots, window=window)
    torch.cuda.synchronize()
    assert paged_decode_partials.launches == before + 1
    assert not ticket_buffer(cuda_device).any()
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert _paged_close(o, paged_decode_plain(q, cache, slots, scale, window))
    assert (o[0] == 0).all()
    g = hq // hkv
    for s, n in enumerate(lens[1:], 1):
        kf, vf = gather_kv(cache, s)
        lo = max(0, n - window) if window else 0
        oracle = naive_attention(q[s].view(hkv, g, d), kf[:, lo:],
                                 vf[:, lo:])
        assert _paged_close(o[s].float().view(hkv, g, d).cpu(),
                            torch.from_numpy(oracle)), s
    o_part, lse = paged_decode_partials(q, cache, slots, scale, window)
    merged = splitkv_combine_plain(o_part, lse)[:, :, 0]
    top = merged.abs().max().item()
    assert (o.float() - merged).abs().max().item() <= _bf16_ulp(top)
    bad = slots.clone()
    bad[2] = -1
    o_bad = paged_decode_attention(q, cache, bad, window=window)
    assert (o_bad[2] == 0).all() and torch.equal(o_bad[3:], o[3:])


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("window", [None, "narrower than the context"])
@pytest.mark.parametrize("n_runs", [1, 8, 40])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_fused_decode_merges_its_runs(cuda_device, group, d, n_runs,
                                      window):
    """The fused H6-decode (one launch; the last block of each batch row and
    KV head to arrive on its ticket merges the runs) at GQA groups 1 to 8,
    d 64 and 128, and 1, 8 or 40 runs of one page each (B=4 rows on one KV
    head: a long sequence, an empty one, slot -1, one half as long), with
    and without a window: O against the plain version, zeros on the empty
    and invalid rows, and within one bf16 ulp of max|O| of the plain merge
    of the kernel's own partials; three calls bitwise equal and every
    ticket zero after them."""
    ps = 128
    lens = [n_runs * ps - 10, 0, 0, n_runs * ps // 2 + 3]
    cache, q, slots = _paged_case(cuda_device, group, 1, d, ps, lens,
                                  seed=50 + n_runs, max_pages=n_runs)
    slots[2] = -1
    window = None if window is None else max(n_runs * ps - 60, 50)
    scale = 1.0 / math.sqrt(d)
    before = (paged_decode_partials.launches, splitkv_combine.launches)
    runs = [paged_decode_attention(q, cache, slots, window=window)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert (paged_decode_partials.launches,
            splitkv_combine.launches) == (before[0] + 3, before[1])
    o = runs[0]
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert all(torch.equal(o, x) for x in runs[1:])
    assert not ticket_buffer(cuda_device).any()
    ref = paged_decode_plain(q, cache, torch.where(slots < 0, 1, slots),
                             scale, window)
    assert _paged_close(o, ref)
    assert (o[1:3] == 0).all()
    o_part, lse = paged_decode_partials(q, cache, slots, scale, window)
    assert o_part.shape[2] == n_runs
    merged = splitkv_combine_plain(o_part, lse)[:, :, 0]
    top = merged.abs().max().item()
    assert (o.float() - merged).abs().max().item() <= _bf16_ulp(top)


EXTEND_CASES = [
    # (hq, hkv, d, ps, histories, C)
    (8, 4, 128, 128, [257 + 3 * i for i in range(8)], 256),  # multi-turn
    (8, 8, 128, 256, [0, 1, 300, 555], 77),                   # G=1
    (8, 1, 64, 128, [130, 0, 200, 77], 40),                   # G=8, d=64
    (4, 2, 64, 256, [700, 3], 1),                             # C = 1
    # the speculative verify's C = gamma + 1 = 5 (10 rows of a 64-row
    # tile), chunks across page boundaries 128, 256 and 384
    (8, 4, 128, 128, [125, 252, 381, 126, 0, 3], 5),
    # the rule's new head dims, groups and pages (PAGED_HEADS)
    (16, 1, 80, 512, [0, 300, 900], 129),
    (32, 1, 16, 1024, [1000, 5], 40),
    (4, 4, 256, 128, [257, 0, 130], 200),
    (32, 2, 256, 512, [600, 17], 9),
    # d off the multiples of 16 (PAGED_HEADS): the codes by bulk copy
    (16, 16, 72, 128, [0, 300, 257], 100),
    (8, 1, 40, 256, [1000, 5], 40),
    (32, 2, 36, 512, [600, 17], 9),
    (16, 1, 33, 1024, [1100, 0], 64),
    (8, 4, 250, 128, [130, 3], 77),
]
# past 256 (PAGED_WIDE, and at f32 q in the f32 tests): H5's blocks with
# the codes by TMA (384, 512; bf16 also 264) or copied at their rows'
# alignment (257, 300, 385; f32 also 264, whose rows are no multiple of 16)
EXTEND_WIDE = [
    (2, 1, 512, 256, [257 + 3 * i for i in range(8)], 256),  # heads512 turn 2
    (16, 1, 512, 128, [0, 300, 900], 129),
    (4, 4, 264, 512, [600, 17], 9),
    (8, 2, 300, 128, [130, 0, 200, 77], 40),
    (4, 1, 257, 1024, [1100, 0], 64),
    (8, 8, 385, 128, [257, 0, 130], 200),
    (2, 2, 384, 256, [700, 3], 1),
]


@pytest.mark.parametrize("window", [None, 1, 77, 300])
@pytest.mark.parametrize("hq,hkv,d,ps,hist,c", EXTEND_CASES + EXTEND_WIDE)
def test_extend_kernel_masks_pages_groups(cuda_device, hq, hkv, d, ps, hist,
                                          c, window):
    """H6-extend against the plain version and the f64 oracle over each
    chunk row's band: the causal mask alone and windows of 1, 77 and 300
    keys, page sizes 128 and 256, d 64 and 128, groups 1, 2 and 8, ragged
    and empty histories, C from 1 to 256 (C * G below and above the
    128-row tile; the verify's C = 5 across page boundaries), old codes
    past each tail, a slot of -1 (zeros); two runs bitwise equal."""
    cache, q, slots = _paged_case(cuda_device, hq, hkv, d, ps, hist, c)
    scale = 1.0 / math.sqrt(d)
    o = paged_extend_attention(q, cache, slots, window=window)
    again = paged_extend_attention(q, cache, slots, window=window)
    torch.cuda.synchronize()
    assert torch.equal(o, again)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert _paged_close(o, paged_extend_plain(q, cache, slots, scale, window))
    g = hq // hkv
    for s, n in enumerate(hist):
        kf, vf = gather_kv(cache, s)
        for i in sorted({0, c // 2, c - 1}):
            pos = n + i
            lo = max(0, pos - window + 1) if window else 0
            oracle = naive_attention(q[s, i].view(hkv, g, d),
                                     kf[:, lo:pos + 1], vf[:, lo:pos + 1])
            assert _paged_close(o[s, i].float().view(hkv, g, d).cpu(),
                                torch.from_numpy(oracle)), (s, i)
    bad = slots.clone()
    bad[1] = -1
    o_bad = paged_extend_attention(q, cache, bad, window=window)
    assert (o_bad[1] == 0).all() and torch.equal(o_bad[0], o[0])


def _extend_case(dev, hq, hkv, d, hist, c, ps=128, seed=2):
    """Ragged histories through append_prompts, then one C-token chunk
    through append_chunks, in a permuted page table; bf16 q [B, C, Hq, d]."""
    b = len(hist)
    max_pages = -(-(max(hist) + c) // ps)
    cache = make_cache(hkv, d, b * max_pages, page_size=ps, max_seqs=b,
                       max_pages_per_seq=max_pages, device=dev)
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(b * max_pages, generator=g)
    cache.page_table.copy_(perm.view(b, max_pages).to(torch.int32))
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    for s, n in enumerate(hist):
        kp = torch.randn(1, n, hkv, d, generator=g).to(dev)
        vp = torch.randn(1, n, hkv, d, generator=g).to(dev)
        append_prompts(cache, slots[s:s + 1], kp, vp)
    append_chunks(cache, slots, torch.randn(b, c, hkv, d, generator=g).to(dev),
                  torch.randn(b, c, hkv, d, generator=g).to(dev))
    q = torch.randn(b, c, hq, d, generator=g).to(dev, torch.bfloat16)
    return cache, q, slots


@pytest.mark.parametrize("hq,hkv,d,hist,c", [
    (8, 4, 128, [257 + 3 * i for i in range(8)], 256),   # the multi-turn slice
    (8, 2, 64, [130, 1, 200, 77], 77),                   # ragged, G=4, d=64
])
def test_extend_kernel_matches_plain_and_oracle(cuda_device, hq, hkv, d,
                                                hist, c):
    cache, q, slots = _extend_case(cuda_device, hq, hkv, d, hist, c)
    o = paged_extend_attention(q, cache, slots)
    torch.cuda.synchronize()
    ref = paged_extend_plain(q, cache, slots, 1.0 / math.sqrt(d))
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert ((o.float() - ref).abs()
            <= EXTEND_O_TOL + 2 ** -7 * ref.abs()).all()
    g = hq // hkv
    for s, n in enumerate(hist):
        kf, vf = gather_kv(cache, s)
        for i in (0, c // 2, c - 1):
            oracle = naive_attention(q[s, i].view(hkv, g, d),
                                     kf[:, :n + i + 1], vf[:, :n + i + 1])
            got = o[s, i].float().view(hkv, g, d).cpu().numpy()
            assert (np.abs(got - oracle)
                    <= EXTEND_O_TOL + 2 ** -7 * np.abs(oracle)).all(), (s, i)


def test_extend_kernel_counts_launches_and_refuses_f16(cuda_device):
    """bf16 and f32 q each run one launch (O in q's dtype); f16 and f64
    raise before any launch."""
    cache, q, slots = _extend_case(cuda_device, 4, 2, 64, [5, 140], 9)
    before = paged_extend_attention.launches
    paged_extend_attention(q, cache, slots)
    assert paged_extend_attention.launches == before + 1
    assert paged_extend_attention(q.float(), cache,
                                  slots).dtype == torch.float32
    assert paged_extend_attention.launches == before + 2
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bf16 or f32"):
            paged_extend_attention(q.to(dt), cache, slots)
    assert paged_extend_attention.launches == before + 2


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize("d", [80, 256, 72, 33, 300, 512])
@pytest.mark.parametrize("pos,causal", [((256, 256), True), ((0, 300), True),
                                        ((300, 0), True), ((0, 0), False)])
def test_h1_traced_offsets_at_new_head_dims(cuda_device, d, pos, causal):
    """H1 at traced positions (the device int32 pair) is bitwise its static
    launch at d 80 (D=128 instance), 256 (64-key tiles) and past 256 (H5's
    block: 300 staged, 512 by TMA), over one span and over 128-key spans;
    a hop in the future gives (0, -inf)."""
    q, k, v = _qkv(cuda_device, 2, 16, 1, 300, 300, d, seed=70)
    offs = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    diag = pos[0] - pos[1]
    for span in (None, 128):
        fwd = [prefill_attention(q, k, v, d ** -0.5, x if causal else 0,
                                 causal, out_dtype=torch.float32,
                                 kv_span=span) for x in (offs, diag)]
        assert all(torch.equal(a, b) for a, b in zip(*fwd))
        if pos == (0, 300):
            assert (fwd[0][0] == 0).all() and torch.isneginf(fwd[0][1]).all()


def _bwd_case(dev, b, hq, hkv, lq, lkv, d, diag_off, seed=4, causal=True,
              window=None):
    """Inputs of one backward and H1's residuals under the mask.  Q and dO
    carry a ramp over d on top of the noise, so that their tiles, which
    H3-dkv reads both K-major and MN-major, are far from symmetric."""
    q, k, v = _qkv(dev, b, hq, hkv, lq, lkv, d, seed=seed)
    do = _qkv(dev, b, hq, hkv, lq, lkv, d, seed=seed + 1)[0]
    ramp = torch.linspace(0.5, 1.5, d, device=dev)
    q, do = (q.float() * ramp).bfloat16(), (do.float() * ramp).bfloat16()
    scale = 1.0 / math.sqrt(d)
    out, lse = prefill_attention(q, k, v, scale, diag_off, causal, window)
    return q, k, v, out, do, lse, scale


BWD_MASKS = {"none": (False, None), "causal": (True, None),
             "window": (True, 100)}


@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d,diag_off,mask", [
    *[(1, 4, 4 // g, lq, lkv, d, lkv - lq, mask)
      for mask in BWD_MASKS for g in (1, 2) for d in (64, 128)
      for lq, lkv in ((127, 127), (128, 128), (129, 129), (257, 257),
                      (1000, 1100))],
    (8, 8, 4, 1024, 1024, 128, 0, "causal"),   # the training slice
    (8, 8, 4, 1024, 1024, 128, 0, "none"),     # the encoder's attention
    (2, 8, 4, 200, 216, 128, 16, "causal"),    # ragged, Lq != Lkv
    (2, 8, 2, 77, 130, 64, 53, "causal"),      # ragged, G=4, d=64
    (1, 4, 2, 96, 80, 128, -16, "causal"),     # Lq > Lkv: 16 rows see no key
    (1, 4, 4, 100, 100, 64, -24, "causal"),    # negative static offset, d=64
    (1, 4, 2, 300, 300, 128, -40, "window"),   # a band off the diagonal
    (1, 8, 4, 3072, 3072, 128, 0, "causal"),   # where JAX takes B12/B13
    # every instance off the flagship's d (D 32: 16, 32; D 64: 48; D 128:
    # 80, 96; D 256, whose warpgroups split the columns: 144, 256), in a
    # group of 16 over one KV head, ragged and square
    *[(1, 16, 1, lq, lkv, d, lkv - lq, mask)
      for mask in BWD_MASKS for d in (16, 32, 48, 80, 96, 144, 256)
      for lq, lkv in ((129, 129), (200, 330))],
    *[(2, 8, 4, 1000, 1100, d, 100, mask)
      for mask in BWD_MASKS for d in (32, 80, 256)],
    (1, 4, 2, 96, 80, 256, -16, "causal"),     # Lq > Lkv at D=256
    (1, 4, 1, 300, 300, 80, -40, "window"),    # a band off the diagonal
    (2, 4, 1, 1024, 1024, 256, 0, "causal"),   # heads256's attention
    (2, 16, 1, 1024, 1024, 80, 0, "causal"),   # heads80g16's attention
    # d off the multiples of 16 (ODD_BWD_DIMS), GQA 8/2, ragged and cross:
    # bf16 rows by TMA at d % 8 == 0 (40, 72), by the staged producer else
    # (odd 1, 33; rows 8-byte aligned 36, 100; 4-byte 250)
    *[(2, 8, 2, 200, 330, d, 130, mask)
      for mask in BWD_MASKS for d in (1, 33, 36, 40, 72, 100, 250)],
    (2, 16, 16, 1024, 1024, 72, 0, "causal"),  # heads72's attention
    (1, 4, 2, 96, 80, 36, -16, "causal"),      # Lq > Lkv, staged
    (1, 4, 2, 300, 300, 33, -40, "window"),    # a band off the diagonal
])
def test_bwd_kernels_match_plain(cuda_device, b, hq, hkv, lq, lkv, d,
                                  diag_off, mask):
    causal, window = BWD_MASKS[mask]
    q, k, v, out, do, lse, scale = _bwd_case(cuda_device, b, hq, hkv, lq,
                                             lkv, d, diag_off, causal=causal,
                                             window=window)
    positions = (diag_off, 0)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, scale=scale,
                                     causal=causal,
                                     static_positions=positions,
                                     window=window)
    torch.cuda.synchronize()
    ref = attention_bwd_plain(q, k, v, out, do, lse, scale, causal,
                              diag_off, window)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == torch.bfloat16, name
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got, want) < BWD_REL_TOL, name
    if causal and diag_off < 0:       # rows that see no key: zero dQ
        assert (dq[:, :, :-diag_off] == 0).all()
    if causal and lkv > lq + diag_off:    # keys no row sees: zero dK, dV
        assert (dk[:, :, lq + diag_off:] == 0).all()
        assert (dv[:, :, lq + diag_off:] == 0).all()


@pytest.mark.parametrize("d", [128, 80, 256, 72, 33, 250])
@pytest.mark.parametrize("pos,mask", [
    ((256, 256), "causal"),        # a ring's diagonal hop
    ((0, 300), "causal"),          # a hop wholly in the future: no key
    ((300, 0), "causal"),          # a past hop: every key
    ((100, 37), "window"),         # a band off the diagonal
])
def test_traced_offsets_equal_the_static_launch(cuda_device, pos, mask, d):
    """H1, H3-dkv and H3-dq at traced positions (the int32 pair in device
    memory that every block reads, B9's and B11-B15's traced form) are
    bitwise the same kernels at the static diagonal, through the public
    calls too, at d 128, 80 (the D=128 instance on zero-filled columns),
    256 (the column-split instance), 72 (rows by TMA) and 33 and 250 (rows
    by the staged producers); a hop that sees no key gives (0, -inf) and
    zero gradients."""
    causal, window = BWD_MASKS[mask]
    diag = pos[0] - pos[1]
    q, k, v, out, do, lse, scale = _bwd_case(cuda_device, 2, 8, 4, 300, 300,
                                             d, diag, causal=causal,
                                             window=window)
    lse = torch.where(torch.isneginf(lse), 5.0, lse)   # a ring's global LSE
    offs = torch.tensor(pos, dtype=torch.int32, device=q.device)
    traced = (offs[0], offs[1])
    fwd = [prefill_attention(q, k, v, scale, x, causal, window,
                             out_dtype=torch.float32) for x in (offs, diag)]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    bwd = [flash_attention_bwd(q, k, v, out, do, lse, scale=scale,
                               causal=causal,
                               window=window, **kw)
           for kw in ({"positions": traced}, {"static_positions": pos})]
    assert all(torch.equal(a, b) for a, b in zip(*bwd))
    if mask == "causal":
        part = attention_partial_local(q, k, v, scale=scale, causal=True,
                                       positions=traced)
        assert all(torch.equal(a, b) for a, b in zip(part, fwd[0]))
    if pos == (0, 300):
        assert (fwd[0][0] == 0).all() and torch.isneginf(fwd[0][1]).all()
        assert all((g == 0).all() for g in bwd[0])


@pytest.mark.parametrize("d", [128, 80, 256, 1, 33, 36, 40, 72, 100, 250])
@pytest.mark.parametrize("mask", BWD_MASKS)
def test_bwd_kernels_are_bitwise_reproducible(cuda_device, mask, d):
    causal, window = BWD_MASKS[mask]
    args = _bwd_case(cuda_device, 2, 8, 4, 520, 520, d, 0, causal=causal,
                     window=window)
    first = flash_attention_bwd(*args, causal=causal, window=window)
    for _ in range(3):
        for a, b in zip(first, flash_attention_bwd(*args, causal=causal,
                                                   window=window)):
            assert torch.equal(a, b)


def test_bwd_kernels_count_launches_and_refuse_f32(cuda_device):
    """One launch of each kernel a call, f32 at d=144 (the f32 D=256
    instance, a cluster of two blocks) too; f16 refused with no launch, as
    is d=272, outside ``ops.attention.NARROW_HEAD_DIM_RULE`` (its
    residuals are made by hand)."""
    q, k, v, out, do, lse, scale = _bwd_case(cuda_device, 1, 2, 2, 64, 64,
                                             64, 0)
    before = (attention_bwd_dkv.launches, attention_bwd_dq.launches)
    flash_attention_bwd(q, k, v, out, do, lse, scale=scale, causal=True)
    assert (attention_bwd_dkv.launches, attention_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError, match="bf16"):
        flash_attention_bwd(q.half(), k.half(), v.half(), out.half(),
                            do.half(), lse, scale=scale, causal=True)
    q144, k144, v144 = (x.float() for x in _qkv(cuda_device, 1, 2, 2, 64,
                                                 64, 144, seed=4))
    lse144 = torch.zeros(1, 2, 64, device=cuda_device)
    grads = flash_attention_bwd(q144, k144, v144, q144, q144, lse144,
                                causal=True)
    assert all(g.dtype == torch.float32 for g in grads)
    assert (attention_bwd_dkv.launches, attention_bwd_dq.launches) == (
        before[0] + 2, before[1] + 2)
    q272, k272, v272 = _qkv(cuda_device, 1, 2, 2, 64, 64, 272, seed=4)
    lse272 = torch.zeros(1, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match=NARROW_HEAD_DIM_RULE):
        flash_attention_bwd(q272, k272, v272, q272, q272, lse272,
                            causal=True)
    assert (attention_bwd_dkv.launches, attention_bwd_dq.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)])
def test_autograd_through_flash_attention_runs_h1_and_h3(cuda_device, causal,
                                                         window):
    """The training call: a permuted dO out of the output projection's
    einsum, as autograd hands it over; causal, without a mask (the
    encoder) and in a window."""
    q, k, v = _qkv(cuda_device, 2, 8, 4, 300, 300, 128, seed=6)
    w = _qkv(cuda_device, 1, 8, 8, 128, 128, 64, seed=7)[0][0]  # [H, d, E]
    counts = (prefill_attention.launches, attention_bwd_dkv.launches,
              attention_bwd_dq.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, causal=causal, window=window)
    loss = torch.einsum("bhld,hde->ble", o, w).float().square().mean()
    grads = torch.autograd.grad(loss, leaves)
    assert (prefill_attention.launches, attention_bwd_dkv.launches,
            attention_bwd_dq.launches) == tuple(c + 1 for c in counts)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref = attention_plain(*ref_leaves, 1.0 / math.sqrt(128), causal, 0,
                            window)[0]
    loss_ref = torch.einsum("bhld,hde->ble", o_ref.to(torch.bfloat16),
                            w).float().square().mean()
    for name, got, want in zip(("dq", "dk", "dv"), grads,
                               torch.autograd.grad(loss_ref, ref_leaves)):
        assert _rel(got, want) < BWD_REL_TOL, name


def test_mlm_train_step_runs_h1_and_h3_without_a_mask(cuda_device):
    """A small bf16 encoder takes two MLM steps on the card: every layer
    launches H1 once and H3-dkv and H3-dq once a step, the loss is finite
    and falls on a fixed batch and mask."""
    cfg = ModelConfig(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      d_model=256, d_head=64, d_ff=512, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=cuda_device)
    step, opt_init = make_mlm_train_step(cfg, learning_rate=3e-3)
    opt = opt_init(params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (2, 200))).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    _, mask = mask_tokens(tokens, gen, cfg.vocab_size - 1)
    losses = []
    for _ in range(2):
        before = (prefill_attention.launches, attention_bwd_dkv.launches,
                  attention_bwd_dq.launches)
        losses.append(step(params, opt, tokens, None, mask).item())
        after = (prefill_attention.launches, attention_bwd_dkv.launches,
                 attention_bwd_dq.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2)
    assert all(math.isfinite(x) for x in losses) and losses[1] < losses[0]


def _max_err(got, ref):
    return float(np.abs(got.float().cpu().numpy() - np.asarray(
        ref.float().cpu() if isinstance(ref, torch.Tensor) else ref)).max())


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("lq,lkv,d,block", [
    (256, 256, 128, 128),
    (200, 1100, 128, 128),        # ragged Q and KV, a ragged last block
    (130, 300, 64, 100),          # d=64, a block no tile lines up with
] + [
    # the edges of the 128-key tiles, with blocks shorter than, equal to
    # and longer than a tile (the V scales' vmax per tile)
    (200, lkv, 128, block) for lkv in (127, 129, 1100)
    for block in (16, 64, 128, 512)
] + [
    # head dims of the rule on each instance (D 64, 128, 256; a d below D
    # on zero-filled columns), the D=256 instance's 64-key tiles ragged
    (200, 1100, d, 100) for d in (16, 48, 80, 144, 192, 256)
] + [(130, 129, 256, 48)] + [
    # d off the multiples of 16 (the PACKED instances): code rows of 1-,
    # 2-, 4- and 8-byte alignment, bf16 Q rows staged where d % 8 != 0
    (200, 1100, d, 100) for d in (1, 8, 33, 36, 40, 72, 100, 250)
])
def test_kvquant_kernel_matches_plain_and_oracle(cuda_device, kind, lq, lkv,
                                                 d, block):
    q, k, v = _qkv(cuda_device, 2, 4, 4, lq, lkv, d, seed=20)
    kq, vq = QUANT[kind](k, block), QUANT[kind](v, block)
    before = flash_attention_kvquant.launches
    o = flash_attention_kvquant(q, kq, vq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert flash_attention_kvquant.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == q.shape
    scale = 1.0 / math.sqrt(d)
    assert _max_err(o, attention_kvquant_plain(q, kq, vq, scale)) < KVQ_O_TOL
    oracle = naive_attention(q, dequantize(kq), dequantize(vq))
    assert _max_err(o, oracle) < KVQ_O_TOL
    assert flash_attention_kvquant(q, kq, vq).dtype == torch.bfloat16


def test_kvquant_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 64)
    kq, vq = quantize_int8(k, 64), quantize_int8(v, 64)
    before = flash_attention_kvquant.launches
    with pytest.raises(TypeError, match="bf16 or f32"):
        flash_attention_kvquant(q.half(), kq, vq)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_kvquant(q, kq, quantize_fp8(v, 64))
    cpu = QuantizedTensor(kq.values.cpu(), kq.scales.cpu(), kq.block)
    with pytest.raises(ValueError, match="device"):
        flash_attention_kvquant(q, cpu, vq)
    assert flash_attention_kvquant.launches == before


@pytest.mark.parametrize("pv_mode", ["bf16", "int8"])
@pytest.mark.parametrize("lq,lkv,d,q_block,kv_block", [
    (512, 512, 128, 512, 512),
    (200, 1100, 128, 64, 128),    # ragged, any Q block
    (128, 200, 64, 128, 128),     # tests/test_attention_int8.py:56
    (256, 256, 64, 128, 48),      # a kv block that splits the 64-key tiles
    # kv blocks shorter than the 128-key tile: several runs per tile, each
    # with its v_scale; in int8 mode 16 and 48 end inside a 32-key step
    (200, 300, 128, 64, 16),
    (200, 300, 128, 64, 32),
    (200, 300, 128, 64, 48),
    (200, 300, 128, 64, 64),
] + [
    # head dims of the rule on each instance (D 64, 128, 256: at D=256
    # 64-key tiles, Q and K in two 128-byte boxes, P V in four parts)
    (200, 1100, d, 64, 48) for d in (16, 80, 144, 256)
] + [(256, 300, 256, 128, 16), (128, 257, 256, 128, 512)] + [
    # d off the multiples of 16 (the PACKED instances)
    (200, 1100, d, 64, 48) for d in (1, 8, 33, 36, 40, 72, 100, 250)
])
def test_int8_kernel_matches_plain_and_oracle(cuda_device, pv_mode, lq, lkv,
                                              d, q_block, kv_block):
    q, k, v = _qkv(cuda_device, 2, 4, 4, lq, lkv, d, seed=21)
    qq = quantize_int8(q, q_block)
    kq, vq = quantize_int8(k, kv_block), quantize_int8(v, kv_block)
    before = flash_attention_int8.launches
    o = flash_attention_int8(qq, kq, vq, out_dtype=torch.float32,
                             pv_mode=pv_mode)
    torch.cuda.synchronize()
    assert flash_attention_int8.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == q.shape
    plain = attention_int8_plain(qq, kq, vq, 1.0 / math.sqrt(d), pv_mode)
    assert _max_err(o, plain) < INT8_PLAIN_TOL
    oracle = naive_attention(*(dequantize(x) for x in (qq, kq, vq)))
    # B18's requantized P in pv_mode int8 is the function's own error: it
    # reads 3.2e-2 here at 512 keys, beyond the JAX test's tier, which
    # holds at that test's shape (ROADMAP.md queue C)
    if pv_mode == "bf16" or (lq, lkv, d) == (128, 200, 64):
        assert _max_err(o, oracle) < INT8_ORACLE_TOL[pv_mode]
    assert _max_err(o, oracle) < _max_err(plain, oracle) + INT8_PLAIN_TOL
    if vq.scales.shape[2] > 1:
        # the neighbouring block's V scales: a path the check tells apart
        wrong = QuantizedTensor(vq.values, vq.scales.roll(1, dims=2),
                                vq.block)
        assert _max_err(o, attention_int8_plain(
            qq, kq, wrong, 1.0 / math.sqrt(d), pv_mode)) > 10 * INT8_PLAIN_TOL


def test_int8_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 64)
    qq, kq, vq = (quantize_int8(x, 64) for x in (q, k, v))
    before = flash_attention_int8.launches
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_int8(qq, quantize_fp8(k, 64), quantize_fp8(v, 64))
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention_int8(qq, quantize_int8(k, 40), quantize_int8(v, 40))
    with pytest.raises(TypeError, match="bf16 or f32"):
        flash_attention_int8(qq, kq, vq, out_dtype=torch.float16)
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 264)
    with pytest.raises(ValueError, match=NARROW_HEAD_DIM_RULE):
        flash_attention_int8(*(quantize_int8(x, 64) for x in (q, k, v)))
    assert flash_attention_int8.launches == before


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("q_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("d", [272, 384, 1024, 264, 520, 1000, 2040])
def test_kvquant_past_256_runs_h5(cuda_device, d, q_dtype, kind):
    """flash_attention_kvquant past d=256 is one launch of H5's quantized
    form (counted as H5's, none as H4-kvq's), within H5's limits of the
    plain version: 4e-3 at bf16 q, 2e-5 at f32; d=2064 raises naming both
    rules."""
    if q_dtype == "bf16":
        q, k, v = _qkv(cuda_device, 2, 2, 2, 200, 330, d, seed=25)
        tol = DTILED_O_TOL
    else:
        q, k, v = _f32_qkv(cuda_device, 2, 2, 2, 200, 330, d, seed=25)
        tol = F32_TOL
    kq, vq = QUANT[kind](k, 100), QUANT[kind](v, 100)
    before = (flash_attention_kvquant.launches,
              flash_attention_v1_dtiled.launches)
    o = flash_attention_kvquant(q, kq, vq, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (flash_attention_kvquant.launches,
            flash_attention_v1_dtiled.launches) == (before[0], before[1] + 1)
    scale = 1.0 / math.sqrt(d)
    assert _max_err(o, attention_kvquant_plain(q, kq, vq, scale)) < tol
    q, k, v = _qkv(cuda_device, 1, 1, 1, 64, 64, 2064)
    with pytest.raises(ValueError, match=H5_HEAD_DIM_RULE):
        flash_attention_kvquant(q, quantize_int8(k, 64), quantize_int8(v, 64))


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("lq,lkv,d,block", [
    (512, 512, 512, 512),
    (200, 330, 256, 128),         # ragged
    (64, 100, 128, 64),
    # Lq and Lkv off the 64-row and 64-key tiles, at every warpgroup count
    (100, 130, 128, 64),
    (65, 191, 256, 48),
    (70, 150, 384, 64),
    (130, 200, 512, 100),
    # head dims off the 128-column chunks, and clusters of 2 and 4 blocks
    (100, 130, 64, 64),
    (65, 191, 144, 48),
    (130, 200, 640, 100),
    (70, 150, 1024, 64),
    (65, 191, 2048, 48),
] + [
    # d off the multiples of 16: bf16 rows staged where d % 8 != 0, codes
    # where d % 16 != 0 (the STAGED instances), on the last rank's last
    # chunk past 512
    (100, 130, d, 64) for d in (1, 8, 33, 36, 40, 72, 100, 250)
] + [(65, 191, 520, 48), (70, 150, 1000, 64), (65, 191, 2040, 100)])
def test_dtiled_kernel_matches_plain_and_oracle(cuda_device, kind, lq, lkv,
                                                d, block):
    q, k, v = _qkv(cuda_device, 1, 2, 2, lq, lkv, d, seed=22)
    if kind != "bf16":
        k, v = QUANT[kind](k, block), QUANT[kind](v, block)
    before = flash_attention_v1_dtiled.launches
    o = flash_attention_v1_dtiled(q, k, v, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert flash_attention_v1_dtiled.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == q.shape
    scale = 1.0 / math.sqrt(d)
    assert _max_err(o, attention_dtiled_plain(q, k, v, scale)) < DTILED_O_TOL
    kd, vd = (k, v) if kind == "bf16" else (dequantize(k), dequantize(v))
    assert _max_err(o, naive_attention(q, kd, vd)) < DTILED_O_TOL


@pytest.mark.parametrize("d", [512, 1024, 2048])
@pytest.mark.parametrize("kind", ["bf16", "fp8"])
def test_dtiled_kernel_is_bitwise_reproducible(cuda_device, kind, d):
    """One warpgroup sums S over the block's d-chunks in a fixed order,
    and at d 1024 and 2048 a cluster of 2 and 4 blocks adds the ranks'
    partials in rank order: two runs give the same bits."""
    q, k, v = _qkv(cuda_device, 2, 4, 4, 300, 330, d, seed=23)
    if kind != "bf16":
        k, v = QUANT[kind](k, 64), QUANT[kind](v, 64)
    first = flash_attention_v1_dtiled(q, k, v, out_dtype=torch.float32)
    second = flash_attention_v1_dtiled(q, k, v, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_dtiled_kernel_refuses_what_it_cannot_take(cuda_device):
    before = flash_attention_v1_dtiled.launches
    for d in (0, 2049, 2064):
        q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, d)
        with pytest.raises(ValueError, match=H5_HEAD_DIM_RULE):
            flash_attention_v1_dtiled(q, k, v, scale=1.0)
        with pytest.raises(ValueError, match=H5_HEAD_DIM_RULE):
            flash_attention_v1_dtiled(q.float(), k.float(), v.float(),
                                      scale=1.0)
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 64, 256)
    with pytest.raises(TypeError, match="bf16 or f32"):
        flash_attention_v1_dtiled(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention_v1_dtiled(q.float(), k, v)
    assert flash_attention_v1_dtiled.launches == before


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lkv,block_kv,tiles", [
    (1024, 1024, 512, 1),         # the JAX suite's bench_splitkv config
    (300, 1000, 128, 3),          # 3 spans of 384 keys, the last ragged
    (100, 200, 512, 4),           # one span of 200 keys: rounded to tiles
])
def test_v2_runs_h1_spans_then_h2(cuda_device, causal, lq, lkv, block_kv,
                                  tiles):
    """flash_attention_v2 on the card: one H1 launch over the spans, one H2
    launch; the partials' shape is JAX's (nkb spans of
    ``SplitKVConfig.kv_span``), causal spans wholly above a row's diagonal
    give (0, -inf), and O matches the plain version (bf16 O, the H1
    limit) and the f64 oracle."""
    q, k, v = _qkv(cuda_device, 2, 4, 2, lq, lkv, 128, seed=31)
    cfg = SplitKVConfig(block_q=1024, block_kv=block_kv,
                        kv_tiles_per_block=tiles)
    nkb = -(-lkv // cfg.kv_span(lkv))
    before = (prefill_attention.launches, splitkv_combine.launches)
    o_p, lse = flash_attention_splitkv_partial(q, k, v, config=cfg,
                                               causal=causal)
    o = flash_attention_v2(q, k, v, config=cfg, causal=causal)
    torch.cuda.synchronize()
    assert (prefill_attention.launches - before[0],
            splitkv_combine.launches - before[1]) == (2, 1)
    assert o_p.shape == (2, 4, nkb, lq, 128) and lse.shape == (2, 4, nkb,
                                                                 lq)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    o_ref = flash_attention_v2(q.cpu(), k.cpu(), v.cpu(), config=cfg,
                               causal=causal)
    assert (o.float().cpu() - o_ref.float()).abs().max().item() < O_TOL
    rep = lambda x: x.repeat_interleave(2, dim=1)            # noqa: E731
    oracle = naive_attention(q, rep(k), rep(v), causal=causal)
    assert np.abs(o.float().cpu().numpy() - oracle).max() < O_TOL
    _, lse_ref = flash_attention_splitkv_partial(q.cpu(), k.cpu(), v.cpu(),
                                                 config=cfg, causal=causal)
    dead = torch.isneginf(lse_ref)
    assert torch.equal(torch.isneginf(lse.cpu()), dead)
    assert (o_p.cpu()[dead] == 0).all()
    assert dead.any() == (causal and lkv > cfg.kv_span(lkv))


def test_v2_refuses_spans_off_h1_tiles(cuda_device):
    """Spans of 64 keys over a KV of 300 run on the CPU and raise on the
    card, naming the shapes, before any launch."""
    q, k, v = _qkv(cuda_device, 1, 2, 2, 64, 300, 64)
    cfg = SplitKVConfig(block_kv=64, kv_tiles_per_block=1)
    before = prefill_attention.launches
    with pytest.raises(ValueError, match=r"kv_span=64.*\(1, 2, 300, 64\)"):
        flash_attention_splitkv_partial(q, k, v, config=cfg)
    assert prefill_attention.launches == before
    o_p, _ = flash_attention_splitkv_partial(q.cpu(), k.cpu(), v.cpu(),
                                             config=cfg)
    assert o_p.shape[2] == 5


def _graph_sched(dev, cap, seed, hq=8, hkv=4, d=128, n_req=6):
    """A scheduler on the card with ``n_req`` requests of mixed prompt and
    output lengths (bf16 step inputs, new each step) for ``cap`` slots."""
    sched = ContinuousBatchingScheduler(hq, hkv, d, n_pages=48,
                                        page_size=128, max_seqs=cap,
                                        device=dev)
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(  # noqa: E731
        dev, torch.bfloat16)
    lens = [(300, 6), (129, 3), (40, 9), (500, 4), (77, 5), (256, 7)]
    for rid, (plen, n_new) in enumerate(lens[:n_req]):
        inputs = [(mk(hq, d), mk(hkv, d), mk(hkv, d)) for _ in range(n_new)]
        sched.submit(Request(rid, mk(plen, hkv, d), mk(plen, hkv, d), n_new,
                             lambda i, inputs=inputs: inputs[i]))
    return sched, {rid: n for rid, (_, n) in enumerate(lens[:n_req])}


def _clone_cache(cache):
    return dataclasses.replace(
        cache, kv_pages=cache.kv_pages.clone(),
        kv_scales=cache.kv_scales.clone(),
        page_table=cache.page_table.clone(), seq_lens=cache.seq_lens.clone())


def _caches_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("kv_pages", "kv_scales", "page_table", "seq_lens"))


def test_scheduler_step_graph_equals_the_eager_step(cuda_device):
    """Every step of the scheduler (the first eager, then its CUDA graph's
    replays) equals, bitwise, the eager fused step on a copy of the same
    cache and inputs, output and cache both; each step counts one
    H6-decode launch; the tickets are zero after the replays; a sync=False
    output stays as it was while later steps run; every page comes
    back."""
    sched, lens = _graph_sched(cuda_device, 4, seed=41)
    run = sched._run_fused_step
    seen = []

    def spy():
        b = sched._bufs
        copy = _clone_cache(sched.cache)
        eager = _fused_step(copy, b.q, b.k, b.v, b.append_ids,
                            b.decode_slots)
        before = paged_decode_partials.launches
        out = run()
        seen.append((paged_decode_partials.launches - before, eager, copy,
                     out.clone()))
        return out

    sched._run_fused_step = spy
    outs = []
    while sched.pending or sched.active:
        rids, out = sched.step(sync=False)
        outs.append((out, out.clone()))
        torch.cuda.synchronize()
        launches, eager, copy, got = seen[-1]
        assert launches == 1
        assert torch.equal(got, eager)
        assert _caches_equal(copy, sched.cache)
    assert sched._graph is not None and len(seen) > 5
    assert all(torch.equal(a, b) for a, b in outs)
    assert not sched._graph.tickets.any()
    assert not ticket_buffer(cuda_device).any()
    assert sched.completed == lens
    assert sched.allocator.free_pages == sched.allocator.n_pages


def test_graph_keeps_the_tickets_it_captured(cuda_device):
    """A graph holds the tickets buffer in place at its capture: a larger
    reservation later swaps in a new buffer, and the old graph still
    replays right (bitwise its eager output) on its own, zeroed buffer;
    a graph captured after the swap reads the new one; both replay in
    turns.  A capture that would need more tickets than are reserved
    raises."""
    cache, q, slots = _paged_case(cuda_device, 8, 4, 128, 128, DECODE_LENS)

    def decode(n):
        return lambda: paged_decode_attention(q[:n], cache, slots[:n])

    eager = [decode(n)() for n in (4, 8)]
    g4 = StepGraph(decode(4), cuda_device)
    old_ptr = g4.tickets.data_ptr()
    reserve_tickets(cuda_device, g4.tickets.numel() + 512)   # the swap
    new = ticket_buffer(cuda_device)
    assert new.data_ptr() != old_ptr
    torch.cuda.empty_cache()
    junk = torch.full((new.numel() * 64,), 7, dtype=torch.int32,
                      device=cuda_device)
    g8 = StepGraph(decode(8), cuda_device)
    assert g8.tickets is new and g4.tickets.data_ptr() == old_ptr
    for _ in range(3):
        assert torch.equal(g4.replay(), eager[0])
        assert torch.equal(g8.replay(), eager[1])
    torch.cuda.synchronize()
    assert not g4.tickets.any() and not new.any() and (junk == 7).all()
    big = _paged_case(cuda_device, 8, 4, 128, 128,
                      [10] * (new.numel() // 4 + 1))
    with pytest.raises(RuntimeError, match="reserve_tickets"):
        StepGraph(lambda: paged_decode_attention(big[1], big[0], big[2]),
                  cuda_device)


def _small_lm(dev, window=None):
    cfg = ModelConfig(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      d_model=256, d_head=64, d_ff=512, dtype=torch.bfloat16,
                      window=window)
    return cfg, init_params(cfg, seed=0, device=dev)


@pytest.mark.parametrize("window", [None, 100])
def test_generate_replays_a_graph_equal_to_the_eager_loop(cuda_device,
                                                          window):
    """``generate`` on the card: the first decode step of a batch eager,
    then its graph's replays; tokens bitwise those of a loop over
    ``_decode_forward`` (greedy), at every call; launches counted per
    replay (H1 n_layers, H6-decode n_layers per step); temperature
    sampling replays with the engine's generator registered and repeats
    from its seed."""
    cfg, params = _small_lm(cuda_device, window)
    eng = GenerationEngine(params, cfg, max_seqs=4, max_len=512)
    prompt = np.random.default_rng(0).integers(0, 512, (3, 150)).astype(
        np.int32)
    ref = eager_generate(eng, prompt, 12)
    for _ in range(2):
        before = (prefill_attention.launches, paged_decode_partials.launches)
        out = eng.generate(prompt, 12)
        assert (prefill_attention.launches - before[0],
                paged_decode_partials.launches - before[1]) == (2, 2 * 11)
        assert np.array_equal(out, ref)
    assert list(eng._graphs) == [(3, 0.0)]
    hot = [eng.generate(prompt, 12, temperature=0.9, seed=s)
           for s in (5, 5, 6)]
    assert list(eng._graphs) == [(3, 0.0), (3, 0.9)]
    assert np.array_equal(hot[0], hot[1]) and not np.array_equal(hot[0],
                                                                 hot[2])
    assert ((hot[0] >= 0) & (hot[0] < 512)).all()
    eng.generate(prompt, 8, hold=True)
    turn = np.random.default_rng(1).integers(0, 512, (3, 20))
    before = paged_decode_partials.launches
    eng.continue_generation(turn, 6)
    assert paged_decode_partials.launches - before == 2 * 5
    eng.release()
    assert eng.allocator.free_pages == eng.allocator.n_pages


@pytest.mark.parametrize("n_heads,n_kv_heads,d_head,page_size", [
    (16, 1, 80, 128), (4, 1, 256, 512), (16, 16, 72, 128), (8, 2, 36, 256)])
def test_generate_serves_new_head_geometries(cuda_device, n_heads,
                                             n_kv_heads, d_head, page_size):
    """A small LM at the rule's new head geometries (d_head 80 in a group
    of 16; d_head 256 with one KV head on 512-token pages; d_head 72, the
    heads72 model's geometry, and 36, rows no multiple of 16 bytes):
    ``generate``
    replays its decode graph bitwise the eager loop, with H1 and H6-decode
    counted per replay, and ``continue_generation`` runs H6-extend once a
    layer."""
    cfg = ModelConfig(vocab_size=512, n_layers=2, n_heads=n_heads,
                      n_kv_heads=n_kv_heads, d_model=256, d_head=d_head,
                      d_ff=512, dtype=torch.bfloat16)
    eng = GenerationEngine(init_params(cfg, seed=0, device=cuda_device), cfg,
                           max_seqs=4, max_len=1024, page_size=page_size)
    prompt = np.random.default_rng(0).integers(0, 512, (3, 150)).astype(
        np.int32)
    ref = eager_generate(eng, prompt, 12)
    for _ in range(2):
        before = (prefill_attention.launches, paged_decode_partials.launches)
        out = eng.generate(prompt, 12)
        assert (prefill_attention.launches - before[0],
                paged_decode_partials.launches - before[1]) == (2, 2 * 11)
        assert np.array_equal(out, ref)
    eng.generate(prompt, 8, hold=True)
    turn = np.random.default_rng(1).integers(0, 512, (3, 140))
    before = (paged_extend_attention.launches, paged_decode_partials.launches)
    out = eng.continue_generation(turn, 6)
    assert (paged_extend_attention.launches - before[0],
            paged_decode_partials.launches - before[1]) == (2, 2 * 5)
    assert ((out >= 0) & (out < 512)).all()
    eng.release()
    assert eng.allocator.free_pages == eng.allocator.n_pages


@pytest.mark.parametrize("window", [None, 48])
def test_generate_serves_d512_at_f32(cuda_device, window):
    """A small LM with heads512's attention (2 heads of 512 over one KV
    head) at f32, the JAX ModelConfig's default dtype, without and with a
    window: ``generate`` replays its decode graph bitwise the eager loop
    (H1 and H6-decode counted per replay), and ``continue_generation`` runs
    H6-extend once a layer; both turns' greedy tokens equal those of the
    same engine on the CPU (the plain path, on the same weights)."""
    cfg = ModelConfig(vocab_size=512, n_layers=2, n_heads=2, n_kv_heads=1,
                      d_model=256, d_head=512, d_ff=512, window=window,
                      dtype=torch.float32)
    params = init_params(cfg, seed=0, device=cuda_device)
    eng = GenerationEngine(params, cfg, max_seqs=4, max_len=512,
                           page_size=256)
    plain = GenerationEngine(tree_map(lambda t: t.cpu(), params), cfg,
                             max_seqs=4, max_len=512, page_size=256)
    prompt = np.random.default_rng(0).integers(0, 512, (3, 150)).astype(
        np.int32)
    ref = eager_generate(eng, prompt, 12)
    before = (prefill_attention.launches, paged_decode_partials.launches)
    out = eng.generate(prompt, 12)
    assert (prefill_attention.launches - before[0],
            paged_decode_partials.launches - before[1]) == (2, 2 * 11)
    assert np.array_equal(out, ref)
    assert np.array_equal(eng.generate(prompt, 8, hold=True),
                          plain.generate(prompt, 8, hold=True))
    turn = np.random.default_rng(1).integers(0, 512, (3, 140))
    before = (paged_extend_attention.launches, paged_decode_partials.launches)
    out = eng.continue_generation(turn, 6)
    assert (paged_extend_attention.launches - before[0],
            paged_decode_partials.launches - before[1]) == (2, 2 * 5)
    assert np.array_equal(out, plain.continue_generation(turn, 6))
    eng.release()
    plain.release()
    assert eng.allocator.free_pages == eng.allocator.n_pages


def _spec_state(eng, loop):
    state = [loop.pending, loop.count, loop.out, loop.rounds, loop.accepted,
             *[t for kv in loop.bufs for t in kv]]
    if loop.slot_pos is not None:
        state.append(loop.slot_pos)
    for cache in eng.tcaches + eng.dcaches:
        state += [cache.kv_pages, cache.kv_scales, cache.seq_lens]
    return state


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_spec_round_replay_after_rollback_equals_eager(cuda_device, mode):
    """A self-draft whose embedding is zeroed for one round (its logits all
    0: it proposes token 0, which the target rejects) and then restored
    (the next round accepts): the second round replayed from its CUDA
    graph against the same round run eagerly on a copy of every state
    tensor, bitwise (caches, lengths, counts, output, ring).  The plan of
    H6-decode captured with the graph reads no ``seq_lens``, so the
    rollback leaves it valid."""
    cfg, tparams = _small_lm(cuda_device)
    dparams = tree_map(torch.clone, tparams)
    eng = SpeculativeEngine(tparams, cfg, dparams, cfg, max_seqs=2,
                            max_len=512, draft_mode=mode)
    prompt = torch.from_numpy(np.random.default_rng(8).integers(
        0, 512, (2, 130)).astype(np.int32)).to(cuda_device)
    gamma = 4
    slots, mapped = eng._map(2)
    try:
        loop = eng._loop(2, gamma, 0.0)
        eng._prefill(loop, prompt, slots, 64, 0.0)
        embed = dparams["embed"].clone()
        dparams["embed"].zero_()
        eng._round(loop, slots, gamma, 0.0)                 # eager
        torch.cuda.synchronize()
        assert loop.count.tolist() == [2, 2]                # none accepted
        dparams["embed"].copy_(embed)
        graph = StepGraph(lambda: eng._round(loop, slots, gamma, 0.0),
                          cuda_device)
        state = _spec_state(eng, loop)
        saved = [t.clone() for t in state]
        eng._round(loop, slots, gamma, 0.0)
        eager = [t.clone() for t in state]
        for t, s in zip(state, saved):
            t.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert int(loop.accepted) > 0
        for t, e in zip(state, eager):
            assert torch.equal(t, e)
    finally:
        eng._release(mapped)


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_spec_generate_graphed_equals_eager(cuda_device, mode):
    """``SpeculativeEngine.generate`` on the card: greedy tokens of the
    graphed rounds bitwise those of every round eager, at every call;
    launches counted per replay (H1 per layer of both prefills, H6-extend
    per target layer a round, H6-decode gamma + 1 per draft layer a round
    with the paged draft); temperature replays with the engine's generator
    registered and repeats from its seed; every page comes back."""
    cfg, tparams = _small_lm(cuda_device)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = init_params(dcfg, seed=3, device=cuda_device)
    eng = SpeculativeEngine(tparams, cfg, dparams, dcfg, max_seqs=4,
                            max_len=512, draft_mode=mode, draft_window=64)
    prompt = np.random.default_rng(9).integers(0, 512, (3, 140)).astype(
        np.int32)
    eng.graphed = False
    ref, ref_stats = eng.generate(prompt, 20, gamma=3)
    eng.graphed = True
    for _ in range(2):
        before = (prefill_attention.launches, paged_decode_partials.launches,
                  paged_extend_attention.launches)
        out, stats = eng.generate(prompt, 20, gamma=3)
        rounds = int(stats["rounds"])
        assert (prefill_attention.launches - before[0],
                paged_decode_partials.launches - before[1],
                paged_extend_attention.launches - before[2]) == (
            3, 4 * rounds if mode == "paged" else 0, 2 * rounds)
        assert np.array_equal(out, ref) and stats == ref_stats
    hot = [eng.generate(prompt, 12, gamma=3, temperature=0.9, seed=s)[0]
           for s in (5, 5, 6)]
    assert np.array_equal(hot[0], hot[1]) and not np.array_equal(hot[0],
                                                                 hot[2])
    assert sorted(k[2] for k in eng._loops) == [0.0, 0.9]
    assert eng.t_alloc.free_pages == eng.t_alloc.n_pages


def test_spec_generate_serves_a_new_head_geometry(cuda_device):
    """``SpeculativeEngine`` with a target and a paged draft of d_head 80 in
    a GQA group of 16: the verify runs H6-extend at that geometry, the
    draft steps H6-decode; graphed rounds bitwise the eager ones, launches
    counted per replay."""
    cfg = ModelConfig(vocab_size=512, n_layers=2, n_heads=16, n_kv_heads=1,
                      d_model=256, d_head=80, d_ff=512, dtype=torch.bfloat16)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    eng = SpeculativeEngine(init_params(cfg, seed=0, device=cuda_device), cfg,
                            init_params(dcfg, seed=3, device=cuda_device),
                            dcfg, max_seqs=4, max_len=512, draft_mode="paged")
    prompt = np.random.default_rng(9).integers(0, 512, (3, 140)).astype(
        np.int32)
    eng.graphed = False
    ref, ref_stats = eng.generate(prompt, 20, gamma=3)
    eng.graphed = True
    before = (prefill_attention.launches, paged_decode_partials.launches,
              paged_extend_attention.launches)
    out, stats = eng.generate(prompt, 20, gamma=3)
    rounds = int(stats["rounds"])
    assert (prefill_attention.launches - before[0],
            paged_decode_partials.launches - before[1],
            paged_extend_attention.launches - before[2]) == (
        3, 4 * rounds, 2 * rounds)
    assert np.array_equal(out, ref) and stats == ref_stats
    assert eng.t_alloc.free_pages == eng.t_alloc.n_pages


def test_seq2seq_step_runs_h1_and_h3_across_lengths(cuda_device):
    """A seq2seq train step on the card: per step H1, H3-dkv and H3-dq
    once per encoder layer and twice per decoder layer (its causal
    self-attention and its cross attention without a mask at Lq = 96,
    Lkv = 200); the step-0 loss within 1e-3 and every gradient within
    6e-2 (||dg|| / ||g||) of the same model with the plain attention."""
    base = dataclasses.replace(_small_lm(cuda_device)[0], n_layers=1)
    cfg = Seq2SeqConfig(base=base, n_enc_layers=1, n_dec_layers=2)
    params = init_seq2seq_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(10)
    src = torch.from_numpy(rng.integers(0, 512, (2, 200)).astype(
        np.int32)).to(cuda_device)
    tgt = torch.from_numpy(rng.integers(0, 512, (2, 97)).astype(
        np.int32)).to(cuda_device)
    step, opt_init = make_seq2seq_train_step(cfg)
    opt = opt_init(params)
    leaves = tree_leaves(params)
    loss = seq2seq_loss(params, src, tgt, cfg)
    grads = torch.autograd.grad(loss, leaves)

    def plain(q, k, v, causal=False, config=None):
        o, _ = attention_plain(q, k, v, 1.0 / math.sqrt(q.shape[3]), causal,
                               k.shape[2] - q.shape[2])
        return o.to(q.dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(s2s, "flash_attention", plain)
        ref_loss = seq2seq_loss(params, src, tgt, cfg)
        ref = torch.autograd.grad(ref_loss, leaves)
    assert abs(loss.item() - ref_loss.item()) < 1e-3
    for g, r in zip(grads, ref):
        assert ((g.float() - r.float()).norm()
                / r.float().norm()).item() < 6e-2
    counted = (prefill_attention, attention_bwd_dkv, attention_bwd_dq)
    before = [fn.launches for fn in counted]
    step(params, opt, src, tgt)
    assert [fn.launches - n for fn, n in zip(counted, before)] == [5, 5, 5]


# ---------------------------------------------------------------- f32

F32_REFEREE_TOL = 1e-5
F32_TOL = 2e-5
F32_V2_TOL = 1e-4
F32_PAGED_TOL = 1e-5


def _f32_qkv(dev, b, hq, hkv, lq, lkv, d, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    return mk(b, hq, lq, d), mk(b, hkv, lkv, d), mk(b, hkv, lkv, d)


def _f64_plain(q, k, v, scale, causal, diag_off, window=None):
    return attention_plain(q.double(), k.double(), v.double(), scale, causal,
                           diag_off, window)


@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d,tol", [
    (2, 4, 4, 256, 256, 128, F32_REFEREE_TOL),   # the referee row
    (1, 16, 1, 200, 330, 16, F32_TOL),
    (1, 16, 1, 200, 330, 80, F32_TOL),
    (1, 16, 1, 200, 330, 256, F32_TOL),
    (2, 4, 2, 17, 17, 64, F32_TOL),              # below one tile
    (1, 4, 4, 80, 48, 32, F32_TOL),              # rows that see no key
    # rows of 16-byte loads at d=72 and 36, a float at a time at 33, 250
    (1, 16, 1, 200, 330, 72, F32_TOL),
    (1, 16, 1, 200, 330, 33, F32_TOL),
    (2, 4, 2, 100, 150, 36, F32_TOL),
    (1, 8, 4, 200, 330, 250, F32_TOL),
    # past 256: H5's f32 block in clusters of two, rows by TMA (264, 300,
    # 512) or staged (257, 385: rows of 4-byte alignment)
    (1, 16, 1, 200, 330, 257, F32_TOL),
    (2, 4, 2, 200, 330, 264, F32_TOL),
    (1, 8, 4, 200, 330, 300, F32_TOL),
    (1, 4, 4, 80, 48, 385, F32_TOL),             # rows that see no key
    (1, 16, 1, 200, 330, 512, F32_TOL),
])
@pytest.mark.parametrize("mode", ["none", "causal", "window"])
def test_h1_f32_matches_the_f64_plain_run(cuda_device, mode, b, hq, hkv, lq,
                                          lkv, d, tol):
    """H1 at f32 q/k/v: one launch, f32 O and LSE within the JAX package's
    f32 tier of the plain version run in f64 (the oracle) and in f32 (TF32
    off); the bf16 kernel on the same inputs rounded to bf16 reads beyond
    it."""
    causal, window = mode != "none", 64 if mode == "window" else None
    q, k, v = _f32_qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=d)
    scale = 1.0 / math.sqrt(d)
    before = prefill_attention.launches
    o, lse = prefill_attention(q, k, v, scale, lkv - lq, causal, window)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    ref, lse_ref = _f64_plain(q, k, v, scale, causal, lkv - lq, window)
    assert (o.double() - ref).abs().max().item() <= tol
    plain, _ = attention_plain(q, k, v, scale, causal, lkv - lq, window)
    assert (o - plain).abs().max().item() <= tol
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse.double()[fin] - lse_ref[fin]).abs().max().item() <= tol
    bad, _ = prefill_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                               scale, lkv - lq, causal, window,
                               out_dtype=torch.float32)
    assert (bad.double() - ref).abs().max().item() > tol


@pytest.mark.parametrize("d", [32, 80, 128, 256, 1, 33, 72, 250, 257, 264,
                               300, 385, 512])
def test_h1_f32_forms_spans_and_offsets(cuda_device, d):
    """H1 at f32 over KV spans (each span's partial and LSE), in the bound
    form and the 64-row Q tile (each within 2e-5 of the f64 run; the bf16
    O of an f32 call within bf16's rounding), and at traced offsets
    bitwise its static launch."""
    q, k, v = _f32_qkv(cuda_device, 2, 4, 2, 200, 700, d, seed=3)
    scale = 1.0 / math.sqrt(d)
    o, lse = prefill_attention(q, k, v, scale, 500, False, kv_span=256)
    for i, s in enumerate(range(0, 700, 256)):
        ref, lse_ref = _f64_plain(q, k[:, :, s:s + 256], v[:, :, s:s + 256],
                                  scale, False, 500 - s)
        assert (o[:, :, i].double() - ref).abs().max().item() <= F32_TOL
        assert (lse[:, :, i].double() - lse_ref).abs().max().item() <= F32_TOL
    ref, _ = _f64_plain(q, k, v, scale, True, 500)
    for cfg in (TileConfig(softmax="bound"), TileConfig(block_q=64)):
        o = flash_attention_v1(q, k, v, cfg, causal=True)
        assert o.dtype == torch.float32
        assert (o.double() - ref).abs().max().item() <= F32_TOL
    o16 = flash_attention_v1(q, k, v, causal=True, out_dtype=torch.bfloat16)
    assert ((o16.double() - ref).abs() <= 2 ** -8 * ref.abs() + 1e-6).all()
    pair = torch.tensor([500, 0], dtype=torch.int32, device=cuda_device)
    static = prefill_attention(q, k, v, scale, 500, True)
    traced = prefill_attention(q, k, v, scale, pair, True)
    assert torch.equal(static[0], traced[0])
    assert torch.equal(static[1], traced[1])


# the f32 core over long key counts: O sums hundreds of key tiles, each
# tile's P V in a fresh accumulator added to O in f32, so O stays within
# the small tier (a sum in one wgmma accumulator drifts with the tiles)
@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d,causal,window,softmax", [
    (2, 8, 8, 1024, 8200, 128, False, None, "exact"),   # TPU kernel B3's route
    (2, 8, 8, 1024, 8200, 128, False, None, "bound"),
    (2, 8, 8, 1024, 8200, 256, False, None, "exact"),   # 513 tiles of 16 keys
    (1, 8, 1, 256, 32768, 128, False, None, "exact"),   # the windowed model's
    (1, 8, 1, 256, 32768, 128, True, 4096, "exact"),    # keys and window
    (1, 4, 2, 512, 8200, 512, False, None, "exact"),    # 257 tiles of 32 keys
])
def test_h1_f32_over_long_key_counts(cuda_device, b, hq, hkv, lq, lkv, d,
                                     causal, window, softmax):
    """H1 at f32 over thousands of keys: one launch, O within 2e-5 of the
    f64 plain run and of the plain f32 version."""
    q, k, v = _f32_qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=lkv + d)
    scale = 1.0 / math.sqrt(d)
    before = prefill_attention.launches
    o, _ = prefill_attention(q, k, v, scale, lkv - lq, causal, window,
                             softmax=softmax)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    ref, _ = _f64_plain(q, k, v, scale, causal, lkv - lq, window)
    assert (o.double() - ref).abs().max().item() <= F32_TOL
    plain, _ = attention_plain(q, k, v, scale, causal, lkv - lq, window)
    assert (o - plain).abs().max().item() <= F32_TOL


def test_extend_f32_over_long_histories(cuda_device):
    """H6-extend at f32 q after 8,000 and 4,609 tokens, without and with
    the windowed model's window: within 1e-5 of the plain f32 version."""
    cache, q, slots = _paged_case(cuda_device, 8, 4, 128, 128, [8000, 4609],
                                  c=256)
    q = q.float() + torch.randn(q.shape, device=cuda_device) * 1e-3
    for window in (None, 4096):
        o = paged_extend_attention(q, cache, slots, window=window)
        ref = paged_extend_plain(q, cache, slots, 1.0 / math.sqrt(128),
                                 window)
        assert (o - ref).abs().max().item() <= F32_PAGED_TOL


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_kvquant_f32_over_8192_keys(cuda_device, kind):
    """H4-kvq with f32 q over 8192 keys (TPU kernel B16's route, blocks of
    128): within 2e-5 of the plain f32 version and of its f64 run."""
    q, k, v = _f32_qkv(cuda_device, 1, 4, 4, 1024, 8192, 128, seed=26)
    kq, vq = QUANT[kind](k, 128), QUANT[kind](v, 128)
    o = flash_attention_kvquant(q, kq, vq)
    scale = 1.0 / math.sqrt(128)
    assert _max_err(o, attention_kvquant_plain(q, kq, vq, scale)) <= F32_TOL
    assert _max_err(o, attention_kvquant_plain(q.double(), kq, vq,
                                               scale)) <= F32_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_v2_f32_runs_h1_spans_then_h2(cuda_device, causal):
    """flash_attention_v2 at f32: H1 1 (f32 spans) and H2 1, O f32 within
    1e-4 of the f64 run."""
    q, k, v = _f32_qkv(cuda_device, 2, 4, 4, 1024, 1024, 128, seed=5)
    before = (prefill_attention.launches, splitkv_combine.launches)
    o = flash_attention_v2(q, k, v, config=SplitKVConfig(
        block_q=1024, block_kv=512, kv_tiles_per_block=1), causal=causal)
    torch.cuda.synchronize()
    assert (prefill_attention.launches - before[0],
            splitkv_combine.launches - before[1]) == (1, 1)
    assert o.dtype == torch.float32
    ref, _ = _f64_plain(q, k, v, 1.0 / math.sqrt(128), causal, 0)
    assert (o.double() - ref).abs().max().item() <= F32_V2_TOL


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("hq,hkv,d,ps",
                         [(8, 4, 128, 128)] + PAGED_HEADS + PAGED_WIDE)
def test_decode_f32_matches_plain(cuda_device, hq, hkv, d, ps, window):
    """H6-decode at f32 q (fused, its runs merged in its last block): one
    launch, f32 O within 1e-5 of the plain f32 version and of the f64
    oracle over each sequence's dequantized cache (its band), the tickets
    zero after; the bf16 instance on q rounded to bf16 reads beyond it."""
    cache, q, slots = _paged_case(cuda_device, hq, hkv, d, ps, DECODE_LENS)
    q = q.float() + torch.randn(q.shape, device=cuda_device) * 1e-3
    before = paged_decode_partials.launches
    o = paged_decode_attention(q, cache, slots, window=window)
    torch.cuda.synchronize()
    assert paged_decode_partials.launches == before + 1
    assert o.dtype == torch.float32
    ref = paged_decode_plain(q, cache, slots, 1.0 / math.sqrt(d), window)
    assert (o - ref).abs().max().item() <= F32_PAGED_TOL
    assert not ticket_buffer(cuda_device).any()
    for s, n in enumerate(DECODE_LENS):
        if n == 0:                     # an empty sequence gives zeros
            assert not o[s].any()
            continue
        kf, vf = gather_kv(cache, s)
        lo = 0 if window is None else max(0, n - window)
        oracle = naive_attention(q[s].view(hkv, hq // hkv, d), kf[:, lo:n],
                                 vf[:, lo:n])
        got = o[s].view(hkv, hq // hkv, d).cpu().numpy()
        assert np.abs(got - oracle).max() <= F32_PAGED_TOL, s
    bad = paged_decode_attention(q.bfloat16(), cache, slots, window=window)
    assert (bad.float() - ref).abs().max().item() > F32_PAGED_TOL


@pytest.mark.parametrize("window", [None, 1, 77])
@pytest.mark.parametrize("hq,hkv,d,ps,hist,c", EXTEND_CASES[:3] + [
    (16, 1, 80, 512, [257, 600], 64), (8, 2, 256, 128, [130, 3], 40),
    (32, 1, 16, 1024, [5, 1100], 33)] + EXTEND_CASES[-5:] + EXTEND_WIDE)
def test_extend_f32_matches_plain(cuda_device, hq, hkv, d, ps, hist, c,
                                  window):
    """H6-extend at f32 q: one launch, f32 O within 1e-5 of the plain f32
    version and of the f64 oracle over the dequantized cache (the first,
    middle and last chunk rows); the bf16 kernel on q rounded to bf16
    reads beyond it."""
    cache, q, slots = _paged_case(cuda_device, hq, hkv, d, ps, hist, c=c)
    q = q.float() + torch.randn(q.shape, device=cuda_device) * 1e-3
    before = paged_extend_attention.launches
    o = paged_extend_attention(q, cache, slots, window=window)
    torch.cuda.synchronize()
    assert paged_extend_attention.launches == before + 1
    assert o.dtype == torch.float32
    ref = paged_extend_plain(q, cache, slots, 1.0 / math.sqrt(d), window)
    assert (o - ref).abs().max().item() <= F32_PAGED_TOL
    g = hq // hkv
    for s, n in enumerate(hist):
        kf, vf = gather_kv(cache, s)
        for i in (0, c // 2, c - 1):
            pos = n + i
            lo = 0 if window is None else max(0, pos - window + 1)
            oracle = naive_attention(q[s, i].view(hkv, g, d),
                                     kf[:, lo:pos + 1], vf[:, lo:pos + 1])
            got = o[s, i].view(hkv, g, d).cpu().numpy()
            assert np.abs(got - oracle).max() <= F32_PAGED_TOL, (s, i)
    bad = paged_extend_attention(q.bfloat16(), cache, slots, window=window)
    assert (bad.float() - ref).abs().max().item() > F32_PAGED_TOL


def test_generate_serves_an_f32_model(cuda_device):
    """A small LM at f32, the JAX package's default dtype: ``generate``
    replays its decode graph bitwise the eager loop, H1 and H6-decode
    counted per replay, and ``continue_generation`` runs H6-extend once a
    layer."""
    cfg = dataclasses.replace(_small_lm(cuda_device)[0], dtype=torch.float32)
    eng = GenerationEngine(init_params(cfg, seed=0, device=cuda_device), cfg,
                           max_seqs=4, max_len=512)
    prompt = np.random.default_rng(0).integers(0, 512, (3, 150)).astype(
        np.int32)
    ref = eager_generate(eng, prompt, 12)
    for _ in range(2):
        before = (prefill_attention.launches, paged_decode_partials.launches)
        out = eng.generate(prompt, 12)
        assert (prefill_attention.launches - before[0],
                paged_decode_partials.launches - before[1]) == (2, 2 * 11)
        assert np.array_equal(out, ref)
    eng.generate(prompt, 8, hold=True)
    turn = np.random.default_rng(1).integers(0, 512, (3, 40))
    before = (paged_extend_attention.launches, paged_decode_partials.launches)
    out = eng.continue_generation(turn, 6)
    assert (paged_extend_attention.launches - before[0],
            paged_decode_partials.launches - before[1]) == (2, 2 * 5)
    assert ((out >= 0) & (out < 512)).all()
    eng.release()


# H3 at f32 q, k, v and dO (bf16x6 on wgmma, P and dS kept f32): within
# 1e-4 of max|ref| per gradient of the plain f32 backward (TF32 off), the
# rtol of the JAX package's f32 GQA backward test
# (tests/test_attention_bwd.py:180); a CPU emulation of the kernels'
# arithmetic reads <= 5.8e-7 of f64 autograd and the bf16 kernels on the
# inputs rounded to bf16 2.8e-3 and more (tests/test_torch_bwd_f32.py)
F32_BWD_REL_TOL = 1e-4


@pytest.mark.parametrize("b,hq,hkv,lq,lkv,d,diag_off", [
    (8, 8, 4, 1024, 1024, 128, 0),    # the f32 flagship's training slice
    (2, 8, 4, 200, 216, 128, 16),     # ragged, Lq != Lkv
    (1, 16, 1, 129, 200, 80, 71),     # a group of 16, D=128's zero columns
    (1, 4, 2, 300, 300, 16, -40),     # d=16 on D=64, rows that see no key
    (2, 4, 4, 100, 100, 64, 0),       # d = D = 64
    (1, 4, 2, 77, 130, 32, 53),       # d=32 on D=64, ragged, G=2
    (2, 4, 1, 136, 150, 144, 14),     # d=144: the cluster's zero columns
    (1, 4, 1, 300, 260, 256, -40),    # d = D = 256, rows that see no key
    (1, 4, 2, 129, 200, 256, 71),     # d=256, ragged, G=2
    # d off the multiples of 16, GQA 8/2, ragged and cross: rows read a
    # float at a time at d % 4 != 0 (1, 33, 250), by 16-byte loads else;
    # 136, 200 and 250 leave the cluster's second block 8, 72 and 122
    # columns
    *[(2, 8, 2, 200, 330, d, 130)
      for d in (1, 33, 36, 40, 72, 100, 136, 200, 250)],
])
@pytest.mark.parametrize("mask", list(BWD_MASKS))
def test_bwd_f32_matches_the_plain_f32_backward(cuda_device, mask, b, hq,
                                                hkv, lq, lkv, d, diag_off):
    """H3-dkv and H3-dq at f32: one launch each, f32 gradients within
    F32_BWD_REL_TOL of the plain f32 backward; the bf16 kernels on the
    inputs rounded to bf16 read beyond it; rows that see no key get zero
    dQ, keys no row sees zero dK and dV."""
    causal, window = BWD_MASKS[mask]
    q, k, v = _f32_qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=d)
    do = _f32_qkv(cuda_device, b, hq, hkv, lq, lkv, d, seed=d + 1)[0]
    scale = 1.0 / math.sqrt(d)
    out, lse = prefill_attention(q, k, v, scale, diag_off, causal, window)
    kw = dict(scale=scale, causal=causal, static_positions=(diag_off, 0),
              window=window)
    before = (attention_bwd_dkv.launches, attention_bwd_dq.launches)
    grads = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert (attention_bwd_dkv.launches, attention_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    ref = attention_bwd_plain(q, k, v, out, do, lse, scale, causal,
                              diag_off, window)
    bad = flash_attention_bwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), out,
                              do.bfloat16(), lse, **kw)
    for name, got, want, wrong in zip(("dq", "dk", "dv"), grads, ref, bad):
        assert got.dtype == torch.float32, name
        assert torch.isfinite(got).all(), name
        assert _rel(got, want) <= F32_BWD_REL_TOL, name
        assert _rel(wrong, want) > F32_BWD_REL_TOL, name
    dq, dk, dv = grads
    if causal and diag_off < 0:       # rows that see no key: zero dQ
        assert (dq[:, :, :-diag_off] == 0).all()
    if causal and lkv > lq + diag_off:    # keys no row sees: zero dK, dV
        assert (dk[:, :, lq + diag_off:] == 0).all()
        assert (dv[:, :, lq + diag_off:] == 0).all()


@pytest.mark.parametrize("d", [144, 256, 72, 33, 250])
@pytest.mark.parametrize("pos,mask", [
    ((256, 256), "causal"),        # a ring's diagonal hop
    ((0, 300), "causal"),          # a hop wholly in the future: no key
    ((300, 0), "causal"),          # a past hop: every key
    ((100, 37), "window"),         # a band off the diagonal
])
def test_bwd_f32_traced_offsets_equal_the_static_launch(cuda_device, pos,
                                                        mask, d):
    """H3 at f32 at traced positions is bitwise its static launch, on the
    D=256 instance (a cluster of two blocks) and at d off the multiples of
    16 (72; 33 and 250, rows read a float at a time); a hop that sees no
    key gives zero gradients."""
    causal, window = BWD_MASKS[mask]
    diag = pos[0] - pos[1]
    q, k, v = _f32_qkv(cuda_device, 2, 8, 4, 300, 300, d, seed=d)
    do = _f32_qkv(cuda_device, 2, 8, 4, 300, 300, d, seed=d + 1)[0]
    scale = 1.0 / math.sqrt(d)
    out, lse = prefill_attention(q, k, v, scale, diag, causal, window)
    lse = torch.where(torch.isneginf(lse), 5.0, lse)   # a ring's global LSE
    offs = torch.tensor(pos, dtype=torch.int32, device=q.device)
    bwd = [flash_attention_bwd(q, k, v, out, do, lse, scale=scale,
                               causal=causal, window=window, **kw)
           for kw in ({"positions": (offs[0], offs[1])},
                      {"static_positions": pos})]
    assert all(torch.equal(a, b) for a, b in zip(*bwd))
    if pos == (0, 300):
        assert all((g == 0).all() for g in bwd[0])


@pytest.mark.parametrize("d", [144, 256])
@pytest.mark.parametrize("mask", BWD_MASKS)
def test_bwd_f32_is_bitwise_reproducible(cuda_device, mask, d):
    """Repeated calls of H3 at f32 on the cluster instance are bitwise
    equal: both blocks of a cluster add the same two partials of S and
    dP, and no sum is ordered by the schedule."""
    causal, window = BWD_MASKS[mask]
    q, k, v = _f32_qkv(cuda_device, 2, 8, 4, 520, 520, d, seed=3)
    do = _f32_qkv(cuda_device, 2, 8, 4, 520, 520, d, seed=4)[0]
    scale = 1.0 / math.sqrt(d)
    out, lse = prefill_attention(q, k, v, scale, 0, causal, window)
    first = flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                window=window)
    for _ in range(3):
        for a, b in zip(first, flash_attention_bwd(q, k, v, out, do, lse,
                                                   causal=causal,
                                                   window=window)):
            assert torch.equal(a, b)


def test_train_step_trains_an_f32_model(cuda_device):
    """``make_train_step`` on a small LM at f32: H1, H3-dkv and H3-dq once
    a layer a step, f32 gradients, the loss falling over 3 AdamW steps;
    the step-0 gradients within 1e-4 of each leaf's norm of the same
    model with the plain attention."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        loss_fn,
        named_param_leaves,
    )
    from exploring_flash_attention_tpu_torch.models import (
        transformer as transformer_module,
    )

    cfg = dataclasses.replace(_small_lm(cuda_device)[0], dtype=torch.float32)
    params = make_trainable(init_params(cfg, seed=0, device=cuda_device))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 257)).astype(np.int32)).to(cuda_device)
    _, leaves = zip(*named_param_leaves(params))

    def grads():
        loss = loss_fn(params, tokens[:, :-1], tokens[:, 1:], cfg)
        return torch.autograd.grad(loss, leaves)

    def plain(q, k, v, config=None, causal=True, window=None):
        o, _ = attention_plain(q, k, v, 1.0 / math.sqrt(q.shape[3]), causal,
                               k.shape[2] - q.shape[2], window)
        return o

    got = grads()
    with mock.patch.object(transformer_module, "flash_attention", plain):
        ref = grads()
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert ((g - r).norm() / r.norm()).item() < 1e-4
    step, opt_init = make_train_step(cfg)
    opt = opt_init(params)
    counted = (prefill_attention, attention_bwd_dkv, attention_bwd_dq)
    losses = []
    for _ in range(3):
        before = [fn.launches for fn in counted]
        losses.append(step(params, opt, tokens).item())
        assert [fn.launches - n for fn, n in zip(counted, before)] == [2] * 3
    assert losses[2] < losses[1] < losses[0]


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("lq,lkv,d,block", [
    (256, 256, 128, 128),         # tests/test_quant.py:54's shape
    (200, 1100, 128, 100),        # ragged Q and KV, a ragged last block
    (130, 300, 64, 48),           # d=64, blocks that split the 32-key tiles
] + [(200, 1100, d, 100) for d in (16, 80, 144, 256)] + [
    # d off the multiples of 16: code rows read at their alignment
    (200, 1100, d, 100) for d in (1, 8, 33, 40, 72, 100, 250)
])
def test_kvquant_f32_matches_plain(cuda_device, kind, lq, lkv, d, block):
    """H4-kvq with f32 q: one launch of its f32 form, f32 O within 2e-5
    of the plain f32 version and of its f64 run."""
    q, k, v = _f32_qkv(cuda_device, 2, 4, 4, lq, lkv, d, seed=24)
    kq, vq = QUANT[kind](k, block), QUANT[kind](v, block)
    before = flash_attention_kvquant.launches
    o = flash_attention_kvquant(q, kq, vq)
    torch.cuda.synchronize()
    assert flash_attention_kvquant.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == q.shape
    scale = 1.0 / math.sqrt(d)
    assert _max_err(o, attention_kvquant_plain(q, kq, vq, scale)) <= F32_TOL
    assert _max_err(o, attention_kvquant_plain(q.double(), kq, vq,
                                               scale)) <= F32_TOL
    assert flash_attention_kvquant(
        q, kq, vq, out_dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("lq,lkv,d,block", [
    (256, 256, 512, 128),
    # Lq and Lkv off the 64-row and 32-key tiles, at every warpgroup count
    (100, 130, 128, 64),
    (65, 191, 256, 48),
    (70, 150, 384, 64),
    (130, 200, 512, 100),
    # head dims off the 128-column chunks, clusters of 2, 4 and 8 blocks
    (100, 130, 64, 64),
    (65, 191, 144, 48),
    (130, 200, 640, 100),
    (70, 150, 1024, 64),
    (65, 191, 2048, 48),
] + [
    # d off the multiples of 16: f32 rows staged where d % 4 != 0, codes
    # where d % 16 != 0 (the STAGED instances); O stored a value at a time
    # where d % 8 != 0
    (100, 130, d, 64) for d in (1, 8, 33, 36, 40, 72, 100, 250)
] + [(65, 191, 520, 48), (70, 150, 1000, 64), (65, 191, 2040, 100)])
def test_dtiled_f32_matches_plain(cuda_device, kind, lq, lkv, d, block):
    """H5 with f32 q (and f32 K/V, or int8 or e4m3 ones): one launch of
    its f32 form, f32 O within 2e-5 of the plain f32 version and of its
    f64 run."""
    q, k, v = _f32_qkv(cuda_device, 1, 2, 2, lq, lkv, d, seed=25)
    if kind != "f32":
        k, v = QUANT[kind](k, block), QUANT[kind](v, block)
    before = flash_attention_v1_dtiled.launches
    o = flash_attention_v1_dtiled(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_v1_dtiled.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == q.shape
    scale = 1.0 / math.sqrt(d)
    q64 = q.double()
    k64, v64 = (k.double(), v.double()) if kind == "f32" else (k, v)
    assert _max_err(o, attention_dtiled_plain(q, k, v, scale)) <= F32_TOL
    assert _max_err(o, attention_dtiled_plain(q64, k64, v64,
                                              scale)) <= F32_TOL


@pytest.mark.parametrize("d", [384, 1024, 2048])
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_dtiled_f32_is_bitwise_reproducible(cuda_device, kind, d):
    """H5 f32 in clusters of 2, 4 and 8 blocks: the ranks' partials of S
    added in rank order, so two runs give the same bits."""
    q, k, v = _f32_qkv(cuda_device, 2, 4, 4, 300, 330, d, seed=27)
    if kind != "f32":
        k, v = QUANT[kind](k, 64), QUANT[kind](v, 64)
    first = flash_attention_v1_dtiled(q, k, v)
    second = flash_attention_v1_dtiled(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("lkv", [1024, 32768])
def test_dtiled_f32_over_long_key_counts(cuda_device, lkv):
    """H5 f32 at d=512 (a cluster of two blocks) over up to 32768 keys:
    each 32-key tile's P V from a fresh accumulator, so O stays within
    2e-5 of the f64 plain run."""
    q, k, v = _f32_qkv(cuda_device, 1, 8, 8, 1024, lkv, 512, seed=lkv)
    before = flash_attention_v1_dtiled.launches
    o = flash_attention_v1_dtiled(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_v1_dtiled.launches == before + 1
    scale = 1.0 / math.sqrt(512)
    assert _max_err(o, attention_dtiled_plain(q.double(), k.double(),
                                              v.double(), scale)) <= F32_TOL
