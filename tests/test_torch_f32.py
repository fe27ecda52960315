"""f32 serving on the port: what H1, H6-decode and H6-extend compute at
f32 inputs, rehearsed on the CPU, and the f32 flagship against JAX.

The JAX package's default dtype is f32 (``models/transformer.py:59``), and
its kernels compute f32 at f32 accuracy: HIGHEST wherever an operand is
f32 (``ops/attention_v1.py:202-210``), q's dtype in the paged kernels
(``serving/decode.py:700,793``).  On the card the port runs f32 through
``csrc/f32_attention.cuh`` (H1, H6-extend) and H6-decode's f32 instances.
The f32 core is Mosaic's HIGHEST on bf16 wgmma: each f32 operand split
exactly into three bf16 pieces (hi, mid, lo), a product the sum of six
piece products, smallest first (bf16x6, H1), or of three where the other
operand is exact in bf16 (bf16x3 against H6-extend's int8 codes).
H6-decode is f32 FMA on the CUDA cores.  Nothing is rounded to TF32.

The emulations below repeat that arithmetic in f32 torch ops, tile by tile
as the kernels walk the keys (32-key tiles for the f32 core, 16 for H1 at
d > 128; 128-token tiles in runs merged by their LSEs for H6-decode): the
piece products, the running max in the exp2 basis, p = exp2(s - m), l
summing the unscaled p, O = alpha O + (p * v_scale) V, where the f32 core
computes each tile's P V from zero (a fresh accumulator) before the f32
add.  The limits are the JAX package's own:

- H1 against the f64 oracle: 1e-5 at ``bench/suite.py``'s referee shape
  (B=2, H=4, L=256, d=128) under no mask, causal and a window of 64
  (``bench/suite.py:105-133``), 2e-5 at ``test_v1_f32_small``'s shape
  (``tests/test_attention_v1.py:24-27``) and at d 16, 80 and 256 on a GQA
  group of 16.  A known-wrong control, the same inputs rounded to bf16
  (what a kernel that cast f32 to bf16 would compute), reads beyond each.
- The paged pair within 1e-6 of their plain f32 versions (the same
  function, summed in another order), and within 1e-5 of B20-B22 in
  interpret mode, as ``tests/test_torch_extend.py`` holds the plain
  versions (both f32, O a convex combination of O(1) values).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.models import generate as jgen
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.ops import (
    flash_attention_v1 as jax_flash_attention_v1,
)
from exploring_flash_attention_tpu.serving import decode as jdec
from exploring_flash_attention_tpu.serving import kv_cache as jkv
from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    ModelConfig,
    init_params,
    params_from_jax,
)
from exploring_flash_attention_tpu_torch.ops.attention import (
    KERNEL_DTYPES,
    LOG2E,
    flash_attention,
    hidden_keys,
    kernel_dtype,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
    flash_attention_v1,
)
from exploring_flash_attention_tpu_torch.oracle import (
    make_qkv,
    naive_attention,
)
from exploring_flash_attention_tpu_torch.serving import (
    append_chunks,
    append_prompts,
    decode_chunks,
    decode_split,
    make_cache,
    paged_decode_attention,
    paged_decode_plain,
    paged_extend_attention,
    paged_extend_plain,
)
from f32_pieces import (  # noqa: F401 (one_torch_thread: autouse)
    BF16X3,
    BF16X6,
    one_torch_thread,
    piece_products,
    tc_piece_products,
)

F32_CORE_TILE = 32               # keys per K/V tile of csrc/f32_attention.cuh
H1_F32_TILE_D256 = 16            # H1's tile at d > 128 (three pieces of K, V)
DECODE_TILE = 128                # tokens per stage of csrc/paged_decode.cu
REFEREE_TOL = 1e-5
SMALL_TOL = 2e-5
PLAIN_TOL = 1e-6
JAX_TOL = 1e-5


def _online(s2, v, pv_scale=None, tile=F32_CORE_TILE, terms=None):
    """The kernels' loop over key tiles in f32: s2 [..., R, N] scores in
    the exp2 basis (-inf where hidden), v [..., N, d], pv_scale [..., N]
    (H6's v_scale, by which P is multiplied before P V); ``terms``: each
    tile's P V as the f32 core's piece products from zero, then added to
    alpha O in f32, else one f32 product (H6-decode).  Returns O
    unnormalized, each row's max m (exp2 basis) and its sum l."""
    shape = s2.shape[:-1]
    m = torch.full(shape, float("-inf"))
    l_row = torch.zeros(shape)
    o = torch.zeros(*shape, v.shape[-1])
    for j in range(0, s2.shape[-1], tile):
        st = s2[..., j:j + tile]
        m_new = torch.maximum(m, st.amax(dim=-1))
        m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(st - m_use[..., None])
        l_row = l_row * alpha + p.sum(dim=-1)
        if pv_scale is not None:
            p = p * pv_scale[..., None, j:j + tile]
        vt = v[..., j:j + tile, :]
        if terms is None:
            o = o * alpha[..., None] + p @ vt
        else:
            o = o * alpha[..., None] + piece_products(0.0, p, vt, terms)
        m = m_new
    return o, m, l_row


def _normalize(o, m, l_row):
    """(O / l, lse) as the kernels store them: a row that saw nothing
    gives (0, -inf)."""
    seen = l_row > 0
    lse = torch.where(seen, m * math.log(2.0) + torch.log(l_row),
                      float("-inf"))
    return o / torch.where(seen, l_row, 1.0)[..., None], lse


def emulate_h1_f32(q, k, v, scale, causal=False, window=None):
    """H1's f32 kernel (``prefill_attention_f32_kernel``) on the CPU: f32
    q/k/v [B, H, L, d] (GQA by repeat), S = Q K^T in bf16x6, times scale *
    log2(e) in f32, the decode-convention mask, then :func:`_online` over
    the kernel's tiles with P V in bf16x6.  Returns (o f32, lse f32)."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    s = piece_products(0.0, q.float(), kf.transpose(-1, -2), BF16X6)
    s2 = s * scale_log2
    hidden = hidden_keys(q.shape[2], k.shape[2], causal,
                         k.shape[2] - q.shape[2], window, q.device)
    if hidden is not None:
        s2 = s2.masked_fill(hidden, float("-inf"))
    tile = H1_F32_TILE_D256 if q.shape[-1] > 128 else F32_CORE_TILE
    return _normalize(*_online(s2, vf, tile=tile, terms=BF16X6))


def _f32_inputs(b, hq, hkv, lq, lkv, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(b, hq, lq, d), mk(b, hkv, lkv, d), mk(b, hkv, lkv, d)


def _oracle(q, k, v, causal, window):
    group = q.shape[1] // k.shape[1]
    return naive_attention(q, np.repeat(k, group, axis=1),
                           np.repeat(v, group, axis=1), causal=causal,
                           window=window)


def _h1_errors(q, k, v, causal, window):
    """max|O - oracle| of the f32 emulation and of its bf16-rounded
    control, on the f32 inputs q, k, v (NumPy)."""
    oracle = _oracle(q, k, v, causal, window)
    scale = 1.0 / math.sqrt(q.shape[-1])
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, _ = emulate_h1_f32(*t, scale, causal, window)
    rounded = [x.bfloat16().float() for x in t]
    o_ctl, _ = emulate_h1_f32(*rounded, scale, causal, window)
    return (np.abs(o.numpy() - oracle).max(),
            np.abs(o_ctl.numpy() - oracle).max())


@pytest.mark.parametrize("mode", ["none", "causal", "window"])
def test_h1_f32_emulation_meets_the_referee_tier(mode):
    """bench/suite.py's referee row (B=2, H=4, L=256, d=128; window 64):
    1e-5 against the f64 oracle, the bf16-rounded control beyond it."""
    causal, window = mode != "none", 64 if mode == "window" else None
    err, ctl = _h1_errors(*_f32_inputs(2, 4, 4, 256, 256, 128, seed=0),
                          causal, window)
    assert err < REFEREE_TOL < ctl, (err, ctl)


def test_h1_f32_emulation_meets_the_small_tier():
    """``test_v1_f32_small``'s inputs: 2e-5 against the f64 oracle."""
    q, k, v = make_qkv(1, 2, 256, 128, dtype=np.float32, seed=0)
    err, ctl = _h1_errors(q, k, v, False, None)
    assert err < SMALL_TOL < ctl, (err, ctl)


@pytest.mark.parametrize("d", [16, 80, 256])
@pytest.mark.parametrize("mode", ["none", "causal", "window"])
def test_h1_f32_emulation_at_new_head_dims(d, mode):
    """A GQA group of 16 (Hq=16, Hkv=1), ragged and cross (Lq=200,
    Lkv=330, window 100): 2e-5 against the f64 oracle."""
    causal, window = mode != "none", 100 if mode == "window" else None
    err, ctl = _h1_errors(*_f32_inputs(1, 16, 1, 200, 330, d, seed=d),
                          causal, window)
    assert err < SMALL_TOL < ctl, (err, ctl)


def _tensor_core_errors(lkv, window, rows=64, d=128, seed=0):
    """max|O - oracle| of H1 f32's P V in both orders under the tensor
    core model (``f32_pieces.tc_add``), on one head: the last ``rows``
    query rows (one consumer warpgroup) over ``lkv`` keys, d=128, causal
    under ``window``, else no mask.  S (also under the model) and the
    online softmax as :func:`emulate_h1_f32`, over the tiles the kernel
    visits (from the first that a row's window reaches).  Returns {one
    accumulator: error, fresh: error}: every tile's P V piece products
    added into O's one accumulator after O *= alpha (the kernel before),
    or each tile's P V in a fresh accumulator, then O = alpha O + part in
    f32 (the kernel now)."""
    q, k, v = _f32_inputs(1, 1, 1, rows, lkv, d, seed)
    oracle = _oracle(q, k, v, window is not None, window)[0, 0]
    diag = lkv - rows
    lo = max(diag - window + 1, 0) // F32_CORE_TILE * F32_CORE_TILE \
        if window else 0
    qt, kt, vt = (torch.from_numpy(x[0, 0]) for x in (q, k, v))
    kt, vt = kt[lo:], vt[lo:]
    s = tc_piece_products(None, qt, kt.T.contiguous(), BF16X6)
    s2 = s * torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    hidden = hidden_keys(rows, lkv, window is not None, diag, window,
                         qt.device)
    if hidden is not None:
        s2 = s2.masked_fill(hidden[..., lo:], float("-inf"))
    errs = {}
    for order in ("one accumulator", "fresh"):
        m = torch.full((rows,), float("-inf"))
        l_row, o = torch.zeros(rows), torch.zeros(rows, d)
        for j in range(0, s2.shape[-1], F32_CORE_TILE):
            st = s2[:, j:j + F32_CORE_TILE]
            m_new = torch.maximum(m, st.amax(dim=-1))
            m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
            alpha = torch.exp2(m - m_use)[:, None]
            p = torch.exp2(st - m_use[:, None])
            l_row = l_row * alpha[:, 0] + p.sum(dim=-1)
            vj = vt[j:j + F32_CORE_TILE]
            if order == "fresh":
                part = tc_piece_products(None, p, vj, BF16X6)
                o = (o.double() * alpha.double() + part.double()).float()
            else:
                o = tc_piece_products(o * alpha, p, vj, BF16X6)
            m = m_new
        errs[order] = np.abs((o / l_row[:, None]).numpy() - oracle).max()
    return errs


@pytest.mark.parametrize("lkv,window", [(8192, None), (32768, 4096)])
def test_fresh_pv_accumulator_reads_nearer_the_oracle(lkv, window):
    """Under the tensor core model, O summed in one wgmma accumulator over
    every key tile reads further from the f64 oracle than each tile's P V
    in a fresh accumulator added in f32 (over twice as far), and the fresh
    order stays within the small tier: 8192 keys, and the windowed
    model's 32768 keys under its window of 4096."""
    errs = _tensor_core_errors(lkv, window)
    assert errs["fresh"] < SMALL_TOL, errs
    assert errs["one accumulator"] > 2 * errs["fresh"], errs


@pytest.mark.parametrize("mode", ["none", "causal", "window"])
def test_port_f32_v1_matches_jax_f32(mode):
    """``flash_attention_v1`` at f32 through both packages (the port's
    plain path, JAX's Pallas kernels in interpret mode at HIGHEST) and
    the f32 emulation, at the referee shape: each pair within 1e-5."""
    causal, window = mode != "none", 64 if mode == "window" else None
    q, k, v = _f32_inputs(2, 4, 4, 256, 256, 128, seed=1)
    ref = np.asarray(jax_flash_attention_v1(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = flash_attention_v1(*t, causal=causal, window=window)
    assert got.dtype == torch.float32
    emu, _ = emulate_h1_f32(*t, 1.0 / math.sqrt(128), causal, window)
    assert np.abs(got.numpy() - ref).max() < REFEREE_TOL
    assert np.abs(emu.numpy() - ref).max() < REFEREE_TOL


# ---------------------------------------------------------------- paged

PS = 128


def _fill_both(seed, hkv, d, hist, c):
    """The same ragged prompts (and, with ``c``, one C-token chunk) in a
    JAX and a port cache, slot s on pages in a permuted order."""
    b = len(hist)
    max_pages = -(-(max(hist) + c) // PS) + 1
    rng = np.random.default_rng(seed)
    table = np.stack([np.roll(np.arange(max_pages), s + 1) + max_pages * s
                      for s in range(b)]).astype(np.int32)
    jc = jkv.make_cache(hkv, d, b * max_pages, page_size=PS, max_seqs=b,
                        max_pages_per_seq=max_pages)
    jc = jkv.PagedKVCache(jc.kv_pages, jc.kv_scales, jnp.asarray(table),
                          jc.seq_lens, jc.page_size, jc.head_pack)
    tc = make_cache(hkv, d, b * max_pages, page_size=PS, max_seqs=b,
                    max_pages_per_seq=max_pages, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    slots = np.arange(b, dtype=np.int32)
    tslots = torch.from_numpy(slots)
    for s, n in enumerate(hist):
        kp, vp = (rng.standard_normal((1, n, hkv, d)).astype(np.float32)
                  for _ in range(2))
        jc = jkv.append_prompts(jc, jnp.asarray(slots[s:s + 1]),
                                jnp.asarray(kp), jnp.asarray(vp))
        append_prompts(tc, tslots[s:s + 1], torch.from_numpy(kp),
                       torch.from_numpy(vp))
    if c:
        kc, vc = (rng.standard_normal((b, c, hkv, d)).astype(np.float32)
                  for _ in range(2))
        jc = jkv.append_chunks(jc, jnp.asarray(slots), jnp.asarray(kc),
                               jnp.asarray(vc))
        append_chunks(tc, tslots, torch.from_numpy(kc), torch.from_numpy(vc))
    return jc, tc, slots


def _paged_scores(q, cache, slots, scale, window, terms=None):
    """What the paged kernels read, gathered: S [B, Hkv, C*G, N] in the
    exp2 basis (q . codes times k_scale * scale * log2(e), -inf where
    hidden; q . codes as the piece products of ``terms``, else one f32
    product), the V codes [B, Hkv, N, d], v_scale [B, Hkv, N] and each
    row's position [B, C*G]; q [B, C, Hq, d]."""
    b, c, hq, d = q.shape
    hkv, ps = cache.num_kv_heads, cache.page_size
    group = hq // hkv
    table = cache.page_table[slots.long()].long()
    lens = cache.seq_lens[slots.long()].long()
    n_cols = table.shape[1] * ps

    def per_head(x):
        return x.transpose(1, 2).reshape(b, hkv, n_cols, *x.shape[4:])

    codes = cache.kv_pages[table].float()
    sc = cache.kv_scales[table][:, :, :, :, 0, :]
    k, v = per_head(codes[:, :, 0]), per_head(codes[:, :, 1])
    k_scale, v_scale = per_head(sc[:, :, 0]), per_head(sc[:, :, 1])
    qg = q.reshape(b, c, hkv, group, d).transpose(1, 2).reshape(
        b, hkv, c * group, d)
    kc = k_scale * torch.tensor(scale * LOG2E, dtype=torch.float32)
    kt = k.transpose(-1, -2)
    s = qg @ kt if terms is None else piece_products(0.0, qg, kt, terms)
    s2 = s * kc[:, :, None]
    pos = lens[:, None] - c + torch.arange(c * group) // group
    col = torch.arange(n_cols)
    hidden = col > pos[:, :, None]
    if window is not None:
        hidden |= col < pos[:, :, None] - window + 1
    return s2.masked_fill(hidden[:, None], float("-inf")), v, v_scale, pos


def emulate_extend_f32(q, cache, slots, scale, window=None):
    """H6-extend's f32 kernel on the CPU: the f32 core over 32-key tiles,
    q . codes and (P * v_scale) . codes in bf16x3; o f32 [B, C, Hq, d]."""
    b, c, hq, d = q.shape
    s2, v, v_scale, _ = _paged_scores(q, cache, slots, scale, window,
                                      BF16X3)
    o, _ = _normalize(*_online(s2, v, v_scale, terms=BF16X3))
    hkv = cache.num_kv_heads
    return o.reshape(b, hkv, c, hq // hkv, d).transpose(1, 2).reshape(
        b, c, hq, d)


def emulate_decode_f32(q, cache, slots, scale, window=None):
    """H6-decode's f32 instances on the CPU: the runs of
    ``decode_split`` (132 SMs), each over 128-token tiles, P * v_scale in
    f32, each run's partial (O / l, its LSE) merged as lse_merge.cuh
    merges them; o f32 [B, Hq, d]."""
    b, hq, d = q.shape
    hkv, ps = cache.num_kv_heads, cache.page_size
    n_split, per = decode_split(cache, b, window, 132,
                                decode_chunks(hq // hkv, d))
    s2, v, v_scale, pos = _paged_scores(q[:, None], cache, slots, scale,
                                        window)
    first = (pos[:, :1] + 1 - (window or 2 ** 62)).clamp_min(0)
    col = torch.arange(s2.shape[-1])
    run = (col // ps - first // ps) // per                 # [B, N]
    parts = []
    for r in range(n_split):
        sr = s2.masked_fill((run != r)[:, None, None], float("-inf"))
        parts.append(_normalize(*_online(sr, v, v_scale, DECODE_TILE)))
    if n_split == 1:
        o = parts[0][0]
    else:
        lse = torch.stack([p[1] for p in parts])           # [n, B, H, G]
        m = lse.amax(dim=0)
        m = torch.where(torch.isneginf(m), 0.0, m)
        w = torch.where(torch.isneginf(lse), 0.0, torch.exp(lse - m))
        total = w.sum(dim=0)
        w = w / torch.where(total == 0, 1.0, total)
        o = sum(w[i][..., None] * parts[i][0] for i in range(n_split))
    return o.reshape(b, hq, d)


DECODE_HIST = (1, 100, 300, 700)
EXTEND_HIST = (100, 150, 300)


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("hq,hkv,d", [(8, 4, 128), (4, 2, 64)])
def test_decode_f32_emulation_matches_plain_and_jax(hq, hkv, d, window):
    """B20 in interpret mode at f32 q, the port's plain version and the
    emulation of H6-decode's f32 arithmetic on the same cache."""
    jc, tc, slots = _fill_both(5, hkv, d, DECODE_HIST, 0)
    q = np.random.default_rng(6).standard_normal(
        (len(DECODE_HIST), hq, d)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    ref = np.asarray(jdec.paged_decode_attention(
        jnp.asarray(q), jc, jnp.asarray(slots), window=window))
    tq, ts = torch.from_numpy(q), torch.from_numpy(slots)
    plain = paged_decode_attention(tq, tc, ts, window=window)
    assert plain.dtype == torch.float32
    emu = emulate_decode_f32(tq, tc, ts, scale, window)
    assert (emu - paged_decode_plain(tq, tc, ts, scale, window)
            ).abs().max().item() < PLAIN_TOL
    assert np.abs(emu.numpy() - ref).max() < JAX_TOL
    assert np.abs(plain.numpy() - ref).max() < JAX_TOL


@pytest.mark.parametrize("route", ["b22_onepass", "b21_streaming"])
@pytest.mark.parametrize("window", [None, 77])
def test_extend_f32_emulation_matches_plain_and_jax(route, window,
                                                    monkeypatch):
    """B22 and B21 (a zero VMEM budget forces B21) in interpret mode at
    f32 q, the port's plain version and the emulation of H6-extend's f32
    arithmetic."""
    if route == "b21_streaming":
        monkeypatch.setattr(jdec, "EXTEND_ONEPASS_MAX_BYTES", 0)
    hq, hkv, d, c = 8, 4, 128, 40
    jc, tc, slots = _fill_both(7, hkv, d, EXTEND_HIST, c)
    q = np.random.default_rng(8).standard_normal(
        (len(EXTEND_HIST), c, hq, d)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    ref = np.asarray(jdec.paged_extend_attention(
        jnp.asarray(q), jc, jnp.asarray(slots), window=window))
    tq, ts = torch.from_numpy(q), torch.from_numpy(slots)
    plain = paged_extend_attention(tq, tc, ts, window=window)
    assert plain.dtype == torch.float32
    emu = emulate_extend_f32(tq, tc, ts, scale, window)
    assert (emu - paged_extend_plain(tq, tc, ts, scale, window)
            ).abs().max().item() < PLAIN_TOL
    assert np.abs(emu.numpy() - ref).max() < JAX_TOL
    assert np.abs(plain.numpy() - ref).max() < JAX_TOL


# ----------------------------------------------------- the f32 flagship

# bench/suite.py:900-1002's flagship at JAX's ModelConfig dtype (f32), cut
# to 2 layers: widths, heads and pages as served on the card
FLAGSHIP_2L = dict(vocab_size=32768, n_layers=2, n_heads=8, n_kv_heads=4,
                   d_model=1024, d_head=128, d_ff=4096)


def test_f32_flagship_two_turns_match_jax():
    """Greedy tokens of two turns (4 new, then a 9-token turn and 3 new)
    from both engines at f32 on the same weights (``params_from_jax``)."""
    jcfg = jtf.ModelConfig(**FLAGSHIP_2L)
    cfg = ModelConfig(**FLAGSHIP_2L)
    assert jcfg.dtype == jnp.float32 and cfg.dtype == torch.float32
    jparams = jtf.init_params(jcfg, seed=0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 32768, (2, 24)).astype(np.int32)
    turn = rng.integers(0, 32768, (2, 9)).astype(np.int32)
    jeng = jgen.GenerationEngine(jparams, jcfg, max_seqs=2, max_len=256)
    j1 = np.asarray(jeng.generate(jnp.asarray(prompt), 4, hold=True))
    j2 = np.asarray(jeng.continue_generation(
        jnp.asarray(np.concatenate([j1[:, -1:], turn], axis=1)), 3))
    jeng.release()
    eng = GenerationEngine(params_from_jax(jax.device_get(jparams),
                                           device="cpu"),
                           cfg, max_seqs=2, max_len=256, page_size=128)
    t1 = eng.generate(prompt, 4, hold=True)
    np.testing.assert_array_equal(t1, j1)
    t2 = eng.continue_generation(
        np.concatenate([t1[:, -1:], turn], axis=1), 3)
    np.testing.assert_array_equal(t2, j2)
    eng.release()


def test_params_from_jax_keeps_f32_bitwise():
    """f32 JAX parameters arrive as f32 tensors with the same bits (no
    cast on the way), and equal the port's own ``init_params``."""
    kw = dict(FLAGSHIP_2L, vocab_size=512, n_layers=1, d_model=128,
              d_ff=256)
    jparams = jax.device_get(jtf.init_params(jtf.ModelConfig(**kw), seed=3))
    port = params_from_jax(jparams, device="cpu")
    own = init_params(ModelConfig(**kw), seed=3, device="cpu")
    for name in ("embed", "ln_f"):
        got = port[name]
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(jparams[name]).view(np.uint32))
        assert torch.equal(got, own[name])
    for jl, pl, ol in zip(jparams["layers"], port["layers"], own["layers"]):
        for key, leaf in jl.items():
            assert pl[key].dtype == torch.float32
            assert np.array_equal(pl[key].numpy().view(np.uint32),
                                  np.asarray(leaf).view(np.uint32)), key
            assert torch.equal(pl[key], ol[key]), key


# ------------------------------------------------------- the dtype rule

DTYPES = [torch.bfloat16, torch.float32, torch.float16, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("kernel", sorted(KERNEL_DTYPES))
def test_kernel_dtype_rule(kernel, dtype):
    """Which dtypes each kernel takes on the card: bf16 and f32 everywhere
    (H4-kvq and H5 since ROADMAP B2c, H3 at every head dim since B2b-256);
    f16 and f64 nowhere, with a refusal that names what the kernel
    takes."""
    x = torch.zeros(2, dtype=dtype)
    if dtype in (torch.bfloat16, torch.float32):
        assert kernel_dtype(kernel, x, x) == dtype
        return
    with pytest.raises(TypeError, match="bf16 or f32") as err:
        kernel_dtype(kernel, x, x)
    assert str(dtype) in str(err.value)


def test_kernel_dtype_rule_takes_one_dtype():
    """Inputs of two dtypes raise, whatever the kernel takes."""
    with pytest.raises(TypeError, match="one dtype"):
        kernel_dtype("H1", torch.zeros(2), torch.zeros(2).bfloat16())


def test_f32_cpu_paths_keep_f32():
    """On the CPU the plain versions take f32 and give f32, as the card's
    f32 kernels do: the differentiable ``flash_attention`` and the paged
    pair."""
    q, k, v = (torch.from_numpy(x)
               for x in _f32_inputs(1, 4, 2, 33, 33, 32, seed=2))
    assert flash_attention(q, k, v, causal=True).dtype == torch.float32
    jc, tc, slots = _fill_both(9, 2, 64, (5,), 3)
    ts = torch.from_numpy(slots)
    qd = torch.zeros(1, 4, 64)
    assert paged_decode_attention(qd, tc, ts).dtype == torch.float32
    assert paged_extend_attention(qd[:, None], tc, ts).dtype == torch.float32
