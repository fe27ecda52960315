"""The port's quantization layer and quantized forwards vs the JAX package.

``quantize_int8`` / ``quantize_fp8`` must equal the eager JAX functions
bit for bit (codes, e4m3 bytes, scales).  ``flash_attention_kvquant`` and
``flash_attention_int8`` take the same NumPy inputs as the JAX functions
(Pallas in interpret mode on the CPU, as ``tests/test_quant.py`` and
``tests/test_attention_int8.py`` run them) through the port's CPU path
(the kernels' plain versions); each side is held against the f64 oracle
over the dequantized tensors first, so that a failure names the side that
drifted, then the two against each other.  Each tolerance states its
reason.  The last tests emulate the card kernels' roundings against
``chip_smoke.py``'s limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig
from exploring_flash_attention_tpu.ops import quant as jax_quant
from exploring_flash_attention_tpu.ops.attention_int8 import (
    flash_attention_int8 as jax_flash_attention_int8,
)
from exploring_flash_attention_tpu.ops.attention_kvquant import (
    flash_attention_kvquant as jax_flash_attention_kvquant,
)
from exploring_flash_attention_tpu.oracle.reference import (
    make_qkv as jax_make_qkv,
)
from exploring_flash_attention_tpu_torch.oracle import make_qkv, naive_attention
from exploring_flash_attention_tpu_torch.ops import (
    QuantizedTensor,
    attention_int8_plain,
    attention_kvquant_plain,
    dequantize,
    flash_attention_int8,
    flash_attention_kvquant,
    quantize_fp8,
    quantize_int8,
    quantized_from_numpy,
)
from exploring_flash_attention_tpu_torch.ops.quant import (
    _expand,
    quantization_error,
    tensor_from_numpy,
)

F32_TOL = 2e-5       # f32 on both sides, differing in summation order and
                     # in where the scales multiply (tests/test_quant.py:66)
LOG2E = 1.4426950408889634
QUANTIZERS = {"int8": (quantize_int8, jax_quant.quantize_int8),
              "fp8": (quantize_fp8, jax_quant.quantize_fp8)}


def _raw(values) -> np.ndarray:
    """Codes as comparable NumPy: int8 as is, e4m3 as its bytes."""
    if isinstance(values, torch.Tensor):
        if values.dtype == torch.float8_e4m3fn:
            return values.view(torch.uint8).numpy()
        return values.numpy()
    x = np.asarray(values)
    return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x


def _port(qt_jax) -> QuantizedTensor:
    return quantized_from_numpy(np.asarray(qt_jax.values),
                                np.asarray(qt_jax.scales), qt_jax.block,
                                device="cpu")


def _check_both(port, jax_out, ref, atol, what="O"):
    for side, x in (("jax", np.asarray(jax_out)), ("port", np.asarray(port))):
        np.testing.assert_allclose(x, ref, atol=atol,
                                   err_msg=f"{side} {what} vs f64 oracle")
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_out),
                               atol=atol, err_msg=f"port {what} vs jax")


@pytest.mark.parametrize("src", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("shape,block", [
    ((1, 2, 200, 64), 128),       # ragged last block
    ((2, 2, 256, 128), 512),      # one block longer than L
    ((1, 1, 300, 32), 64),
])
def test_quantize_matches_jax_bitwise(shape, block, kind, src):
    rng = np.random.default_rng(sum(shape) + block)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    x[0, 0, 5, 3] = 40.0                         # an outlier
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if src == "bf16":
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)
    ours, theirs = QUANTIZERS[kind]
    got, want = ours(xt, block), theirs(xj, block)
    assert got.block == want.block == block
    assert got.shape == tuple(want.shape)
    assert got.scales.dtype == torch.float32
    assert np.array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert np.array_equal(_raw(got.values), _raw(want.values))
    assert np.array_equal(dequantize(got).numpy(),
                          np.asarray(jax_quant.dequantize(want)))
    assert quantization_error(xt, got) == pytest.approx(
        jax_quant.quantization_error(xj, want), rel=1e-6)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_under_jit_differs_by_one_ulp(kind):
    """Under jit XLA rewrites the JAX source's division by a constant,
    ``absmax / qmax`` (ops/quant.py:64), into a multiply by its reciprocal,
    so many scales come out one ulp from a true division (ROADMAP.md queue
    C).  The port divides, as the source reads and as the eager JAX
    function computes (bitwise equal above).  No scale is more than one
    ulp apart, and at most one code in 10^4 moves."""
    import jax

    x = (3 * np.random.default_rng(11).standard_normal((2, 4, 512, 128))
         ).astype(np.float32)
    ours, theirs = QUANTIZERS[kind]
    got = ours(torch.from_numpy(x), 128)
    want = jax.jit(theirs, static_argnums=1)(jnp.asarray(x), 128)
    ulps = np.abs(got.scales.numpy().view(np.int32)
                  - np.asarray(want.scales).view(np.int32))
    assert ulps.max() <= 1
    assert (_raw(got.values) != _raw(want.values)).mean() < 1e-4


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_from_numpy_round_trip(kind):
    """A JAX QuantizedTensor's arrays hand over to the port bit for bit
    (e4m3 through its bytes, no ml_dtypes), copied, so the read-only JAX
    buffers are never written."""
    x = jax_make_qkv(1, 2, 130, 64, seed=7)[0]
    want = QUANTIZERS[kind][1](jnp.asarray(x), 64)
    values = np.asarray(want.values)
    got = quantized_from_numpy(values, np.asarray(want.scales), want.block,
                               device="cpu")
    assert got.dtype == (torch.int8 if kind == "int8"
                         else torch.float8_e4m3fn)
    assert got.block == 64 and got.scales.shape == (1, 2, 3)
    assert np.array_equal(_raw(got.values), _raw(values))
    got.values.view(torch.uint8).zero_()
    assert np.array_equal(_raw(np.asarray(want.values)), _raw(values))
    bf = tensor_from_numpy(np.asarray(jnp.asarray(x).astype(jnp.bfloat16)),
                           device="cpu")
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, torch.from_numpy(x).bfloat16())


# (case, Lq, Lkv, d, block): the JAX tests' shape, and a ragged KV
KVQ_CASES = [("jax_test_shape", 256, 256, 128, 128),
             ("ragged_kv", 128, 200, 64, 64)]


@pytest.mark.parametrize("one_pass", [None, False], ids=["b17", "b16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("case,lq,lkv,d,block", KVQ_CASES)
def test_kvquant_matches_jax_f32_q(case, lq, lkv, d, block, kind, one_pass):
    """f32 Q: JAX computes in f32 (compute_dtype f32), so both sides are
    f32 attention over the same dequantized K/V: 2e-5."""
    q, k, v = jax_make_qkv(1, 2, lq, d, seed=3, seq_len_kv=lkv)
    quant = QUANTIZERS[kind][1]
    kq, vq = quant(jnp.asarray(k), block), quant(jnp.asarray(v), block)
    want = jax_flash_attention_kvquant(
        jnp.asarray(q), kq, vq, config=TileConfig(128, 128,
                                                  one_pass=one_pass))
    got = flash_attention_kvquant(torch.from_numpy(q), _port(kq), _port(vq))
    assert got.dtype == torch.float32 and got.shape == q.shape
    ref = naive_attention(q, np.asarray(jax_quant.dequantize(kq)),
                          np.asarray(jax_quant.dequantize(vq)))
    _check_both(got.numpy(), want, ref, F32_TOL)


@pytest.mark.parametrize("one_pass", [None, False], ids=["b17", "b16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_kvquant_matches_jax_bf16_q(kind, one_pass):
    """bf16 Q with f32 O.  The port's plain path is f32 math over the
    bf16 q (2e-5 of the oracle); the JAX kernels round P to bf16 before
    P V (attention_kvquant.py:100, :156), as H4-kvq does on the card,
    which moves O by up to ~2^-9 of |v|: 2e-3 for that side and for the
    two against each other (they read ~7e-4)."""
    q, k, v = jax_make_qkv(1, 2, 256, 128, seed=4)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    quant = QUANTIZERS[kind][1]
    kq, vq = quant(jnp.asarray(k), 128), quant(jnp.asarray(v), 128)
    want = np.asarray(jax_flash_attention_kvquant(
        qb, kq, vq, config=TileConfig(128, 128, one_pass=one_pass),
        out_dtype=jnp.float32))
    qt = torch.from_numpy(q).bfloat16()
    got = flash_attention_kvquant(qt, _port(kq), _port(vq),
                                  out_dtype=torch.float32)
    assert got.dtype == torch.float32
    ref = naive_attention(qt, np.asarray(jax_quant.dequantize(kq)),
                          np.asarray(jax_quant.dequantize(vq)))
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL)
    np.testing.assert_allclose(want, ref, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    assert flash_attention_kvquant(qt, _port(kq), _port(vq)).dtype == \
        torch.bfloat16


def test_kvquant_refusals_match_jax():
    q, k, v = jax_make_qkv(1, 1, 256, 64, seed=5)
    kq = jax_quant.quantize_int8(jnp.asarray(k), block=128)
    vq = jax_quant.quantize_int8(jnp.asarray(v), block=64)
    with pytest.raises(ValueError, match="blocks must match"):
        flash_attention_kvquant(torch.from_numpy(q), _port(kq), _port(vq))
    with pytest.raises(ValueError, match="blocks must match"):
        jax_flash_attention_kvquant(jnp.asarray(q), kq, vq)
    kq = _port(kq)
    short = QuantizedTensor(kq.values, kq.scales[:, :, :1], kq.block)
    with pytest.raises(ValueError, match="scale blocks"):
        flash_attention_kvquant(torch.from_numpy(q), short, short)


def _int8_inputs(b, h, lq, lkv, d, bq, bk, seed=0):
    """tests/test_attention_int8.py:20's inputs: int8 Q, K, V and the f64
    oracle over the dequantized tensors."""
    q, k, v = jax_make_qkv(b, h, max(lq, lkv), d, seed=seed)
    qq = jax_quant.quantize_int8(jnp.asarray(q[:, :, :lq]), block=bq)
    kq = jax_quant.quantize_int8(jnp.asarray(k[:, :, :lkv]), block=bk)
    vq = jax_quant.quantize_int8(jnp.asarray(v[:, :, :lkv]), block=bk)
    ref = naive_attention(*(np.asarray(jax_quant.dequantize(x))
                            for x in (qq, kq, vq)))
    return qq, kq, vq, ref


# the JAX int8 tests' tiers vs the dequantized oracle
# (tests/test_attention_int8.py:44,53,63)
INT8_ORACLE_TOL = {"bf16": 1.5e-3, "int8": 3e-2}


@pytest.mark.parametrize("pv_mode", ["bf16", "int8"])
@pytest.mark.parametrize("lq,lkv,bq", [(256, 256, 128), (128, 200, 128),
                                       (256, 256, 256)])
def test_int8_matches_jax(lq, lkv, bq, pv_mode):
    """The plain version reproduces B18's roundings (P to bf16, or
    round(p * 127); l from the f32 p; the scales folded in B18's order),
    so port and JAX agree to 1e-5 (f32 sums in another order) wherever P's
    codes agree.  torch's and XLA's CPU exp2 differ by up to 16 ulps on
    most inputs, which flips the bf16 rounding of about 2e-5 of the P
    values (ROADMAP.md queue C); each flip moves O by at most 2^-8 * p *
    |v| / l, so at most 1% of O may differ beyond 1e-5, and none beyond
    2e-4.  Each side against the oracle at the JAX test's tier."""
    qq, kq, vq, ref = _int8_inputs(1, 2, lq, lkv, 64, bq, 128)
    want = np.asarray(jax_flash_attention_int8(
        qq, kq, vq, config=TileConfig(block_q=bq, block_kv=128),
        out_dtype=jnp.float32, pv_mode=pv_mode))
    got = flash_attention_int8(_port(qq), _port(kq), _port(vq),
                               out_dtype=torch.float32, pv_mode=pv_mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = np.abs(got.numpy() - want)
    assert (diff > 1e-5).mean() < 0.01 and diff.max() < 2e-4
    tol = INT8_ORACLE_TOL[pv_mode]
    assert np.abs(want - ref).max() < tol
    assert np.abs(got.numpy() - ref).max() < tol
    assert flash_attention_int8(_port(qq), _port(kq), _port(vq)).dtype == \
        torch.bfloat16


def test_int8_takes_any_q_block():
    """JAX needs q_q.block == block_q (attention_int8.py:152), a TPU tile
    rule; the port reads each row's scale as scales[row // block]: Q in
    blocks of 64 against JAX with block_q=64."""
    qq, kq, vq, ref = _int8_inputs(1, 1, 256, 256, 64, 64, 128, seed=1)
    with pytest.raises(ValueError, match="block"):
        jax_flash_attention_int8(qq, kq, vq)        # block_q 256 != 64
    want = np.asarray(jax_flash_attention_int8(
        qq, kq, vq, config=TileConfig(block_q=64, block_kv=128),
        out_dtype=jnp.float32))
    got = flash_attention_int8(_port(qq), _port(kq), _port(vq),
                               out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - ref).max() < INT8_ORACLE_TOL["bf16"]


def test_int8_refusals():
    qq, kq, vq, _ = _int8_inputs(1, 1, 128, 128, 64, 128, 128)
    vq64 = jax_quant.quantize_int8(jax_quant.dequantize(vq), block=64)
    with pytest.raises(ValueError, match="blocks must match"):
        flash_attention_int8(_port(qq), _port(kq), _port(vq64))
    with pytest.raises(ValueError, match="blocks must match"):
        jax_flash_attention_int8(qq, kq, vq64,
                                 config=TileConfig(block_q=128))
    with pytest.raises(ValueError, match="pv_mode"):
        flash_attention_int8(_port(qq), _port(kq), _port(vq), pv_mode="fp8")


def test_port_quantize_feeds_the_port_ops():
    """The port's own quantizers on the port's own ``make_qkv``: the ops
    agree with the oracle over what they dequantize."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 2, 192, 64, seed=9))
    kq, vq = quantize_fp8(k, 64), quantize_fp8(v, 64)
    got = flash_attention_kvquant(q, kq, vq)
    ref = naive_attention(q, dequantize(kq), dequantize(vq))
    assert np.abs(got.numpy() - ref).max() < F32_TOL
    qq, kq, vq = (quantize_int8(x, 64) for x in (q, k, v))
    got = flash_attention_int8(qq, kq, vq, out_dtype=torch.float32)
    ref = naive_attention(*(dequantize(x) for x in (qq, kq, vq)))
    assert np.abs(got.numpy() - ref).max() < INT8_ORACLE_TOL["bf16"]


# ---------------------------------------------------------------------------
# chip_smoke.py's limits for the quant phase, rehearsed on the CPU: each
# kernel's roundings emulated on inputs made as the phase makes them
# (make_qkv rounded to bf16): the suite's gate inputs whole, the larger
# cases at their per-head shapes with one or two heads

CARD_KVQ_GATE_TOL = 1e-3      # bench/suite.py:383, vs the f64 oracle
CARD_KVQ_O_TOL = 5e-4         # f32 O vs the plain version and the oracle:
                              # P rounded to fp16; the emulation reads
                              # <= 8.1e-5, the controls >= 1.8e-2
CARD_INT8_GATE_TOL = 1.5e-3   # bench/suite.py:420, pv_mode bf16
CARD_INT8_PV8_TOL = 3e-2      # pv_mode int8 vs the oracle
                              # (tests/test_attention_int8.py:53)
CARD_INT8_PLAIN_TOL = 1e-3    # either mode vs the plain version, which
                              # computes B18's function: only summation
                              # order and a rare rounding flip of P differ


def h4kvq_emulation(q, k_q, v_q, scale, tile=128):
    """H4-kvq's arithmetic on the CPU: ``tile``-key tiles (the kernel's K/V
    tile: 128, 64 on its D=256 instance), S = q . codes in f32 times
    k_scale * f32(scale * log2e) per key, an online softmax in the exp2
    basis whose l sums the f32 p; P times each key's share of the tile's
    largest V scale, p * (v_scale / vmax), rounded to fp16 before P V with
    the V codes, and the tile's product times vmax."""
    lkv = k_q.shape[2]
    kc, vc = k_q.values.float(), v_q.values.float()
    ks = _expand(k_q.scales, k_q.shape, k_q.block)[..., 0]
    vs = _expand(v_q.scales, v_q.shape, v_q.block)[..., 0]
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full(q.shape[:-1], float("-inf"))
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for kv0 in range(0, lkv, tile):
        t = slice(kv0, kv0 + tile)
        s = (q.float() @ kc[..., t, :].transpose(-1, -2)) \
            * (ks[..., None, t] * c)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1)
        vmax = vs[..., t].amax(-1)[..., None, None]
        ph = (p * (vs[..., None, t] / vmax)).half().float()
        o = o * alpha[..., None] + vmax * (ph @ vc[..., t, :])
        m = m_new
    return o / l[..., None]


def h4int8_emulation(q_q, k_q, v_q, scale, pv_mode, tile=128):
    """H4-int8's arithmetic on the CPU: B18's one-pass softmax (m over
    every key, l summing the f32 p, P rounded to bf16 or to round(p *
    127)), with P V taken as the kernel takes it: per ``tile``-key tile
    (128, 64 on its D=256 instance), one run per kv block the tile holds,
    each run's product times its v_scale (times f32(1/127) in int8 mode)
    added into O in f32."""
    lkv = k_q.shape[2]
    qs = _expand(q_q.scales, q_q.shape, q_q.block)
    ks = _expand(k_q.scales, k_q.shape, k_q.block)[..., 0]
    s = q_q.values.float() @ k_q.values.float().transpose(-1, -2)
    s = s * ((qs * ks[:, :, None, :])
             * torch.tensor(scale * LOG2E, dtype=torch.float32))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if pv_mode == "int8":
        p_lp, f = torch.round(p * 127.0), torch.tensor(1.0 / 127.0)
    else:
        p_lp, f = p.bfloat16().float(), torch.tensor(1.0)
    v = v_q.values.float()
    o = torch.zeros(p.shape[:-1] + (v.shape[-1],))
    block = v_q.block
    for kv0 in range(0, lkv, tile):
        end = min(kv0 + tile, lkv)
        for b in range(kv0 // block, -(-end // block)):
            r = slice(max(kv0, b * block), min(end, (b + 1) * block))
            o += (p_lp[..., r] @ v[:, :, r]) * (v_q.scales[:, :, b, None,
                                                           None] * f)
    return o / l


def _rolled(qt):
    """The neighbouring block's scales: what a wrong scale index reads."""
    return QuantizedTensor(qt.values, torch.roll(qt.scales, 1, dims=2),
                           qt.block)


def _bf16_qkv(b, h, lq, lkv, d, seed):
    return [torch.from_numpy(x).bfloat16()
            for x in make_qkv(b, h, lq, d, seed=seed, seq_len_kv=lkv)]


@pytest.mark.parametrize("kind,shape,seed,block,tol", [
    ("int8", (2, 4, 512, 512), 0, 512, CARD_KVQ_GATE_TOL),    # the gate
    ("fp8", (2, 4, 512, 512), 0, 512, CARD_KVQ_GATE_TOL),
    ("int8", (1, 2, 1024, 1024), 1, 512, CARD_KVQ_O_TOL),     # canonical
    ("int8", (1, 1, 1024, 8192), 2, 128, CARD_KVQ_O_TOL),     # B16's route
    ("fp8", (1, 2, 1024, 1100), 3, 128, CARD_KVQ_O_TOL),      # ragged KV
])
def test_card_limits_hold_h4kvq_roundings(kind, shape, seed, block, tol):
    """The emulation reads within half the limit against the plain
    version and the f64 oracle over the dequantized K/V, while the
    known-wrong controls read beyond twice it: the scale off by 10%, the
    last 64-key tile dropped and, with more than one block, the
    neighbouring block's scales."""
    q, k, v = _bf16_qkv(*shape, 128, seed)
    kq, vq = QUANTIZERS[kind][0](k, block), QUANTIZERS[kind][0](v, block)
    scale = 1.0 / np.sqrt(128)
    emu = h4kvq_emulation(q, kq, vq, scale).numpy()
    kd, vd = dequantize(kq), dequantize(vq)
    assert np.abs(emu - naive_attention(q, kd, vd)).max() < tol / 2
    assert np.abs(emu - attention_kvquant_plain(q, kq, vq, scale).numpy()
                  ).max() < tol / 2
    bad = [naive_attention(q, kd, vd, scale=1.1 * scale),
           naive_attention(q, kd[..., :-64, :], vd[..., :-64, :])]
    if kq.scales.shape[2] > 1:
        bad.append(naive_attention(q, dequantize(_rolled(kq)),
                                   dequantize(_rolled(vq))))
    for x in bad:
        assert np.abs(emu - x).max() > 2 * tol


@pytest.mark.parametrize("pv_mode", ["bf16", "int8"])
@pytest.mark.parametrize("shape,seed", [
    ((2, 4, 512, 512), 0),                    # the suite's gate
    ((1, 2, 1024, 1024), 1),                  # canonical
    ((1, 1, 4096, 4096), 4),                  # bench/suite.py:1189
])
def test_card_limits_hold_h4int8_roundings(pv_mode, shape, seed):
    """H4-int8 computes B18's function, which the plain version
    reproduces: the card holds the kernel to the plain version within
    CARD_INT8_PLAIN_TOL, which the emulation of the kernel's runs meets
    with room to spare, and the controls read beyond twice that limit
    (the scale off by 10%, the last 64-key tile dropped and, with more
    than one block, the neighbouring block's scales).  Against the f64
    oracle, pv_mode bf16 reads within half the suite's gate; pv_mode
    int8's requantized P is B18's own error, which
    test_b18_int8_pv_reads_near_its_tier shows JAX reading as well:
    within the tier, and the controls beyond twice it."""
    q, k, v = _bf16_qkv(*shape, 128, seed)
    qq, kq, vq = (quantize_int8(x, 512) for x in (q, k, v))
    scale = 1.0 / np.sqrt(128)
    got = h4int8_emulation(qq, kq, vq, scale, pv_mode).numpy()
    plain = attention_int8_plain(qq, kq, vq, scale, pv_mode).numpy()
    assert np.abs(got - plain).max() < CARD_INT8_PLAIN_TOL / 100
    qd, kd, vd = (dequantize(x) for x in (qq, kq, vq))
    if pv_mode == "bf16":
        assert np.abs(got - naive_attention(qd, kd, vd)).max() < \
            CARD_INT8_GATE_TOL / 2
    else:
        assert np.abs(got - naive_attention(qd, kd, vd)).max() < \
            CARD_INT8_PV8_TOL
    short = [QuantizedTensor(x.values[..., :-64, :], x.scales, x.block)
             for x in (kq, vq)]
    bad = [attention_int8_plain(qq, kq, vq, 1.1 * scale, pv_mode),
           attention_int8_plain(qq, *short, scale, pv_mode)]
    if kq.scales.shape[2] > 1:
        bad.append(attention_int8_plain(qq, _rolled(kq), _rolled(vq), scale,
                                        pv_mode))
    for x in bad:
        assert np.abs(got - x.numpy()).max() > 2 * CARD_INT8_PLAIN_TOL
    tol = CARD_INT8_GATE_TOL if pv_mode == "bf16" else CARD_INT8_PV8_TOL
    for x in bad[:2]:
        assert np.abs(x.numpy() - naive_attention(qd, kd, vd)).max() > tol


def test_b18_int8_pv_reads_near_its_tier():
    """At the suite's gate inputs (2, 4, 512, 128, block 512), B18 in
    pv_mode int8 reads 0.9 of the JAX test's 3e-2 tier against the f64
    oracle, and the port's plain version reads the same: the requantized
    P (+-1/254 per weight, weights under 1/254 dropped) is the function's
    error, not the port's."""
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16)
               for x in jax_make_qkv(2, 4, 512, 128, seed=0))
    jq = [jax_quant.quantize_int8(x, 512) for x in (q, k, v)]
    ref = naive_attention(*(np.asarray(jax_quant.dequantize(x))
                            for x in jq))
    want = np.asarray(jax_flash_attention_int8(
        *jq, config=TileConfig(block_q=512, block_kv=512),
        out_dtype=jnp.float32, pv_mode="int8"))
    got = attention_int8_plain(*(_port(x) for x in jq), 1 / np.sqrt(128),
                               "int8").numpy()
    e_jax, e_port = np.abs(want - ref).max(), np.abs(got - ref).max()
    assert 2e-2 < e_jax < CARD_INT8_PV8_TOL
    assert abs(e_port - e_jax) < 1e-3
