"""The port's d-tiled forward ``flash_attention_v1_dtiled`` vs the JAX package.

The same NumPy inputs go through the JAX function (Pallas in interpret mode
on the CPU, as ``tests/test_attention_dtiled.py`` runs it) and through the
port's CPU path (kernel H5's plain version).  Each side is held against the
f64 oracle first, so that a failure names the side that drifted, then the
two against each other.  Each tolerance states its reason.  The last tests
emulate H5's roundings against ``chip_smoke.py``'s limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig
from exploring_flash_attention_tpu.ops import (
    flash_attention_v1_dtiled as jax_flash_attention_v1_dtiled,
)
from exploring_flash_attention_tpu.ops import quant as jax_quant
from exploring_flash_attention_tpu.oracle.reference import (
    make_qkv as jax_make_qkv,
)
from exploring_flash_attention_tpu_torch.oracle import make_qkv, naive_attention
from exploring_flash_attention_tpu_torch.ops import (
    QuantizedTensor,
    attention_dtiled_plain,
    dequantize,
    flash_attention_v1_dtiled,
    quantize_fp8,
    quantize_int8,
    quantized_from_numpy,
)
from exploring_flash_attention_tpu_torch.ops.quant import (
    _expand,
    tensor_from_numpy,
)

F32_TOL = 2e-5       # f32 on both sides, differing in summation order
                     # (tests/test_attention_dtiled.py:32)
LOG2E = 1.4426950408889634
CFG = TileConfig(block_q=128, block_kv=128, d_tile_qk=128, d_tile_v=128)
JAX_QUANT = {"int8": jax_quant.quantize_int8, "fp8": jax_quant.quantize_fp8}
QUANT = {"int8": quantize_int8, "fp8": quantize_fp8}


def _port(qt_jax) -> QuantizedTensor:
    return quantized_from_numpy(np.asarray(qt_jax.values),
                                np.asarray(qt_jax.scales), qt_jax.block,
                                device="cpu")


def _check_both(port, jax_out, ref, atol_jax, atol_port=F32_TOL,
                atol_pair=None):
    jax_out = np.asarray(jax_out)
    np.testing.assert_allclose(jax_out, ref, atol=atol_jax,
                               err_msg="jax O vs f64 oracle")
    np.testing.assert_allclose(port, ref, atol=atol_port,
                               err_msg="port O vs f64 oracle")
    np.testing.assert_allclose(port, jax_out, atol=atol_pair or atol_jax,
                               err_msg="port O vs jax")


@pytest.mark.parametrize("d", [256, 512])
def test_dtiled_matches_jax_f32(d):
    """f32 everywhere: both sides are f32 attention, 2e-5."""
    q, k, v = jax_make_qkv(1, 2, 256, d, seed=0)
    want = jax_flash_attention_v1_dtiled(*map(jnp.asarray, (q, k, v)),
                                         config=CFG)
    got = flash_attention_v1_dtiled(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    _check_both(got.numpy(), want, naive_attention(q, k, v), F32_TOL)


def test_dtiled_matches_jax_bf16_d512():
    """bf16 q, k, v and f32 O.  The port's CPU path is f32 math over the
    bf16 inputs (2e-5 of the oracle); B19 rounds P to bf16 before P V
    (attention_v1_dtiled.py:161), as H5 does on the card, which moves O
    by up to ~2^-9 of |v|: 2e-3 for that side and the pair (the JAX test
    holds it to 2e-2, tests/test_attention_dtiled.py:56)."""
    q, k, v = (x.astype(jnp.bfloat16) for x in map(
        jnp.asarray, jax_make_qkv(1, 2, 256, 512, seed=2)))
    want = jax_flash_attention_v1_dtiled(q, k, v, config=CFG,
                                         out_dtype=jnp.float32)
    qt, kt, vt = (tensor_from_numpy(np.asarray(x), "cpu") for x in (q, k, v))
    got = flash_attention_v1_dtiled(qt, kt, vt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _check_both(got.numpy(), want, naive_attention(qt, kt, vt), 2e-3)
    assert flash_attention_v1_dtiled(qt, kt, vt).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_dtiled_quantized_matches_jax(kind):
    """tests/test_attention_dtiled.py:70's case: bf16 q, int8 or e4m3 K/V
    of bf16 tensors in blocks of 128, f32 O.  JAX rounds p * v_scale to
    bf16 (:160-161): 2e-3, its test's limit; the port's CPU path is f32
    math over the dequantized K/V, 2e-5 of the oracle."""
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16)
               for x in jax_make_qkv(1, 2, 256, 256, seed=4))
    kq, vq = JAX_QUANT[kind](k, 128), JAX_QUANT[kind](v, 128)
    want = jax_flash_attention_v1_dtiled(q, kq, vq, config=CFG,
                                         out_dtype=jnp.float32)
    qt = tensor_from_numpy(np.asarray(q), "cpu")
    got = flash_attention_v1_dtiled(qt, _port(kq), _port(vq),
                                    out_dtype=torch.float32)
    ref = naive_attention(qt, np.asarray(jax_quant.dequantize(kq)),
                          np.asarray(jax_quant.dequantize(vq)))
    _check_both(got.numpy(), want, ref, 2e-3)


def test_dtiled_takes_ragged_lengths_and_any_quant_block():
    """JAX's "L divisible by blocks" and "quant block == block_kv"
    (attention_v1_dtiled.py:230,275) guard TPU tiles: JAX raises, the port
    computes the function (2e-5 of the oracle)."""
    q, k, v = jax_make_qkv(1, 1, 200, 256, seed=3, seq_len_kv=300)
    with pytest.raises(ValueError, match="divisible"):
        jax_flash_attention_v1_dtiled(*map(jnp.asarray, (q, k, v)),
                                      config=CFG)
    got = flash_attention_v1_dtiled(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), naive_attention(q, k, v),
                               atol=F32_TOL)
    kq = jax_quant.quantize_int8(jnp.asarray(k), 64)
    vq = jax_quant.quantize_int8(jnp.asarray(v), 64)
    with pytest.raises(ValueError):
        jax_flash_attention_v1_dtiled(jnp.asarray(q), kq, vq, config=CFG)
    got = flash_attention_v1_dtiled(torch.from_numpy(q), _port(kq),
                                    _port(vq))
    ref = naive_attention(q, np.asarray(jax_quant.dequantize(kq)),
                          np.asarray(jax_quant.dequantize(vq)))
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL)


def test_dtiled_refusals_match_jax():
    q, k, v = jax_make_qkv(1, 1, 128, 256, seed=5)
    kq = jax_quant.quantize_int8(jnp.asarray(k), 128)
    with pytest.raises(ValueError, match="both"):
        jax_flash_attention_v1_dtiled(jnp.asarray(q), kq, jnp.asarray(v),
                                      config=CFG)
    with pytest.raises(ValueError, match="both"):
        flash_attention_v1_dtiled(torch.from_numpy(q), _port(kq),
                                  torch.from_numpy(v))
    vq = jax_quant.quantize_int8(jnp.asarray(v), 64)
    with pytest.raises(ValueError, match="blocks must match"):
        flash_attention_v1_dtiled(torch.from_numpy(q), _port(kq), _port(vq))


# ---------------------------------------------------------------------------
# chip_smoke.py's limits for the dtiled phase, rehearsed on the CPU: H5's
# roundings emulated on the phase's gate inputs (make_qkv rounded to bf16)

CARD_DTILED_GATE_TOL = 2e-3   # bench/suite.py:299, :334
CARD_DTILED_O_TOL = 4e-3      # vs the plain version and the oracle slice


def h5_emulation(q, k, v, scale):
    """H5's arithmetic on the CPU: 64-key tiles; S in f32 times
    f32(scale * log2e) * k_scale per key; an online softmax in the exp2
    basis whose l sums the f32 p; p * v_scale rounded to bf16 before P V
    with the V codes (bf16 K/V: scales of 1)."""
    if isinstance(k, QuantizedTensor):
        ks = _expand(k.scales, k.shape, k.block)[..., 0]
        vs = _expand(v.scales, v.shape, v.block)[..., 0]
        k, v = k.values, v.values
    else:
        ks = vs = torch.ones(k.shape[:-1])
    kc, vc = k.float(), v.float()
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full(q.shape[:-1], float("-inf"))
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for kv0 in range(0, k.shape[2], 64):
        t = slice(kv0, kv0 + 64)
        s = (q.float() @ kc[..., t, :].transpose(-1, -2)) \
            * (c * ks[..., None, t])
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1)
        pb = (p * vs[..., None, t]).bfloat16().float()
        o = o * alpha[..., None] + pb @ vc[..., t, :]
        m = m_new
    return o / l[..., None]


def _rolled(qt):
    return QuantizedTensor(qt.values, torch.roll(qt.scales, 1, dims=2),
                           qt.block)


@pytest.mark.parametrize("kind,lq,lkv,d,block", [
    ("bf16", 512, 512, 512, None),     # the suite's gate (1, 2, 512, 512)
    ("fp8", 512, 512, 512, 512),
    ("int8", 512, 512, 512, 512),
    ("int8", 1000, 1100, 256, 128),    # ragged, several scale blocks
])
def test_card_limits_hold_h5_roundings(kind, lq, lkv, d, block):
    """The emulation reads within half the gate against the f64 oracle
    (over the dequantized K/V) and within half the card's limit against
    the plain version, while the known-wrong controls read beyond twice
    that limit: the scale off by 10%, the last 64-key tile dropped, the last
    128-wide d-chunk left out of S and, with more than one scale block,
    the neighbouring block's scales."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in make_qkv(
        1, 2, lq, d, seed=0, seq_len_kv=lkv))
    if kind != "bf16":
        k, v = QUANT[kind](k, block), QUANT[kind](v, block)
        kd, vd = dequantize(k), dequantize(v)
    else:
        kd, vd = k, v
    scale = 1.0 / np.sqrt(d)
    emu = h5_emulation(q, k, v, scale).numpy()
    assert np.abs(emu - naive_attention(q, kd, vd)).max() < \
        CARD_DTILED_GATE_TOL / 2
    assert np.abs(emu - attention_dtiled_plain(q, k, v, scale).numpy()
                  ).max() < CARD_DTILED_O_TOL / 2
    bad = [naive_attention(q, kd, vd, scale=1.1 * scale),
           naive_attention(q, kd[..., :-64, :], vd[..., :-64, :]),
           naive_attention(q[..., :-128], kd[..., :-128], vd, scale=scale)]
    if kind != "bf16" and k.scales.shape[2] > 1:
        bad.append(naive_attention(q, dequantize(_rolled(k)),
                                   dequantize(_rolled(v))))
    for x in bad:
        assert np.abs(emu - x).max() > 2 * CARD_DTILED_O_TOL
