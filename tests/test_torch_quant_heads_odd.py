"""The quantized forwards at head dims that are not a multiple of 16, vs the
JAX package.

``flash_attention_kvquant`` runs H4-kvq at every d from 1 to 256
(``ops.attention.SERVING_HEAD_DIM_RULE``) and H5's quantized form past 256
up to 2048; ``flash_attention_int8`` runs H4-int8 at every d from 1 to 256.
On the card a d off the multiples of 16 runs on their PACKED instances,
whose producers copy rows of d bytes themselves (no tensor map takes
them).  The JAX functions (TPU kernels B16, B17 and B18) take any d.  Here
the same NumPy inputs go through the JAX functions (Pallas in interpret
mode) and the port's CPU path (the kernels' plain versions) at d 1, 8, 33,
40, 72, 100 and 250 (and 300 for the quantized-KV op), at the tolerances
of ``tests/test_torch_quant.py``; the routes of every d of the rules; and
the card kernels' roundings, emulated at these d, against
``chip_smoke.py``'s limits for the quant phase's odd head-dim cases, beside
the rows of codes misread as a wrong staged load would read them (each
element one late, each row's last column dropped).
"""

import math

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
from exploring_flash_attention_tpu_torch.oracle import naive_attention
from exploring_flash_attention_tpu_torch.ops import (
    QuantizedTensor,
    attention_dtiled_plain,
    attention_int8_plain,
    attention_kvquant_plain,
    dequantize,
    flash_attention_int8,
    flash_attention_kvquant,
    quantize_int8,
)
from exploring_flash_attention_tpu_torch.ops.attention import (
    H4_INSTANCES,
    h4_instance,
)
from exploring_flash_attention_tpu_torch.ops.attention_kvquant import (
    kvquant_kernel,
)
from f32_pieces import one_torch_thread  # noqa: F401 (autouse)
from test_torch_quant import (
    CARD_INT8_GATE_TOL,
    CARD_INT8_PLAIN_TOL,
    CARD_KVQ_O_TOL,
    F32_TOL,
    INT8_ORACLE_TOL,
    QUANTIZERS,
    _check_both,
    _int8_inputs,
    _port,
    _rolled,
    h4int8_emulation,
    h4kvq_emulation,
)
from test_torch_quant_heads import _dropped, _phase_inputs, h4_tile

# d off the multiples of 16: code rows of 1-byte (1, 33), 2-byte (250),
# 4-byte (100) and 8-byte (8, 40, 72) alignment; bf16 rows staged where d
# % 8 != 0 (1, 33, 100, 250)
ODD_DIMS = (1, 8, 33, 40, 72, 100, 250)
# chip_smoke.py's HEADS_ODD, which the quant phase's odd cases take
CARD_ODD_DIMS = (1, 8, 33, 36, 40, 72, 100, 250)


def misread_rows(x: torch.Tensor) -> dict:
    """The known-wrong loads of rows of d values that chip_smoke.py holds
    the kernels against (its misread_rows): each element read one element
    late (x's memory shifted by one), and each row's last column
    dropped."""
    drop = x.clone()
    drop[..., -1] = 0
    return {"rows read one element late": x.flatten().roll(-1).view(x.shape),
            "last column dropped": drop}


def misread(qt: QuantizedTensor) -> dict:
    """misread_rows of a quantized tensor's codes, its scales kept."""
    return {n: QuantizedTensor(x, qt.scales, qt.block)
            for n, x in misread_rows(qt.values).items()}


@pytest.mark.parametrize("one_pass", [None, False], ids=["b17", "b16"])
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("d", ODD_DIMS + (300,))
def test_kvquant_matches_jax_at_odd_head_dims(d, kind, q_dtype, one_pass):
    """B16 and B17 at d off the multiples of 16, a ragged KV (200 keys,
    blocks of 64), with tests/test_torch_quant.py's tolerances.  f32 q:
    both sides f32 attention over the same dequantized K/V, within 2e-5 of
    the f64 oracle and of each other.  bf16 q with f32 O: the port's plain
    path within 2e-5 of the oracle; JAX rounds P to bf16 before P V
    (attention_kvquant.py:100, :156), 2e-3 for its side and the pair.
    d=300 runs H5's quantized form on the card, whose plain version is the
    same function."""
    q, k, v = jax_make_qkv(1, 2, 128, d, seed=d, seq_len_kv=200)
    quant = QUANTIZERS[kind][1]
    kq, vq = quant(jnp.asarray(k), 64), quant(jnp.asarray(v), 64)
    qj, qt = jnp.asarray(q), torch.from_numpy(q)
    if q_dtype == "bf16":
        qj, qt = qj.astype(jnp.bfloat16), qt.bfloat16()
    want = np.asarray(jax_flash_attention_kvquant(
        qj, kq, vq, config=TileConfig(128, 128, one_pass=one_pass),
        out_dtype=jnp.float32))
    got = flash_attention_kvquant(qt, _port(kq), _port(vq),
                                  out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == q.shape
    ref = naive_attention(qt, np.asarray(jax_quant.dequantize(kq)),
                          np.asarray(jax_quant.dequantize(vq)))
    if q_dtype == "f32":
        _check_both(got.numpy(), want, ref, F32_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL)
        np.testing.assert_allclose(want, ref, atol=2e-3)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    if d > 256:
        assert torch.equal(got, attention_dtiled_plain(
            qt, _port(kq), _port(vq), 1.0 / math.sqrt(d)))


@pytest.mark.parametrize("pv_mode", ["bf16", "int8"])
@pytest.mark.parametrize("d", ODD_DIMS)
def test_int8_matches_jax_at_odd_head_dims(d, pv_mode):
    """B18 at d off the multiples of 16, a ragged KV (200 keys) in kv
    blocks of 48.  As tests/test_torch_quant.py's test_int8_matches_jax:
    port and JAX agree to 1e-5 wherever P's codes agree (at most 1% of O
    beyond, none beyond 2e-4: torch's and XLA's exp2 flip a rare rounding
    of P); each side against the oracle at the JAX tests' tiers, the
    ragged case's 1e-2 in bf16 mode (tests/test_attention_int8.py:62)."""
    qq, kq, vq, ref = _int8_inputs(1, 2, 128, 200, d, 128, 48, seed=d)
    want = np.asarray(jax_flash_attention_int8(
        qq, kq, vq, config=TileConfig(block_q=128, block_kv=128),
        out_dtype=jnp.float32, pv_mode=pv_mode))
    got = flash_attention_int8(_port(qq), _port(kq), _port(vq),
                               out_dtype=torch.float32, pv_mode=pv_mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = np.abs(got.numpy() - want)
    assert (diff > 1e-5).mean() < 0.01 and diff.max() < 2e-4
    tol = 1e-2 if pv_mode == "bf16" else INT8_ORACLE_TOL["int8"]
    assert np.abs(want - ref).max() < tol
    assert np.abs(got.numpy() - ref).max() < tol


def test_odd_head_dim_routes():
    """Every d off the multiples of 16 up to 256 runs H4-kvq (and H4-int8)
    on the smallest instance at or above it, every one from 257 to 2048
    H5's quantized form; the instance's zero-filled share at SigLIP-so400m's
    d=72 is 43.75% (D=128)."""
    for d in (x for x in range(1, 257) if x % 16):
        assert kvquant_kernel(d) == "H4-kvq"
        inst = h4_instance(d)
        assert inst in H4_INSTANCES and inst >= d
        assert inst == 64 or inst // 2 < d
    assert all(kvquant_kernel(d) == "H5" for d in range(257, 2049)
               if d % 16)
    assert 1 - 72 / h4_instance(72) == 0.4375


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("d", CARD_ODD_DIMS)
def test_card_limits_hold_h4kvq_roundings_at_odd_head_dims(d, kind):
    """H4-kvq's roundings at the quant phase's odd cases (its inputs and
    blocks of 100) read within half of the phase's limit against the plain
    version and the f64 oracle, and the controls beyond twice it: the
    scale off by 10%, the last 64 keys dropped, the neighbouring block's
    scales, and K's rows or V's rows misread (one element late; the last
    column dropped)."""
    q, k, v = _phase_inputs(d, d)
    kq, vq = QUANTIZERS[kind][0](k, 100), QUANTIZERS[kind][0](v, 100)
    scale = 1.0 / math.sqrt(d)
    emu = h4kvq_emulation(q, kq, vq, scale, h4_tile(d)).numpy()
    plain = attention_kvquant_plain(q, kq, vq, scale).numpy()
    o64 = naive_attention(q, dequantize(kq), dequantize(vq))
    assert np.abs(emu - plain).max() < CARD_KVQ_O_TOL / 2
    assert np.abs(emu - o64).max() < CARD_KVQ_O_TOL / 2
    bad = [attention_kvquant_plain(q, kq, vq, 1.1 * scale),
           attention_kvquant_plain(q, _dropped(kq), _dropped(vq), scale),
           attention_kvquant_plain(q, _rolled(kq), _rolled(vq), scale)]
    bad += [attention_kvquant_plain(q, km, vq, scale)
            for km in misread(kq).values()]
    bad += [attention_kvquant_plain(q, kq, vm, scale)
            for vm in misread(vq).values()]
    for x in bad:
        assert np.abs(emu - x.numpy()).max() > 2 * CARD_KVQ_O_TOL


@pytest.mark.parametrize("pv_mode", ["bf16", "int8"])
@pytest.mark.parametrize("d", CARD_ODD_DIMS)
def test_card_limits_hold_h4int8_roundings_at_odd_head_dims(d, pv_mode):
    """H4-int8's runs at the quant phase's odd cases (Q blocks of 64, K/V
    blocks of 48) reproduce the plain version within a hundredth of the
    phase's limit; against the f64 oracle pv_mode bf16 reads within half
    the suite's gate, pv_mode int8 within the plain version's own reading
    (B18's requantized P) plus half the limit; the controls, Q's, K's or
    V's rows misread among them, read beyond twice the limit."""
    q, k, v = _phase_inputs(d, d + 1)
    qq, kq, vq = quantize_int8(q, 64), quantize_int8(k, 48), \
        quantize_int8(v, 48)
    scale = 1.0 / math.sqrt(d)
    emu = h4int8_emulation(qq, kq, vq, scale, pv_mode, h4_tile(d)).numpy()
    plain = attention_int8_plain(qq, kq, vq, scale, pv_mode).numpy()
    assert np.abs(emu - plain).max() < CARD_INT8_PLAIN_TOL / 100
    o64 = naive_attention(*(dequantize(x) for x in (qq, kq, vq)))
    if pv_mode == "bf16":
        assert np.abs(emu - o64).max() < CARD_INT8_GATE_TOL / 2
    else:
        assert np.abs(emu - o64).max() < \
            np.abs(plain - o64).max() + CARD_INT8_PLAIN_TOL / 2
    bad = [attention_int8_plain(qq, kq, vq, 1.1 * scale, pv_mode),
           attention_int8_plain(qq, _dropped(kq), _dropped(vq), scale,
                                pv_mode),
           attention_int8_plain(qq, _rolled(kq), _rolled(vq), scale,
                                pv_mode)]
    for qm in misread(qq).values():
        bad.append(attention_int8_plain(qm, kq, vq, scale, pv_mode))
    for km in misread(kq).values():
        bad.append(attention_int8_plain(qq, km, vq, scale, pv_mode))
    for vm in misread(vq).values():
        bad.append(attention_int8_plain(qq, kq, vm, scale, pv_mode))
    for x in bad:
        assert np.abs(emu - x.numpy()).max() > 2 * CARD_INT8_PLAIN_TOL
