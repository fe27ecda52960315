"""The quantized forwards at every head dim the port's kernels take, vs the
JAX package.

``flash_attention_kvquant`` runs H4-kvq at
``ops.attention.NARROW_HEAD_DIM_RULE`` (d from 1 to 256, on instances D
64, 128 and 256, a d below D on zero-filled columns) and H5's quantized
form past 256 up to 2048; ``flash_attention_int8`` runs H4-int8 at
``NARROW_HEAD_DIM_RULE``.  Here the multiples of 16; the other d are
``tests/test_torch_quant_heads_odd.py``'s.  The JAX
functions (TPU kernels B16, B17 and B18) take any d.  Here the same NumPy
inputs go through the JAX functions (Pallas in interpret mode) and the
port's CPU path (the kernels' plain versions) at head dims off and on the
instances, at the tolerances of ``tests/test_torch_quant.py``; the routes
and refusals of the rule; and the card kernels' roundings, emulated at
the new instances (H4-kvq's vmax and H4-int8's runs per 64-key tile at
D=256), against ``chip_smoke.py``'s limits for the quant phase's head-dim
cases, on inputs made as that phase makes them.
"""

import math
import re

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
    attention_dtiled_plain,
    attention_int8_plain,
    attention_kvquant_plain,
    dequantize,
    flash_attention_int8,
    flash_attention_kvquant,
    quantize_fp8,
    quantize_int8,
)
from exploring_flash_attention_tpu_torch.ops.attention import (
    H4_INSTANCES,
    H5_HEAD_DIM_RULE,
    NARROW_HEAD_DIM_RULE,
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

KVQ_DIMS = (16, 48, 80, 144, 256, 384)     # 384: H5's quantized form
INT8_DIMS = (16, 32, 80, 144, 256)


def h4_tile(d: int) -> int:
    """H4-kvq's and H4-int8's K/V tile at head dim d: 64 keys on the D=256
    instance, 128 below it."""
    return 64 if h4_instance(d) == 256 else 128


@pytest.mark.parametrize("one_pass", [None, False], ids=["b17", "b16"])
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("d", KVQ_DIMS)
def test_kvquant_matches_jax_at_head_dims(d, kind, q_dtype, one_pass):
    """B16 and B17 at d off and on the instances, a ragged KV (200 keys,
    blocks of 64).  f32 q: both sides f32 attention over the same
    dequantized K/V, within 2e-5 of the f64 oracle and of each other.
    bf16 q with f32 O: the port's plain path within 2e-5 of the oracle; JAX
    rounds P to bf16 before P V (attention_kvquant.py:100, :156), 2e-3 for
    its side and the two against each other (test_torch_quant.py's
    tolerances)."""
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
        # past 256 the card runs H5's quantized form, whose plain version
        # is the same function
        assert torch.equal(got, attention_dtiled_plain(
            qt, _port(kq), _port(vq), 1.0 / math.sqrt(d)))


@pytest.mark.parametrize("pv_mode", ["bf16", "int8"])
@pytest.mark.parametrize("d", INT8_DIMS)
def test_int8_matches_jax_at_head_dims(d, pv_mode):
    """B18 at d off and on the instances, a ragged KV (200 keys) in kv
    blocks of 48 (runs that end inside the 64- and 128-key tiles and, in
    int8 mode, inside a 32-key step).  As test_int8_matches_jax: port and
    JAX agree to 1e-5 wherever P's codes agree (at most 1% of O beyond,
    none beyond 2e-4: torch's and XLA's exp2 flip a rare rounding of P);
    each side against the oracle at the JAX tests' tiers, the ragged case's
    1e-2 in bf16 mode (tests/test_attention_int8.py:62)."""
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


def test_head_dim_routes():
    """Every d of the rules: H4-kvq (and H4-int8) on the smallest instance
    at or above d up to 256, H5's quantized form from 257 to 2048."""
    for d in range(1, 257):
        assert kvquant_kernel(d) == "H4-kvq"
        inst = h4_instance(d)
        assert inst in H4_INSTANCES and inst >= d
        assert inst == 64 or inst // 2 < d
    for d in range(257, 2049):
        assert kvquant_kernel(d) == "H5"
    # the share of an instance's products spent on zero-filled columns
    assert (h4_instance(80) - 80) / h4_instance(80) == 0.375


@pytest.mark.parametrize("op,d", [
    ("kvquant", 8), ("kvquant", 40), ("kvquant", 2064),
    ("int8", 8), ("int8", 40), ("int8", 264),
])
def test_head_dims_the_kernels_refuse(op, d):
    """The d these kernels refused before (8 and 40 off the multiples of
    16) they now take; a d off the rules raises ``ValueError`` naming the
    rule: for the quantized-KV op both of its rules (H4-kvq's up to 256,
    H5's past it) at d 0 and past 2048, for the int8 op H4-int8's at d 0
    and past 256.  The CPU path, the plain version, takes any d as the JAX
    functions do; the card's wrappers route through these."""
    rule = re.escape(NARROW_HEAD_DIM_RULE)
    if op == "kvquant":
        for bad in (0, 2049, d):
            if bad == d and d <= 2048:
                assert kvquant_kernel(d) == "H4-kvq"
                continue
            with pytest.raises(ValueError, match=rule) as e:
                kvquant_kernel(bad)
            assert H5_HEAD_DIM_RULE in str(e.value)
    else:
        for bad in (0, 257, d):
            if bad == d and d <= 256:
                assert h4_instance(d) >= d
                continue
            with pytest.raises(ValueError, match=rule):
                h4_instance(bad)


# chip_smoke.py's head-dim cases of the quant phase (QUANT_HEADS_SHAPE and
# its seeds: d for H4-kvq, d + 1 for H4-int8; the two heads of batch row 0
# that it referees): Lq 1000 and Lkv 1100, ragged at both tiles, H4-kvq's
# K/V in blocks of 100 (a tile's vmax over two blocks), H4-int8's Q in
# blocks of 64 and K/V in blocks of 48
HEADS_SHAPE = (2, 4, 1000, 1100)


def _phase_inputs(d, seed):
    """The phase's bf16 q, k, v (v1_inputs), its refereed slice [:1, :2]."""
    b, h, lq, lkv = HEADS_SHAPE
    return [torch.from_numpy(x[:1, :2].copy()).bfloat16()
            for x in make_qkv(b, h, lq, d, seed=seed, seq_len_kv=lkv)]


def _dropped(qt):
    return QuantizedTensor(qt.values[:, :, :-64], qt.scales, qt.block)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("d", [16, 80, 144, 256])
def test_card_limits_hold_h4kvq_roundings_at_head_dims(d, kind):
    """H4-kvq's roundings (P * v_scale / vmax to fp16, vmax per K/V tile:
    64 keys at D=256) read within half of the quant phase's limit against
    the plain version and the f64 oracle, and its controls (the scale off
    by 10%, the last 64 keys dropped, the neighbouring block's scales)
    beyond twice it.  A d below its instance computes the same sums: the
    zero-filled columns add exact zeros."""
    q, k, v = _phase_inputs(d, d)
    kq, vq = QUANTIZERS[kind][0](k, 100), QUANTIZERS[kind][0](v, 100)
    scale = 1.0 / math.sqrt(d)
    emu = h4kvq_emulation(q, kq, vq, scale, h4_tile(d)).numpy()
    plain = attention_kvquant_plain(q, kq, vq, scale).numpy()
    o64 = naive_attention(q, dequantize(kq), dequantize(vq))
    assert np.abs(emu - plain).max() < CARD_KVQ_O_TOL / 2
    assert np.abs(emu - o64).max() < CARD_KVQ_O_TOL / 2
    for bad in (attention_kvquant_plain(q, kq, vq, 1.1 * scale),
                attention_kvquant_plain(q, _dropped(kq), _dropped(vq), scale),
                attention_kvquant_plain(q, _rolled(kq), _rolled(vq), scale)):
        assert np.abs(emu - bad.numpy()).max() > 2 * CARD_KVQ_O_TOL


@pytest.mark.parametrize("pv_mode", ["bf16", "int8"])
@pytest.mark.parametrize("d", [16, 80, 144, 256])
def test_card_limits_hold_h4int8_roundings_at_head_dims(d, pv_mode):
    """H4-int8's runs (per 64-key tile at D=256, kv blocks of 48: a 16-key
    run, shorter than an int8 step, at every other tile) reproduce the
    plain version within a hundredth of the quant phase's limit, and the
    controls read beyond twice it.  Against the f64 oracle pv_mode bf16
    reads within half the suite's gate.  In pv_mode int8 the requantized
    P is B18's own error, which the plain version reads up to 3.1e-2 here
    (d=16, past the JAX test's 3e-2 tier): the phase holds the kernel
    within the plain version's reading plus its limit vs the plain
    version, which the emulation meets with half that limit to spare."""
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
    for bad in (attention_int8_plain(qq, kq, vq, 1.1 * scale, pv_mode),
                attention_int8_plain(qq, _dropped(kq), _dropped(vq), scale,
                                     pv_mode),
                attention_int8_plain(qq, _rolled(kq), _rolled(vq), scale,
                                     pv_mode)):
        assert np.abs(emu - bad.numpy()).max() > 2 * CARD_INT8_PLAIN_TOL
