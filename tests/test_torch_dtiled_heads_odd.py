"""The d-tiled forward at head dims that are not a multiple of 16, vs the
JAX package.

``flash_attention_v1_dtiled`` runs H5 at every d from 1 to 2048
(``ops.attention.H5_HEAD_DIM_RULE``).  On the card, rows that no tensor
map takes (bf16 d % 8 != 0, f32 d % 4 != 0, codes d % 16 != 0) run on the
STAGED instances, whose producers copy them themselves.  The JAX function
(TPU kernel B19) takes any d up to 128 (its d tiles ``None``, min(d,
128) each) and past 128 only multiples of its d tile: at d=250 JAX
refuses, and the port's CPU path is held against the f64 oracle.  Here
the same NumPy inputs go through the JAX function (Pallas in interpret
mode) and the port's CPU path (H5's plain version) at d 1, 8, 33, 40,
72, 100 and 250, bf16 and quantized K/V, at
``tests/test_torch_dtiled.py``'s tolerances; H5's plan over the rule; and
H5's roundings, emulated at ``chip_smoke.py``'s odd cases (and H5's
quantized form past 256 at d 264, 520, 1000 and 2040), against its
limits, beside rows misread as a wrong staged load would read them.
"""

import math

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
from exploring_flash_attention_tpu_torch.oracle import (
    make_qkv,
    naive_attention,
)
from exploring_flash_attention_tpu_torch.ops import (
    attention_dtiled_plain,
    attention_kvquant_plain,
    dequantize,
    flash_attention_v1_dtiled,
)
from exploring_flash_attention_tpu_torch.ops.attention_v1_dtiled import (
    h5_plan,
)
from exploring_flash_attention_tpu_torch.ops.quant import tensor_from_numpy
from f32_pieces import one_torch_thread  # noqa: F401 (autouse)
from test_torch_dtiled import (
    CARD_DTILED_O_TOL,
    JAX_QUANT,
    QUANT,
    _check_both,
    _port,
    _rolled,
    f64_attention,
    h5_emulation,
)
from test_torch_quant_heads_odd import (
    CARD_ODD_DIMS,
    ODD_DIMS,
    misread,
    misread_rows,
)

# B19 with its d tiles off: min(d, 128) each, any d up to 128
CFG_D_TILES_OFF = TileConfig(block_q=128, block_kv=128, d_tile_qk=None,
                             d_tile_v=None)
# past 256, d off the multiples of 16 come only through the quantized-KV
# op: the last rank's last chunk cut at d (1 to 4 ranks)
H5_ODD_PAST_256 = (264, 520, 1000, 2040)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("d", ODD_DIMS)
def test_dtiled_matches_jax_at_odd_head_dims(d, kind):
    """bf16 q, bf16 or int8 / e4m3 K/V in blocks of 128, Lq 128 and Lkv
    256 (B19 takes L a multiple of its blocks and quant blocks of its
    block_kv), f32 O.  The port's
    CPU path is f32 math over the (dequantized) inputs, 2e-5 of the
    oracle; B19 rounds p * v_scale to bf16 before P V
    (attention_v1_dtiled.py:160-161): 2e-3 for its side and the pair, the
    tolerance of tests/test_torch_dtiled.py.  At d=250 B19 refuses (its d
    tile must divide d past 128) and the port reads within 2e-5 of the
    oracle."""
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16)
               for x in jax_make_qkv(1, 2, 128, d, seed=d, seq_len_kv=256))
    if kind != "bf16":
        k, v = JAX_QUANT[kind](k, 128), JAX_QUANT[kind](v, 128)
    qt = tensor_from_numpy(np.asarray(q), "cpu")
    if kind == "bf16":
        kt, vt = (tensor_from_numpy(np.asarray(x), "cpu") for x in (k, v))
        kd, vd = kt, vt
    else:
        kt, vt = _port(k), _port(v)
        kd, vd = (np.asarray(jax_quant.dequantize(x)) for x in (k, v))
    got = flash_attention_v1_dtiled(qt, kt, vt, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == qt.shape
    ref = naive_attention(qt, kd, vd)
    if d > 128:
        # B19's d tiles (min(d, 128) when None) must divide d past 128
        with pytest.raises(ValueError, match="divisible by d tiles"):
            jax_flash_attention_v1_dtiled(q, k, v, config=CFG_D_TILES_OFF)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
        return
    want = jax_flash_attention_v1_dtiled(q, k, v, config=CFG_D_TILES_OFF,
                                         out_dtype=jnp.float32)
    _check_both(got.numpy(), want, ref, 2e-3)


def test_h5_plan_at_odd_head_dims():
    """Every d off the multiples of 16 plans as the multiple of 16 above it
    does (the same chunks, cut at d): one block up to 512 (f32: 256)."""
    for f32 in (False, True):
        for d in (x for x in range(1, 2049) if x % 16):
            assert h5_plan(d, f32) == h5_plan(-(-d // 16) * 16, f32), d
        assert h5_plan(1, f32) == (1, 1)
        assert h5_plan(2040, f32) == ((8, 2) if f32 else (4, 4))


def _card_case(kind, d, lq=1000, lkv=1100, block=100, seed=0):
    """chip_smoke.py's dtiled odd cases (and the quant phase's H5 cases
    past 256): make_qkv rounded to bf16, the refereed heads [:1, :2], K/V
    quantized in blocks of ``block``."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in make_qkv(
        1, 2, lq, d, seed=seed, seq_len_kv=lkv))
    if kind != "bf16":
        k, v = QUANT[kind](k, block), QUANT[kind](v, block)
    return q, k, v


def _check_emulation(q, k, v, d, kind):
    """H5's emulated roundings within half the card's limit of the f64
    oracle and of the plain version (the dtiled phase's head-dim limit:
    at d 1 to 40, whose O is the largest, the emulation reads up to 1.4e-3
    against the oracle, past half the suite's gate, which holds the gate
    inputs only); the controls beyond twice that limit: the scale off by
    10%, the last 64 keys dropped, the neighbouring block's scales, and K's
    rows or V's rows misread (one element late; the last column dropped:
    at d=1 K and V read late together would keep their pairs)."""
    deq = (lambda x: x) if kind == "bf16" else dequantize  # noqa: E731
    kd, vd = deq(k), deq(v)
    scale = 1.0 / math.sqrt(d)
    emu = h5_emulation(q, k, v, scale).numpy()
    assert np.abs(emu - f64_attention(q, kd, vd, scale)).max() < \
        CARD_DTILED_O_TOL / 2
    assert np.abs(emu - attention_dtiled_plain(q, k, v, scale).numpy()
                  ).max() < CARD_DTILED_O_TOL / 2
    bad = [f64_attention(q, kd, vd, 1.1 * scale),
           f64_attention(q, kd[..., :-64, :], vd[..., :-64, :], scale)]
    if kind != "bf16":
        bad.append(f64_attention(q, dequantize(_rolled(k)),
                                 dequantize(_rolled(v)), scale))
    wrong = misread_rows if kind == "bf16" else misread
    for km in wrong(k).values():
        bad.append(f64_attention(q, deq(km), vd, scale))
    for vm in wrong(v).values():
        bad.append(f64_attention(q, kd, deq(vm), scale))
    for x in bad:
        assert np.abs(emu - x).max() > 2 * CARD_DTILED_O_TOL


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("d", CARD_ODD_DIMS)
def test_card_limits_hold_h5_roundings_at_odd_head_dims(d, kind):
    """The dtiled phase's odd cases (Lq 1000, Lkv 1100, blocks of 100)."""
    q, k, v = _card_case(kind, d)
    _check_emulation(q, k, v, d, kind)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("d", H5_ODD_PAST_256)
def test_card_limits_hold_h5_quantized_past_256_at_odd_head_dims(d, kind):
    """flash_attention_kvquant past 256 off the multiples of 16 (the quant
    phase's H5 cases): H5's quantized form, whose plain version is the
    quantized-KV op's, on clusters of 1 to 4 blocks whose last rank's last
    chunk is cut at d."""
    q, k, v = _card_case(kind, d, lq=256, lkv=330)
    scale = 1.0 / math.sqrt(d)
    assert torch.equal(attention_kvquant_plain(q, k, v, scale),
                       attention_dtiled_plain(q, k, v, scale))
    _check_emulation(q, k, v, d, kind)
