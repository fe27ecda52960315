"""The quantized and d-tiled forwards at f32 on the port: what H4-kvq and H5
compute for f32 inputs, rehearsed on the CPU against JAX's f32 functions.

JAX computes both in q's dtype: B16 and B17 cast the int8 or e4m3 codes
exactly to f32 and run S and P V in f32 (``ops/attention_kvquant.py:196``),
B19 runs every d-chunk product at HIGHEST (``ops/attention_v1_dtiled.py:
133``, ``:173``) with p * v_scale kept in an f32 ``p_scratch``.  On the
card the port runs them on bf16 wgmma with every f32 operand split into
three bf16 pieces (``tests/f32_pieces.py``):

- H4-kvq f32 (``csrc/kvquant_attention.cu``, the f32 core): 32-key tiles,
  S = the three piece products of q against the exact codes (bf16x3),
  s * k_scale * scale * log2e, P * v_scale split and multiplied with the
  V codes (bf16x3) from zero, each tile's P V added to alpha O in f32, l
  summing the unscaled p;
- H5 f32 (``csrc/dtiled_attention.cu``): 32-key tiles, S the sum in f32,
  in chunk order, of each 128-column d-chunk's product in its own
  accumulator: bf16x6 for f32 K and V, bf16x3 against codes; past d 256
  the chunks of each rank of a cluster (``h5_plan``) summed so, and S the
  sum of the ranks' partials from zero in rank order; P V as for H4-kvq
  (bf16x6 for f32 V), each tile's in a fresh accumulator added to alpha
  O in f32.

The emulations below repeat that arithmetic in f32 torch ops.  The limit
is the JAX tests' own, 2e-5 of the f64 oracle over the dequantized K/V
(``tests/test_quant.py:68``, ``tests/test_attention_dtiled.py:32``), which
``chip_smoke.py``'s ``f32_ops`` phase holds each card reading to against
the oracle and the plain f32 version.  On inputs made as that phase makes
them the emulations read within half of it, and both of its known-wrong
controls beyond it.
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
from exploring_flash_attention_tpu.ops.attention_kvquant import (
    flash_attention_kvquant as jax_flash_attention_kvquant,
)
from exploring_flash_attention_tpu.oracle.reference import (
    make_qkv as jax_make_qkv,
)
from exploring_flash_attention_tpu_torch.ops import (
    QuantizedTensor,
    attention_dtiled_plain,
    attention_kvquant_plain,
    dequantize,
    quantize_fp8,
    quantize_int8,
    quantized_from_numpy,
)
from exploring_flash_attention_tpu_torch.ops.attention import LOG2E
from exploring_flash_attention_tpu_torch.ops.attention_v1_dtiled import (
    h5_plan,
)
from exploring_flash_attention_tpu_torch.ops.quant import _expand
from exploring_flash_attention_tpu_torch.oracle import make_qkv, naive_attention
from f32_pieces import (  # noqa: F401 (one_torch_thread: autouse)
    BF16X3,
    BF16X6,
    one_torch_thread,
    piece_products,
)
from test_torch_dtiled import f64_attention, h5_emulation
from test_torch_quant import h4kvq_emulation

F32_TOL = 2e-5          # the JAX tests' f32 tier, and chip_smoke.py's
F32_TILE = 32           # keys per tile of both f32 kernels
D_CHUNK = 128           # H5's d-chunk
JAX_QUANT = {"int8": jax_quant.quantize_int8, "fp8": jax_quant.quantize_fp8}
QUANT = {"int8": quantize_int8, "fp8": quantize_fp8}


def f32_emulation(q, k, v, scale, chunk, per_rank=None):
    """The f32 kernels' arithmetic: 32-key tiles; S the sum over d-chunks
    of ``chunk`` columns of each chunk's piece products (bf16x6 for f32
    K, bf16x3 against codes), each from zero, in chunk order; with
    ``per_rank`` chunks a rank of a cluster, each rank's chunks summed so
    and S the sum from zero of the ranks' partials in rank order;
    s * (k_scale * f32(scale * log2e)) per key; the online softmax in the
    exp2 basis, l summing the f32 p; O = alpha O + the piece products of
    P * v_scale and V, those summed from zero and then added in f32."""
    if isinstance(k, QuantizedTensor):
        ks = _expand(k.scales, k.shape, k.block)[..., 0]
        vs = _expand(v.scales, v.shape, v.block)[..., 0]
        k, v, terms = k.values.float(), v.values.float(), BF16X3
    else:
        ks = vs = torch.ones(k.shape[:-1])
        terms = BF16X6
    kc = ks * torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full(q.shape[:-1], float("-inf"))
    l_row = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    width = chunk * (per_rank or -(-q.shape[-1] // chunk))
    for j in range(0, k.shape[2], F32_TILE):
        t = slice(j, j + F32_TILE)
        s = torch.zeros(*q.shape[:-1], k[..., t, :].shape[2])
        for r in range(0, q.shape[-1], width):
            part = torch.zeros(s.shape)
            for c in range(r, min(r + width, q.shape[-1]), chunk):
                cs = slice(c, c + chunk)
                part = part + piece_products(
                    torch.zeros(s.shape), q[..., cs],
                    k[..., t, cs].transpose(-1, -2), terms)
            s = s + part
        s = s * kc[..., None, t]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l_row = l_row * alpha + p.sum(-1)
        o = o * alpha[..., None] + piece_products(
            0.0, p * vs[..., None, t], v[..., t, :], terms)
        m = m_new
    return o / l_row[..., None]


def h4kvq_f32(q, k_q, v_q, scale):
    """H4-kvq at f32 q: one product over the whole head dim, each tile's
    P V in a fresh accumulator."""
    return f32_emulation(q, k_q, v_q, scale, q.shape[-1])


def h5_f32(q, k, v, scale):
    """H5 at f32: S summed over 128-column d-chunks, by rank of the
    cluster of ``h5_plan``, each tile's P V in a fresh accumulator."""
    return f32_emulation(q, k, v, scale, D_CHUNK,
                         h5_plan(q.shape[-1], True)[1])


def _port(qt_jax) -> QuantizedTensor:
    return quantized_from_numpy(np.asarray(qt_jax.values),
                                np.asarray(qt_jax.scales), qt_jax.block,
                                device="cpu")


def _dequant_ref(q, kq, vq):
    return naive_attention(q, np.asarray(jax_quant.dequantize(kq)),
                           np.asarray(jax_quant.dequantize(vq)))


def _within(emu, want, ref):
    np.testing.assert_allclose(emu, ref, atol=F32_TOL,
                               err_msg="emulation vs f64 oracle")
    np.testing.assert_allclose(emu, np.asarray(want), atol=F32_TOL,
                               err_msg="emulation vs JAX")


# (Lq, Lkv, d, block): tests/test_quant.py:54's shape, and a ragged KV
@pytest.mark.parametrize("one_pass", [None, False], ids=["b17", "b16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("lq,lkv,d,block", [(256, 256, 128, 128),
                                            (128, 200, 64, 64)])
def test_h4kvq_f32_emulation_matches_jax(lq, lkv, d, block, kind, one_pass):
    """H4-kvq's f32 arithmetic against B17 (one pass) and B16 (streaming)
    in interpret mode, f32 q over the same codes: 2e-5 of JAX and of the
    f64 oracle over the dequantized K/V."""
    q, k, v = jax_make_qkv(1, 2, lq, d, seed=3, seq_len_kv=lkv)
    kq, vq = (JAX_QUANT[kind](jnp.asarray(x), block) for x in (k, v))
    want = jax_flash_attention_kvquant(
        jnp.asarray(q), kq, vq,
        config=TileConfig(128, 128, one_pass=one_pass),
        out_dtype=jnp.float32)
    emu = h4kvq_f32(torch.from_numpy(q), _port(kq), _port(vq),
                    1.0 / np.sqrt(d))
    _within(emu.numpy(), want, _dequant_ref(q, kq, vq))


@pytest.mark.parametrize("d,kind", [(256, "f32"), (512, "f32"),
                                    (256, "int8"), (256, "fp8"),
                                    (640, "int8"), (1024, "f32")])
def test_h5_f32_emulation_matches_jax(d, kind):
    """H5's f32 arithmetic against B19 in interpret mode at
    tests/test_attention_dtiled.py's shape: f32 q, k, v (bf16x6), or f32
    q over int8 or e4m3 K/V in blocks of 128 (bf16x3): 2e-5 of JAX and of
    the f64 oracle; d 512, 640 and 1024 in clusters of 2 and 4 blocks."""
    q, k, v = jax_make_qkv(1, 2, 256, d, seed=0)
    cfg = TileConfig(block_q=128, block_kv=128, d_tile_qk=128,
                     d_tile_v=128)
    scale = 1.0 / np.sqrt(d)
    if kind == "f32":
        want = jax_flash_attention_v1_dtiled(
            *map(jnp.asarray, (q, k, v)), config=cfg)
        emu = h5_f32(*map(torch.from_numpy, (q, k, v)), scale)
        ref = naive_attention(q, k, v)
    else:
        kq, vq = (JAX_QUANT[kind](jnp.asarray(x), 128) for x in (k, v))
        want = jax_flash_attention_v1_dtiled(jnp.asarray(q), kq, vq,
                                             config=cfg)
        emu = h5_f32(torch.from_numpy(q), _port(kq), _port(vq), scale)
        ref = _dequant_ref(q, kq, vq)
    _within(emu.numpy(), want, ref)


def rounded_p_plain(q, k, v, scale):
    """A known-wrong f32 version: the plain one with P rounded to bf16
    before P V (what a kernel that kept the bf16 P would compute)."""
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (p.bfloat16().double() @ v.double()) / p.sum(-1, keepdim=True)


# (kernel, B, H, Lq, Lkv, d, kind, block, seed): chip_smoke.py's KVQ_CASES
# and DTILED_CASES with the f32_ops phase's additions (d 128 and 384, H5
# at 4096 keys), one head of each: f32 inputs from make_qkv; the ragged
# head dims and the clusters of 2, 4 and 8 blocks (h5_plan) of d 640,
# 1024 and 2048
CARD_CASES = [
    ("h4kvq", 1, 1, 1024, 1024, 128, "int8", 512, 1),
    ("h4kvq", 1, 1, 1024, 1024, 128, "fp8", 512, 1),
    ("h4kvq", 1, 1, 1024, 8192, 128, "int8", 128, 2),
    ("h4kvq", 1, 1, 1024, 1100, 128, "fp8", 128, 3),
    ("h5", 1, 1, 1024, 1024, 512, "f32", None, 1),
    ("h5", 1, 1, 1024, 1024, 512, "fp8", 512, 1),
    ("h5", 1, 1, 1024, 1024, 512, "int8", 512, 1),
    ("h5", 1, 1, 1000, 1100, 256, "f32", None, 5),
    ("h5", 1, 1, 1000, 1100, 128, "int8", 128, 6),
    ("h5", 1, 1, 1000, 1100, 384, "f32", None, 7),
    ("h5", 1, 1, 1024, 4096, 512, "f32", None, 8),
    ("h5", 1, 1, 1000, 1100, 64, "f32", None, 5),
    ("h5", 1, 1, 1000, 1100, 96, "f32", None, 5),
    ("h5", 1, 1, 1000, 1100, 144, "f32", None, 5),
    ("h5", 1, 1, 1000, 1100, 640, "f32", None, 5),
    ("h5", 1, 1, 1024, 1024, 1024, "f32", None, 1),
    ("h5", 1, 1, 1024, 1024, 1024, "int8", 512, 1),
    ("h5", 1, 1, 1024, 1024, 2048, "f32", None, 1),
    ("h5", 1, 1, 1024, 1024, 2048, "fp8", 512, 1),
]


@pytest.mark.parametrize("kernel,b,h,lq,lkv,d,kind,block,seed", CARD_CASES)
def test_card_limits_hold_f32_ops(kernel, b, h, lq, lkv, d, kind, block,
                                  seed):
    """The emulation reads within half the smoke's limit against the plain
    f32 version and the f64 oracle, while each known-wrong control reads
    beyond twice the limit against the oracle: the bf16 kernel on the
    inputs rounded to bf16 (its emulation), the plain version with P
    rounded to bf16 and, in a cluster, one rank's partial only (S over
    rank 0's columns)."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(
        b, h, lq, d, seed=seed, seq_len_kv=lkv))
    scale = 1.0 / np.sqrt(d)
    qb = q.bfloat16()
    if kind == "f32":
        kd, vd = k, v
        kb, vb = k.bfloat16(), v.bfloat16()
    else:
        k, v = QUANT[kind](k, block), QUANT[kind](v, block)
        kd, vd = dequantize(k), dequantize(v)
        kb, vb = k, v
    if kernel == "h4kvq":
        emu = h4kvq_f32(q, k, v, scale)
        plain = attention_kvquant_plain(q, k, v, scale)
        bf16 = h4kvq_emulation(qb, kb, vb, scale)
    else:
        emu = h5_f32(q, k, v, scale)
        plain = attention_dtiled_plain(q, k, v, scale)
        bf16 = h5_emulation(qb, kb, vb, scale)
    oracle = f64_attention(q, kd, vd, scale)
    assert np.abs(emu.numpy() - oracle).max() < F32_TOL / 2
    assert np.abs(emu.numpy() - plain.numpy()).max() < F32_TOL / 2
    bad = [bf16.numpy(), rounded_p_plain(q, kd, vd, scale).numpy()]
    c, nc = h5_plan(d, True) if kernel == "h5" else (1, 1)
    if c > 1:
        w = nc * D_CHUNK
        bad.append(f64_attention(q[..., :w], kd[..., :w], vd, scale))
    for x in bad:
        assert np.abs(x - oracle).max() > 2 * F32_TOL
