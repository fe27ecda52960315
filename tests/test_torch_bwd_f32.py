"""f32 training on the port: what H3-dkv and H3-dq compute at f32 q, k, v
and dO, rehearsed on the CPU against the JAX package's f32 backward.

The JAX package's default dtype is f32 (``models/transformer.py:59``).
Its backward kernels (B11-B15, ``ops/attention_bwd.py``) ask Mosaic for
HIGHEST on every f32 product (``ops/attention_v1.py:202-210``) and keep P
and dS in q's dtype, f32 (``:174``, ``:192``).  On the card the port runs
them on H3's f32 instances (``csrc/attention_bwd.cu``): bf16x6 on wgmma,
as ``csrc/f32_attention.cuh`` computes every f32 product, with P and dS
split into three bf16 pieces like any f32 operand.  The emulation below
repeats that arithmetic in f32 torch ops in the kernels' tile order:
H3-dkv walks 32-row stages of Q and dO over its GQA group's heads, head
after head, H3-dq 32-key tiles of K and V; each stage's share of dK and
dV (of dQ) is its six piece products, then one f32 add to the running
sum.  Past d=128 (the D=256 instance) a cluster of two blocks splits the
columns: S^T and dP^T (S and dP) are the sum in f32 of two partials, each
the six piece products over 128 columns, columns 0-127 first.

Limits, the JAX package's own f32 tiers:
- against JAX's ``flash_attention_bwd`` at f32 (Pallas in interpret mode,
  as its tests run it): atol 1e-5, rtol 1e-4, its tier between two kernel
  routes of one gradient (``tests/test_attention_bwd.py:180``);
- against f64 autograd of the plain forward: max|g - g64| <= 1e-4
  max|g64| for each gradient (the rtol above), the limit ``chip_smoke.py``
  holds the card's kernels to, and JAX's backward-vs-autodiff tier, atol
  2e-4, rtol 2e-2 (``:66``), which JAX's f32 backward meets beside it.
Two known-wrong controls must read beyond the tight limits: the inputs
rounded to bf16 through the bf16 kernels' arithmetic (P and dS rounded to
bf16, bf16 gradients), and the f32 arithmetic with P and dS rounded to
bf16 (an f32 kernel that rounded them as the bf16 one does).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.ops import attention_bwd as jax_bwd_mod
from exploring_flash_attention_tpu_torch.ops.attention import LOG2E
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    attention_bwd_plain,
    flash_attention_bwd,
)
from exploring_flash_attention_tpu_torch.oracle import make_qkv
from f32_pieces import (  # noqa: F401 (one_torch_thread: autouse)
    BF16X6,
    one_torch_thread,
    piece_products,
)
from test_torch_bwd import _f64_forward, _f64_grads, _hidden, _inputs

ROUTES = dict(atol=1e-5, rtol=1e-4)     # tests/test_attention_bwd.py:180
ORACLE = dict(atol=2e-4, rtol=2e-2)     # tests/test_attention_bwd.py:66
CARD_REL_TOL = 1e-4                     # max|g - g64| / max|g64|
STAGE = 32         # rows of a streamed stage: Q/dO (H3-dkv), K/V (H3-dq)
BLOCK_COLS = 128   # columns of a block of the D=256 instance's cluster


def _rounded(x):
    return x.bfloat16().float()


def _over_depth(a, b):
    """a @ b, a sum over the depth d, as H3's f32 instances compute S and
    dP: the six piece products, and past d=128 one such product per
    block's 128 columns, the two added in f32."""
    if a.shape[-1] <= BLOCK_COLS:
        return piece_products(0.0, a, b, BF16X6)
    c = BLOCK_COLS
    return (piece_products(0.0, a[..., :c], b[..., :c, :], BF16X6)
            + piece_products(0.0, a[..., c:], b[..., c:, :], BF16X6))


def _emulate_h3_f32(q, k, v, out, do, lse, scale, hidden, round_pds=False):
    """(dq, dk, dv) f32 as H3's f32 instances compute them: S and dP as
    bf16x6 piece products (:func:`_over_depth`), P = exp2(s * scale *
    log2e - lse * log2e) (0 where ``hidden`` [Lq, Lkv] or lse = -inf),
    dS = P (dP - delta) scale, then dV += P^T dO, dK += dS^T Q and dQ +=
    dS K, each stage's share as bf16x6 piece products added in f32, in
    the kernels' tile order.
    ``round_pds``: P and dS rounded to bf16 first (the control)."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    g = hq // hkv
    hid = torch.as_tensor(hidden) | torch.isneginf(lse)[..., None]
    nlse = -lse * LOG2E
    delta = (do * out).sum(-1)
    c = scale * LOG2E

    def p_ds(s, dp, nl, dl, hidden_here):
        p = torch.where(hidden_here, 0.0, torch.exp2(s * c + nl))
        ds = p * (dp - dl) * scale
        return (_rounded(p), _rounded(ds)) if round_pds else (p, ds)

    # H3-dkv: every KV row at once, stage by stage (head h, rows q0..)
    qg, dog = (x.view(b, hkv, g, lq, d) for x in (q, do))
    nlg, dlg = (x.view(b, hkv, g, lq) for x in (nlse, delta))
    hidg = hid.view(b, hkv, g, lq, lkv)
    dk = torch.zeros(b, hkv, lkv, d)
    dv = torch.zeros(b, hkv, lkv, d)
    for h in range(g):
        for q0 in range(0, lq, STAGE):
            rows = slice(q0, q0 + STAGE)
            qt, dot = qg[:, :, h, rows], dog[:, :, h, rows]
            st = _over_depth(k, qt.transpose(-1, -2))
            dpt = _over_depth(v, dot.transpose(-1, -2))
            pt, dst = p_ds(st, dpt, nlg[:, :, h, None, rows],
                           dlg[:, :, h, None, rows],
                           hidg[:, :, h, rows].transpose(-1, -2))
            dv = dv + piece_products(0.0, pt, dot, BF16X6)
            dk = dk + piece_products(0.0, dst, qt, BF16X6)

    # H3-dq: every Q row at once, tile by tile of keys
    kr, vr = (x.repeat_interleave(g, 1) for x in (k, v))
    dq = torch.zeros(b, hq, lq, d)
    for k0 in range(0, lkv, STAGE):
        keys = slice(k0, k0 + STAGE)
        kt, vt = kr[:, :, keys], vr[:, :, keys]
        s = _over_depth(q, kt.transpose(-1, -2))
        dp = _over_depth(do, vt.transpose(-1, -2))
        _, ds = p_ds(s, dp, nlse[..., None], delta[..., None],
                     hid[..., keys])
        dq = dq + piece_products(0.0, ds, kt, BF16X6)
    return dq, dk, dv


def _bf16_kernels(q, k, v, out, do, lse, scale, hidden):
    """The bf16 kernels on the inputs rounded to bf16: exact products of
    bf16 values in f32, P and dS rounded to bf16, bf16 gradients."""
    grads = _emulate_h3_f32(_rounded(q), _rounded(k), _rounded(v), out,
                            _rounded(do), lse, scale, hidden,
                            round_pds=True)
    return tuple(_rounded(x) for x in grads)


def _card_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


MASKS = {"none": (False, None), "causal": (True, None),
         "window": (True, 100)}
# (B, Hq, Hkv, Lq, Lkv, d): GQA groups of 2 and 4, ragged Lq != Lkv (not
# multiples of 32), d 16 (on the D=64 instance), 80 (D=128's zero-filled
# columns), 128, 144 (the D=256 cluster's second block on 16 real
# columns) and 256
SHAPES = {16: (1, 4, 2, 200, 216, 16), 80: (1, 8, 2, 136, 150, 80),
          128: (1, 4, 2, 200, 216, 128), 144: (1, 4, 1, 136, 150, 144),
          256: (1, 4, 1, 136, 150, 256)}
CASES = [(d, m) for d in SHAPES for m in MASKS]
# traced (q_pos0, kv_pos0, window, d) at Lq = Lkv = 120: on the diagonal,
# a hop wholly in the past (every key seen), a window across the diagonal,
# at d=64, and the window at d=256
TRACED = ((120, 120, None, 64), (300, 0, None, 64), (100, 37, 40, 64),
          (100, 37, 40, 256))


def _emulations(q, k, v, do, causal, diag_off, window):
    """(the emulation, its two controls by name, f64 autograd) on the f64
    forward's O and LSE rounded to f32."""
    o64, lse64 = _f64_forward(q, k, v, causal, diag_off, window)
    out, lse = o64.astype(np.float32), lse64.astype(np.float32)
    hidden = torch.from_numpy(_hidden(q.shape[2], k.shape[2], causal,
                                      diag_off, window))
    args = (*(torch.from_numpy(x) for x in (q, k, v, out, do, lse)),
            1.0 / math.sqrt(q.shape[-1]), hidden)
    controls = {"bf16 kernels": _bf16_kernels(*args),
                "P and dS rounded": _emulate_h3_f32(*args, round_pds=True)}
    return (_emulate_h3_f32(*args), controls,
            _f64_grads(q, k, v, do, causal, diag_off, window))


def _check(q, k, v, do, causal, diag_off, window, jax_grads):
    """The emulation within JAX's f32 backward (ROUTES) and f64 autograd
    (CARD_REL_TOL, ORACLE), both controls beyond the tight limits."""
    emu, controls, ref = _emulations(q, k, v, do, causal, diag_off, window)
    for i, name in enumerate(("dq", "dk", "dv")):
        jg = np.asarray(jax_grads[i])
        np.testing.assert_allclose(jg, ref[i], **ORACLE,
                                   err_msg=f"jax {name} vs f64 autograd")
        np.testing.assert_allclose(emu[i].numpy(), ref[i], **ORACLE,
                                   err_msg=f"emulation {name} vs f64")
        np.testing.assert_allclose(emu[i].numpy(), jg, **ROUTES,
                                   err_msg=f"emulation {name} vs jax")
        assert _card_err(emu[i], ref[i]) <= CARD_REL_TOL / 4, name
        for what, bad in controls.items():
            assert _card_err(bad[i], ref[i]) > 4 * CARD_REL_TOL, (what, name)
            assert not np.allclose(bad[i].numpy(), jg, **ROUTES), (what,
                                                                   name)


@pytest.mark.parametrize("d,mask", CASES, ids=[f"d{d}-{m}" for d, m in CASES])
def test_h3_f32_arithmetic_matches_jax_and_f64(d, mask):
    b, hq, hkv, lq, lkv, _ = SHAPES[d]
    causal, window = MASKS[mask]
    q, k, v, do = _inputs(d, b, hq, hkv, lq, lkv, d)
    o64, lse64 = _f64_forward(q, k, v, causal, lkv - lq, window)
    jax_grads = jax_bwd_mod.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, o64.astype(np.float32), do,
                                   lse64.astype(np.float32))),
        causal=causal, window=window)
    _check(q, k, v, do, causal, lkv - lq, window, jax_grads)


@pytest.mark.parametrize("q_pos,kv_pos,window,d", TRACED,
                         ids=[f"{p}-{k}" + (f"-w{w}" if w else "")
                              + ("" if d == 64 else f"-d{d}")
                              for p, k, w, d in TRACED])
def test_h3_f32_arithmetic_at_traced_positions(q_pos, kv_pos, window, d):
    """At traced positions (JAX's B11-B15 with offs_ref), as the ring's
    hops run them, the same limits and controls."""
    q, k, v, do = _inputs(q_pos + kv_pos, 1, 4, 2, 120, 120, d)
    diag_off = q_pos - kv_pos
    o64, lse64 = _f64_forward(q, k, v, True, diag_off, window)
    jax_grads = jax_bwd_mod.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, o64.astype(np.float32), do,
                                   lse64.astype(np.float32))),
        causal=True, positions=(jnp.int32(q_pos), jnp.int32(kv_pos)),
        window=window)
    _check(q, k, v, do, True, diag_off, window, jax_grads)


# heads256's geometry (Hq=4 over one KV head, d=256: the D=256 instance) at
# B=1, L=512 (chip_smoke.py's f32_train phase runs B=8, L=1024), on inputs
# made as that phase makes them (the port's make_qkv, standard normal, seed
# d + Lq, dO from the next seed)
HEADS256 = (1, 4, 1, 512, 512, 256)


@pytest.mark.parametrize("mask", ["causal", "none"])
def test_card_limits_hold_at_heads256(mask):
    """The emulation reads within half the smoke's limit (CARD_REL_TOL,
    its F32_H3_TOL) of f64 autograd per gradient at heads256's geometry,
    where H3-dkv's resident rows sum over 4 x 512 q rows, while both
    known-wrong controls read beyond twice the limit."""
    b, hq, hkv, lq, lkv, d = HEADS256
    causal, window = MASKS[mask]
    q, k, v = make_qkv(b, hq, lq, d, dtype=np.float32, seed=d + lq,
                       seq_len_kv=lkv, heads_kv=hkv)
    do = make_qkv(b, hq, lq, d, dtype=np.float32, seed=d + lq + 1,
                  seq_len_kv=lkv, heads_kv=hkv)[0]
    emu, controls, ref = _emulations(q, k, v, do, causal, 0, window)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert _card_err(emu[i], ref[i]) <= CARD_REL_TOL / 2, name
        for what, bad in controls.items():
            assert _card_err(bad[i], ref[i]) > 2 * CARD_REL_TOL, (what, name)


def test_f32_cpu_backward_is_the_plain_one_in_f32():
    """On the CPU ``flash_attention_bwd`` at f32 is the plain backward:
    f32 gradients, within the card's limit of f64 autograd, as the f32
    kernels must be on the card."""
    q, k, v, do = _inputs(5, 1, 4, 2, 72, 104, 128)
    o64, lse64 = _f64_forward(q, k, v, True, 32)
    out, lse = o64.astype(np.float32), lse64.astype(np.float32)
    got = flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, out, do, lse)), causal=True)
    plain = attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, out, do, lse)),
        1.0 / math.sqrt(128), True, 32)
    ref = _f64_grads(q, k, v, do, True, 32)
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == torch.float32 and torch.equal(g, p)
        assert _card_err(g, r) <= CARD_REL_TOL / 4


def test_f32_past_d128_names_its_roadmap_item(monkeypatch):
    """f32 at d 144-256 passes the wrappers' checks and reaches the launch
    as f32 (the D=256 instance, a cluster of two blocks); d=272 is refused
    by the head-dim rule before any launch.  The wrappers' checks run
    where the tensors are: here they are driven with the CUDA check and
    stream stubbed and the library replaced by one that records its
    calls."""
    from types import SimpleNamespace

    from exploring_flash_attention_tpu_torch.ops import attention_bwd as bwd

    calls = []

    class Library:              # (entry, d, in_f32) of each launch
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a[-9], a[-3])) or 0

    monkeypatch.setattr(bwd, "_check_cuda_inputs",
                        lambda kernel, name, *t: t[0].dtype)
    monkeypatch.setattr(bwd.kernels, "library", Library)
    for fn in (bwd.attention_bwd_dkv, bwd.attention_bwd_dq):
        monkeypatch.setattr(fn, "launches", fn.launches)    # restored after
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    stat = torch.zeros(1, 2, 8)
    for d in (144, 208, 256):
        x = torch.zeros(1, 2, 8, d)
        bwd.attention_bwd_dkv(x, x, x, x, stat, stat, 1.0)
        bwd.attention_bwd_dq(x, x, x, x, stat, stat, 1.0)
    assert calls == [(f"eft_attention_bwd_{k}", d, 1)
                     for d in (144, 208, 256) for k in ("dkv", "dq")]
    x = torch.zeros(1, 2, 8, 272)
    for fn in (bwd.attention_bwd_dkv, bwd.attention_bwd_dq):
        with pytest.raises(ValueError, match="d from 1 to 256"):
            fn(x, x, x, x, stat, stat, 1.0)
    assert len(calls) == 6
