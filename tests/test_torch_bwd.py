"""Port attention backward (H3's plain version, and autograd through the
port's ``flash_attention``) vs the JAX package, under no mask, causal and
a causal window.

The same NumPy f32 inputs go through the JAX function (Pallas in
interpret mode on the CPU, as the JAX tests run it) and through the port's
CPU path.  The JAX package picks one of three kernel routes by a VMEM rule
(fused B11; one-pass B12 + B13 when L % 8 != 0 or 2L does not fit; tiled
B14 + B15 when L does not fit either, forced here by patching
``fits_onepass`` as ``tests/test_attention_bwd.py:130`` does); each case
records which kernels JAX traced, so a test names the route it checks.

Tolerances:
- Each side against f64 autograd of the plain forward first, so that a
  failure names the side that drifted: atol 2e-4, rtol 2e-2, the JAX
  package's own backward-vs-autodiff tier
  (``tests/test_attention_bwd.py:66``).
  Both backward functions take out and LSE from the f64 oracle rounded to
  f32, so the rest of their error is f32 summation order and exp2.
- Port against JAX: atol 1e-5, rtol 1e-4, the JAX package's tier between
  two kernel routes of one gradient (``tests/test_attention_bwd.py:180``).
- The card limit of ``tests/test_torch_kernels.py`` and ``chip_smoke.py``
  (2e-2 of max|ref| per gradient) is rehearsed here against a CPU
  emulation of the kernels' roundings (P and dS to bf16 before their
  products, the gradients to bf16) under each mask: it must hold the
  emulation and be exceeded by the mask's known-wrong control (each row's
  diagonal key hidden; the last 64-key tile dropped; the window one key
  narrower).
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig
from exploring_flash_attention_tpu.ops import attention_bwd as jax_bwd_mod
from exploring_flash_attention_tpu.ops.attention_vjp import (
    flash_attention as jax_flash_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_plain,
    flash_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    LOG2E,
    attention_bwd_plain,
    flash_attention_bwd,
)

ORACLE = dict(atol=2e-4, rtol=2e-2)
ROUTES = dict(atol=1e-5, rtol=1e-4)
CARD_REL_TOL = 2e-2

KERNELS = ("_fused_bwd_kernel", "_dkv_onepass_kernel", "_dq_onepass_kernel",
           "_dkv_kernel", "_dq_kernel")


def _inputs(seed, b, hq, hkv, lq, lkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lkv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lkv, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    return q, k, v, do


def _hidden(lq, lkv, causal, diag_off, window):
    """[Lq, Lkv] bool, True where row i does not see key j: nothing hidden
    without ``causal``; j > i + diag_off, and with a window also
    j < i + diag_off - window + 1."""
    col, last = np.arange(lkv)[None, :], np.arange(lq)[:, None] + diag_off
    if not causal:
        return np.zeros((lq, lkv), bool)
    hidden = col > last
    if window is not None:
        hidden |= col < last - window + 1
    return hidden


def _f64_forward(q, k, v, causal, diag_off, window=None):
    """(o, lse) in f64 NumPy under the mask of :func:`_hidden`; a row that
    sees no key gives (0, -inf)."""
    g = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / math.sqrt(
        q.shape[-1])
    lq, lkv = s.shape[-2:]
    s = np.where(_hidden(lq, lkv, causal, diag_off, window), -np.inf, s)
    m = s.max(-1, keepdims=True)
    m = np.where(np.isneginf(m), 0.0, m)
    w = np.exp(s - m)
    den = w.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bhkd->bhqd", w / np.where(den == 0, 1, den), v)
    with np.errstate(divide="ignore"):
        lse = np.where(den[..., 0] == 0, -np.inf,
                       m[..., 0] + np.log(den[..., 0]))
    return o, lse


def _f64_grads(q, k, v, do, causal, diag_off, window=None):
    """Gradients of sum(o * do) by f64 autograd through the plain forward
    under the mask of :func:`_hidden` (rows that see no key give o = 0 and
    zero gradients)."""
    qd, kd, vd = (torch.from_numpy(x).double().requires_grad_()
                  for x in (q, k, v))
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", qd, kd.repeat_interleave(g, 1))
    s = s / math.sqrt(q.shape[-1])
    lq, lkv = s.shape[-2:]
    hidden = torch.from_numpy(_hidden(lq, lkv, causal, diag_off, window))
    empty = hidden.all(-1, keepdim=True)
    s = s.masked_fill(hidden, float("-inf")).masked_fill(empty, 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1),
                     vd.repeat_interleave(g, 1)).masked_fill(empty, 0.0)
    (o * torch.from_numpy(do).double()).sum().backward()
    return qd.grad.numpy(), kd.grad.numpy(), vd.grad.numpy()


@pytest.fixture
def traced_kernels(monkeypatch):
    """Names of the JAX backward kernels traced during the test."""
    seen = []
    for name in KERNELS:
        orig = getattr(jax_bwd_mod, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            seen.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(jax_bwd_mod, name, spy)
    jax_bwd_mod.flash_attention_bwd.clear_cache()     # trace afresh
    return seen


FUSED = {"_fused_bwd_kernel"}
ONEPASS = {"_dkv_onepass_kernel", "_dq_onepass_kernel"}
TILED = {"_dkv_kernel", "_dq_kernel"}

# (route, B, Hq, Hkv, Lq, Lkv, d, static_positions, causal, window, JAX
# kernels traced)
BWD_CASES = [
    ("b11", 1, 4, 2, 64, 64, 32, None, True, None, FUSED),
    ("b11_cross_negdiag", 1, 4, 2, 32, 48, 32, (0, 8), True, None, FUSED),
    ("b12_b13_cross", 1, 4, 2, 20, 36, 32, None, True, None, ONEPASS),
    ("b14_b15", 1, 4, 2, 40, 40, 32, None, True, None, TILED),
    ("b14_b15_cross_diag", 1, 4, 2, 24, 56, 32, (40, 3), True, None, TILED),
    ("b11_none_cross", 1, 4, 2, 32, 48, 32, None, False, None, FUSED),
    ("b12_b13_none_cross", 1, 4, 2, 20, 36, 32, None, False, None, ONEPASS),
    ("b14_b15_none_cross", 1, 4, 2, 40, 56, 32, None, False, None, TILED),
    ("b11_window", 1, 4, 2, 64, 64, 32, None, True, 20, FUSED),
    ("b14_b15_window_cross_diag", 1, 4, 2, 24, 56, 32, (40, 3), True, 20,
     TILED),
]


@pytest.mark.parametrize(
    "route,b,hq,hkv,lq,lkv,d,positions,causal,window,kernels", BWD_CASES,
    ids=[c[0] for c in BWD_CASES])
def test_flash_attention_bwd_matches_jax(traced_kernels, monkeypatch, route,
                                         b, hq, hkv, lq, lkv, d, positions,
                                         causal, window, kernels):
    if route.startswith("b14"):
        monkeypatch.setattr(jax_bwd_mod, "fits_onepass",
                            lambda *a, **kw: False)
    q, k, v, do = _inputs(zlib.crc32(route.encode()), b, hq, hkv, lq, lkv, d)
    diag_off = lkv - lq if positions is None else positions[0] - positions[1]
    o64, lse64 = _f64_forward(q, k, v, causal, diag_off, window)
    out, lse = o64.astype(np.float32), lse64.astype(np.float32)
    jax_grads = jax_bwd_mod.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, out, do, lse)),
        config=TileConfig(block_q=16, block_kv=16, q_chunk=16),
        causal=causal, static_positions=positions, window=window)
    assert set(traced_kernels) == kernels
    port_grads = flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v, out, do, lse)),
        causal=causal, static_positions=positions, window=window)
    ref = _f64_grads(q, k, v, do, causal, diag_off, window)
    for name, j, t, r in zip(("dq", "dk", "dv"), jax_grads, port_grads, ref):
        assert t.dtype == torch.float32 and t.shape == r.shape
        np.testing.assert_allclose(np.asarray(j), r, **ORACLE,
                                   err_msg=f"jax {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), r, **ORACLE,
                                   err_msg=f"port {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **ROUTES,
                                   err_msg=f"port {name} vs jax")
    if causal and diag_off < 0:         # rows that see no key: zero dQ
        assert (port_grads[0].numpy()[:, :, :-diag_off] == 0).all()


# (case, B, Hq, Hkv, Lq, Lkv, d, causal, window, JAX backward kernels
# traced): the forward is B4 (causal) or B8 (none) and the backward B11 at
# L % 8 == 0; B8 and B12/B13 otherwise; B5 under a window (Lkv a multiple
# of 128, as JAX's band forward needs); B14/B15 where the one-pass rule
# is patched off
GRAD_CASES = [
    ("b4_b11", 2, 4, 2, 32, 32, 64, True, None, FUSED),
    ("b8_b12_b13", 1, 4, 2, 20, 20, 64, True, None, ONEPASS),
    ("b4_b11_cross", 1, 2, 1, 24, 40, 64, True, None, FUSED),
    ("b8_b11_none_cross", 1, 4, 2, 24, 40, 64, False, None, FUSED),
    ("b8_b12_b13_none_cross", 1, 4, 2, 20, 36, 64, False, None, ONEPASS),
    ("b8_b14_b15_none", 1, 4, 2, 40, 40, 64, False, None, TILED),
    ("b5_b11_window", 1, 4, 2, 128, 128, 64, True, 48, FUSED),
    ("b5_b14_b15_window", 1, 4, 2, 128, 128, 64, True, 48, TILED),
]


@pytest.mark.parametrize("case,b,hq,hkv,lq,lkv,d,causal,window,kernels",
                         GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_autograd_through_flash_attention_matches_jax_grad(
        traced_kernels, monkeypatch, case, b, hq, hkv, lq, lkv, d, causal,
        window, kernels):
    if "b14" in case:
        monkeypatch.setattr(jax_bwd_mod, "fits_onepass",
                            lambda *a, **kw: False)
    q, k, v, g = _inputs(7, b, hq, hkv, lq, lkv, d)

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=causal,
                                           window=window) * g)

    jax_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    assert set(traced_kernels) == kernels
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    port_grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                     (qt, kt, vt))
    ref = _f64_grads(q, k, v, g, causal, lkv - lq, window)
    for name, j, t, r in zip(("dq", "dk", "dv"), jax_grads, port_grads, ref):
        np.testing.assert_allclose(np.asarray(j), r, **ORACLE,
                                   err_msg=f"jax {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), r, **ORACLE,
                                   err_msg=f"port {name} vs f64 autograd")
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **ROUTES,
                                   err_msg=f"port {name} vs jax")


def _kernel_emulation(q, k, v, out, do, lse, scale, causal, diag_off,
                      window):
    """H3's arithmetic on the CPU: f32 S and dP from bf16 inputs, P and dS
    rounded to bf16 before their products, f32 sums, bf16 gradients."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    hidden = (torch.from_numpy(_hidden(lq, lkv, causal, diag_off, window))
              | torch.isneginf(lse)[..., None])
    arg = qf @ kf.transpose(-1, -2) * (scale * LOG2E) - lse[..., None] * LOG2E
    p = torch.exp2(arg.masked_fill(hidden, float("-inf")))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = (p * (dof @ vf.transpose(-1, -2) - delta) * scale).masked_fill(
        hidden, 0.0)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    fold = lambda x: x.view(b, hkv, g, lkv, d).sum(2)      # noqa: E731
    return ((ds @ kf).bfloat16(), fold(ds.transpose(-1, -2) @ qf).bfloat16(),
            fold(p.transpose(-1, -2) @ dof).bfloat16())


def _control(mask, q, k, v, out, do, lse, scale, diag_off, window):
    """The known-wrong backward beside each mask, as ``chip_smoke.py``
    runs it: the diagonal key hidden (causal), the last 64-key tile dropped
    with its dK and dV rows left zero (none), the window one key narrower
    (window)."""
    if mask == "causal":
        return attention_bwd_plain(q, k, v, out, do, lse, scale, True,
                                   diag_off - 1)
    if mask == "window":
        return attention_bwd_plain(q, k, v, out, do, lse, scale, True,
                                   diag_off, window - 1)
    dq, dk, dv = attention_bwd_plain(q, k[:, :, :-64], v[:, :, :-64], out,
                                     do, lse, scale, False)
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 64))  # noqa: E731
    return dq, pad(dk), pad(dv)


MASKS = {"causal": (True, None), "none": (False, None), "window": (True, 100)}
# the flagship's d and d=64, then the new instances' depths: d=16 on the
# D=32 instance, 80 on D=128's zero-filled columns, 256 on the column-split
# instance (the emulation is the same arithmetic at any d).  d=16 takes
# the longer shape: at Lq 77 over Lkv 130 most rows' bands start at key 0,
# where a window one key narrower changes nothing, and its control reads
# only 1.8x the limit on dQ (7x or more at 200 over 216)
EMULATION_CASES = [(lq, lkv, d, mask) for mask in MASKS
                   for lq, lkv, d in ((200, 216, 128), (77, 130, 64),
                                      (200, 216, 16), (200, 216, 80),
                                      (77, 130, 256))]


@pytest.mark.parametrize(
    "lq,lkv,d,mask", EMULATION_CASES,
    ids=[f"{lq}-{lkv}-{d}" + ("" if m == "causal" else f"-{m}")
         for lq, lkv, d, m in EMULATION_CASES])
def test_card_limit_holds_kernel_roundings_and_not_a_mask_fault(lq, lkv, d,
                                                                mask):
    causal, window = MASKS[mask]
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(*s, generator=gen).bfloat16() for s in (
        (1, 4, lq, d), (1, 2, lkv, d), (1, 2, lkv, d), (1, 4, lq, d)))
    scale, diag_off = 1.0 / math.sqrt(d), lkv - lq
    out, lse = attention_plain(q, k, v, scale, causal, diag_off, window)
    out = out.bfloat16()
    ref = attention_bwd_plain(q, k, v, out, do, lse, scale, causal, diag_off,
                              window)
    emu = _kernel_emulation(q, k, v, out, do, lse, scale, causal, diag_off,
                            window)
    bad = _control(mask, q, k, v, out, do, lse, scale, diag_off, window)
    for e, r, x in zip(emu, ref, bad):
        peak = r.float().abs().max()
        assert (e.float() - r.float()).abs().max() / peak < CARD_REL_TOL / 2
        assert (e.float() - x.float()).abs().max() / peak > 5 * CARD_REL_TOL


def test_flash_attention_bwd_refuses_what_is_not_ported():
    """Tensors as ``static_positions`` raise ``TypeError`` (traced
    positions go in ``positions``, whose backward
    ``tests/test_torch_traced.py`` holds against JAX's); a window without
    ``causal`` raises ``ValueError`` as in the JAX package; the non-causal
    and windowed backward, once refused, now match JAX's."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9, 1, 2, 2, 8, 8, 16))
    out, lse = attention_plain(q, k, v, 0.25, True, 0)
    args = (q, k, v, out, do, lse)
    with pytest.raises(TypeError, match="static"):
        flash_attention_bwd(*args, causal=True,
                            static_positions=(torch.tensor(0), 0))
    with pytest.raises(ValueError, match="OR"):
        flash_attention_bwd(*args, causal=True, static_positions=(0, 0),
                            positions=(torch.tensor(0), torch.tensor(0)))
    with pytest.raises(ValueError, match="causal"):
        flash_attention_bwd(*args, causal=False, window=4)
    with pytest.raises(ValueError, match="causal"):
        jax_bwd_mod.flash_attention_bwd(
            *(jnp.asarray(x.numpy()) for x in args), causal=False, window=4)
    for causal, window in ((True, 4), (False, None)):
        o, l = attention_plain(q, k, v, 0.25, causal, 0, window)
        mine = (q, k, v, o, do, l)
        got = flash_attention_bwd(*mine, causal=causal, window=window)
        want = jax_bwd_mod.flash_attention_bwd(
            *(jnp.asarray(x.numpy()) for x in mine), causal=causal,
            window=window)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **ROUTES,
                                       err_msg=f"{name} causal={causal}")
    # a window that covers every key is plain causal, as in the JAX package
    for got, want in zip(flash_attention_bwd(*args, causal=True, window=8),
                         flash_attention_bwd(*args, causal=True)):
        assert torch.equal(got, want)
