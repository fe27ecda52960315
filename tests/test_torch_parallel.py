"""The port's multi-rank attention on gloo ranks vs the JAX package.

Mirrors every test of tests/test_parallel.py.  The port runs in spawned
ranks on the CPU (``parallel.dryrun.spawn``, one job per mesh shared by
the module: sp = 2, 4 and 8, and (dp, tp, sp) = (2, 2, 2)), whose blocks
come back as NumPy arrays and are put together here.  References, with
the JAX tests' own tolerances: the f64 oracle for every forward (max|d|
1e-5 in f32); the JAX function on its 8-device virtual mesh (conftest)
for the split-KV combine, Ulysses, the causal ring at sp = 4 and the ring
on the 3-D mesh (atol 1e-5); and, for the gradients, JAX's one-device
``flash_attention`` gradients, which the JAX tests hold their ring,
Ulysses and windowed gradients against (atol 2e-5, rtol 1e-4; Ulysses
1e-5)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from exploring_flash_attention_tpu.configs import MeshConfig, TileConfig
from exploring_flash_attention_tpu.ops import flash_attention as jax_fa
from exploring_flash_attention_tpu.oracle.reference import (
    error_stats,
    make_qkv,
    naive_attention,
)
from exploring_flash_attention_tpu.parallel import (
    attention_partial_local as jax_partial,
    make_mesh as jax_make_mesh,
    merge_partials as jax_merge,
    ring_attention as jax_ring,
    splitkv_attention_xhost as jax_xhost,
    ulysses_attention as jax_ulysses,
)
from exploring_flash_attention_tpu_torch.parallel import (
    attention_partial_local,
    merge_partials,
)
from exploring_flash_attention_tpu_torch.parallel.dryrun import spawn
from exploring_flash_attention_tpu_torch.parallel.ring import ring_offsets
from exploring_flash_attention_tpu_torch.parallel.window import (
    _tail_len,
    _validate,
)
from torch_parallel_workers import attention_rank

CFG = TileConfig(block_q=64, block_kv=64)
MESHES = [(1, 1, 2), (1, 1, 4), (1, 1, 8), (2, 2, 2)]
ORACLE_TOL = 1e-5           # max|d| vs the f64 oracle, as the JAX tests
JAX_TOL = 1e-5              # vs the JAX function on its mesh, f32
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4   # the JAX tests' gradient tolerances


@pytest.fixture(scope="module")
def ranks():
    """Every mesh's per-rank results: one spawned job a mesh."""
    return {shape: spawn(attention_rank, math.prod(shape), (shape,))
            for shape in MESHES}


def _seq(ranks, shape, key):
    """The ranks' sequence blocks of ``key`` put together along dim 2 (a
    tuple of blocks: each part)."""
    parts = [r[key] for r in ranks[shape]]
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate(p, axis=2) for p in zip(*parts))
    return np.concatenate(parts, axis=2)


def _mesh(sp):
    return jax_make_mesh(MeshConfig(dp=1, tp=1, sp=sp))


@functools.lru_cache(maxsize=None)
def _jax_grads(seed_q, seed_kv, h, hkv, l, d, causal, window=None):
    """JAX's one-device gradients of sum(flash_attention(q, k, v)**2), K/V
    repeated over the GQA group (as the JAX tests take them)."""
    q = make_qkv(1, h, l, d, dtype=np.float32, seed=seed_q)[0]
    k, v = make_qkv(1, hkv, l, d, dtype=np.float32, seed=seed_kv)[1:]

    def loss(q, k, v):
        k, v = (jnp.repeat(x, h // hkv, axis=1) for x in (k, v))
        return jnp.sum(jax_fa(q, k, v, config=CFG, causal=causal,
                              window=window) ** 2)

    return (q, k, v), tuple(np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v))))


def _check_grads(got, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, r, atol=atol, rtol=rtol, err_msg=name)


def test_merge_partials_identity():
    rng = np.random.default_rng(0)
    o = rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
    lse = rng.standard_normal((2, 3, 16)).astype(np.float32)
    o2, lse2 = merge_partials(torch.zeros(o.shape),
                              torch.full(lse.shape, -math.inf),
                              torch.from_numpy(o), torch.from_numpy(lse))
    np.testing.assert_allclose(o2.numpy(), o, atol=1e-6)
    np.testing.assert_allclose(lse2.numpy(), lse, atol=1e-6)
    jo, jl = jax_merge(jnp.zeros(o.shape), jnp.full(lse.shape, -jnp.inf),
                       jnp.asarray(o), jnp.asarray(lse))
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo), atol=1e-6)


def test_merge_partials_associative():
    q, k, v = make_qkv(1, 2, 64, 32, dtype=np.float32, seq_len_kv=192,
                       seed=1)
    parts = [attention_partial_local(
        *(torch.from_numpy(x) for x in (q, k[:, :, s:s + 64],
                                        v[:, :, s:s + 64])))
        for s in (0, 64, 128)]
    o_l, lse_l = parts[0]
    for o_p, lse_p in parts[1:]:
        o_l, lse_l = merge_partials(o_l, lse_l, o_p, lse_p)
    o_r, lse_r = parts[2]
    for o_p, lse_p in reversed(parts[:2]):
        o_r, lse_r = merge_partials(o_p, lse_p, o_r, lse_r)
    np.testing.assert_allclose(o_l.numpy(), o_r.numpy(), atol=1e-5)
    assert error_stats(o_l.numpy(), naive_attention(q, k, v))["max_abs"] \
        < ORACLE_TOL
    jparts = [jax_partial(jnp.asarray(q), jnp.asarray(k[:, :, s:s + 64]),
                          jnp.asarray(v[:, :, s:s + 64]), config=CFG)
              for s in (0, 64, 128)]
    jo, jl = jparts[0]
    for o_p, lse_p in jparts[1:]:
        jo, jl = jax_merge(jo, jl, o_p, lse_p)
    np.testing.assert_allclose(o_l.numpy(), np.asarray(jo), atol=JAX_TOL)
    np.testing.assert_allclose(lse_l.numpy(), np.asarray(jl), atol=JAX_TOL)


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_splitkv_xhost(ranks, sp):
    q, k, v = make_qkv(1, 2, 128, 64, dtype=np.float32, seq_len_kv=512,
                       seed=2)
    outs = [r["xhost"] for r in ranks[(1, 1, sp)]]
    assert all(np.array_equal(o, outs[0]) for o in outs)   # replicated
    assert error_stats(outs[0], naive_attention(q, k, v))["max_abs"] \
        < ORACLE_TOL
    ref = jax_xhost(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    _mesh(sp), config=CFG)
    np.testing.assert_allclose(outs[0], np.asarray(ref), atol=JAX_TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention(ranks, sp):
    q, k, v = make_qkv(1, 2, 256, 64, dtype=np.float32, seed=3)
    out = _seq(ranks, (1, 1, sp), "ring")
    assert error_stats(out, naive_attention(q, k, v))["max_abs"] < ORACLE_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_ring_with_dp_tp_axes(ranks, causal):
    """(2, 2, 2): dp cuts the batch, tp the heads, sp rings the sequence;
    each rank's block is exactly 1/8 of the output, placed by its mesh
    coordinates (rank r at np.unravel_index(r, (2, 2, 2)))."""
    q, k, v = make_qkv(2, 4, 128, 32, dtype=np.float32, seed=4)
    out = np.zeros_like(q)
    for r, res in enumerate(ranks[(2, 2, 2)]):
        blk = res[f"ring_3d_{causal}"]
        assert blk.shape == (1, 2, 64, 32)
        b, h, s = np.unravel_index(r, (2, 2, 2))
        out[b:b + 1, 2 * h:2 * h + 2, 64 * s:64 * s + 64] = blk
    ref = naive_attention(q, k, v, causal=causal)
    assert error_stats(out, ref)["max_abs"] < ORACLE_TOL
    if causal:
        mesh = jax_make_mesh(MeshConfig(dp=2, tp=2, sp=2))
        spec = P("dp", "tp", "sp", None)
        jx = [jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
              for x in (q, k, v)]
        jout = jax_ring(*jx, mesh, config=CFG, causal=True,
                        batch_axis="dp", head_axis="tp")
        np.testing.assert_allclose(out, np.asarray(jout), atol=JAX_TOL)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grads(ranks, sp, causal):
    """The ring's backward (reverse ring, H3 at traced offsets on the card)
    vs JAX's one-device gradient."""
    (q, k, v), ref = _jax_grads(11, 11, 2, 2, 256, 64, causal)
    out, *grads = _seq(ranks, (1, 1, sp), f"ring_grads_{causal}")
    assert error_stats(out, naive_attention(q, k, v, causal=causal))[
        "max_abs"] < ORACLE_TOL
    _check_grads(grads, ref)


def test_ring_attention_gqa_grads(ranks):
    _, ref = _jax_grads(12, 13, 4, 2, 128, 32, True)
    _, *grads = _seq(ranks, (1, 1, 2), "ring_gqa_grads")
    _check_grads(grads, ref)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_causal(ranks, sp):
    q, k, v = make_qkv(1, 2, 256, 64, dtype=np.float32, seed=5)
    out = _seq(ranks, (1, 1, sp), "ring_causal")
    assert error_stats(out, naive_attention(q, k, v, causal=True))[
        "max_abs"] < ORACLE_TOL
    if sp == 4:             # JAX's ring at traced offsets on its mesh
        ref = jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       _mesh(4), config=CFG, causal=True)
        np.testing.assert_allclose(out, np.asarray(ref), atol=JAX_TOL)


def test_partial_positions_equivalence():
    """Traced positions (0-d tensors) reproduce the default decode
    convention, and JAX's traced result."""
    q, k, v = make_qkv(1, 1, 64, 32, dtype=np.float32, seq_len_kv=128,
                       seed=6)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o_a, lse_a = attention_partial_local(tq, tk, tv, causal=True)
    o_b, lse_b = attention_partial_local(
        tq, tk, tv, causal=True,
        positions=(torch.tensor(64), torch.tensor(0)))
    np.testing.assert_allclose(o_a.numpy(), o_b.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse_a.numpy(), lse_b.numpy(), atol=1e-6)
    jo, jl = jax_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         config=CFG, causal=True,
                         positions=(jnp.int32(64), jnp.int32(0)))
    np.testing.assert_allclose(o_b.numpy(), np.asarray(jo), atol=JAX_TOL)
    np.testing.assert_allclose(lse_b.numpy(), np.asarray(jl), atol=JAX_TOL)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention(ranks, sp, causal):
    q, k, v = make_qkv(1, 4, 256, 64, dtype=np.float32, seed=7)
    out = _seq(ranks, (1, 1, sp), f"ulysses_{causal}")
    assert error_stats(out, naive_attention(q, k, v, causal=causal))[
        "max_abs"] < ORACLE_TOL
    ref = jax_ulysses(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      _mesh(sp), config=CFG, causal=causal)
    np.testing.assert_allclose(out, np.asarray(ref), atol=JAX_TOL)


def test_ulysses_gqa_and_grads(ranks):
    """Ulysses over whole tensors: each rank's gradient holds its own
    blocks, so the ranks' gradients add up to the global one."""
    _, ref = _jax_grads(8, 9, 4, 2, 128, 32, True)
    parts = [r["ulysses_gqa_grads"] for r in ranks[(1, 1, 2)]]
    grads = [sum(p[i] for p in parts) for i in (1, 2, 3)]
    _check_grads(grads, ref, atol=1e-5, rtol=1e-4)


def test_ulysses_rejects_indivisible_heads(ranks):
    assert all("divisible" in r["ulysses_refusal"]
               for r in ranks[(1, 1, 4)])
    q, k, v = make_qkv(1, 2, 64, 32, dtype=np.float32, seed=10)
    with pytest.raises(ValueError, match="divisible"):
        jax_ulysses(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    _mesh(4))


def test_ring_128k_offsets():
    """The L = 128K tier (8 shards of 16K, the JAX test's lowering): every
    hop's traced pair, in int32 as the kernels read it, and the future hops
    (src > my) that see no key."""
    n, l_local = 8, 131072 // 8
    for my in range(n):
        offs = ring_offsets(my, n, l_local, l_local, torch.device("cpu"))
        assert offs.dtype == torch.int32 and offs.shape == (n, 2)
        src = [(my - s) % n for s in range(n)]
        assert offs[:, 0].tolist() == [my * l_local] * n
        assert offs[:, 1].tolist() == [x * l_local for x in src]
        future = [x > my for x in src]
        assert sum(future) == n - 1 - my
        # a future hop's first key lies past the shard's last row
        assert all(int(o[1]) > int(o[0]) + l_local - 1
                   for o, f in zip(offs, future) if f)


@pytest.mark.parametrize("sp,window", [(2, 96), (4, 128), (8, 32)])
def test_sp_window_attention(ranks, sp, window):
    q, k, v = make_qkv(1, 2, 1024, 64, dtype=np.float32, seed=20)
    out = _seq(ranks, (1, 1, sp), "window")
    ref = naive_attention(q, k, v, causal=True, window=window)
    assert error_stats(out, ref)["max_abs"] < ORACLE_TOL


@pytest.mark.parametrize("sp,window", [(2, 96), (4, 128)])
def test_sp_window_attention_grads(ranks, sp, window):
    """The one-hop backward vs JAX's one-device banded gradient."""
    _, ref = _jax_grads(21, 21, 2, 2, 1024, 64, True, window)
    _, *grads = _seq(ranks, (1, 1, sp), "window_grads")
    _check_grads(grads, ref)


def test_sp_window_gqa_grads(ranks):
    _, ref = _jax_grads(22, 23, 4, 2, 512, 64, True, 128)
    _, *grads = _seq(ranks, (1, 1, 2), "window_gqa_grads")
    _check_grads(grads, ref)


def test_sp_window_rejects_oversized_window(ranks):
    assert all("window <= L_local" in r["window_refusal"]
               for r in ranks[(1, 1, 8)])


def test_sp_window_128k_tail():
    """The L = 128K windowed tier (8 x 16K shards, window 4096; the JAX
    test's lowering): the shape passes the check, and the hop carries a
    tail of 4096 keys, a quarter of the shard."""
    _validate(16384, 4096)
    assert _tail_len(4096, 16384) == 4096
    assert _tail_len(96, 512) == 128 and _tail_len(32, 128) == 128
    with pytest.raises(NotImplementedError, match="window <= L_local"):
        _validate(128, 256)
