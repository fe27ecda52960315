"""Port attention (prefill, kernel H1's plain version) vs the JAX package.

The same NumPy inputs go through the JAX function (Pallas in interpret
mode on the CPU, as the JAX tests run it) and through the port's CPU path,
in f32.  Tolerance: atol 1e-5 on O and LSE — both sides compute in f32 and
differ only in summation order (O is a convex combination of O(1) values,
LSE is O(1))."""

import dataclasses
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import cdiv as jax_cdiv
from exploring_flash_attention_tpu.ops import attention_bwd as jax_bwd_mod
from exploring_flash_attention_tpu.ops import (
    attention_v2_splitkv as jax_v2_mod,
)
from exploring_flash_attention_tpu.parallel import partials as jax_partials_mod
from exploring_flash_attention_tpu.serving import decode as jax_decode_mod
from exploring_flash_attention_tpu.serving import kv_cache as jax_kv_mod
from exploring_flash_attention_tpu.serving import scheduler as jax_sched_mod
from exploring_flash_attention_tpu.ops.attention_v1 import (
    causal_partial_onepass_eligible,
)
from exploring_flash_attention_tpu.ops.attention_vjp import (
    flash_attention as jax_flash_attention,
)
from exploring_flash_attention_tpu.parallel.partials import (
    attention_partial_local as jax_attention_partial_local,
)
from exploring_flash_attention_tpu_torch.configs import cdiv
from exploring_flash_attention_tpu_torch.oracle import (
    AccuracyError,
    check_accuracy,
    naive_attention,
)
from exploring_flash_attention_tpu_torch.ops.attention import (
    attention_partial_local,
    flash_attention,
    merge_partials,
)
from exploring_flash_attention_tpu_torch.ops.attention_v2_splitkv import (
    flash_attention_splitkv_partial,
    flash_attention_v2,
)
from exploring_flash_attention_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    Request,
    append_chunks,
    append_prompt,
    append_prompts,
    append_tokens,
    gather_kv,
    make_cache,
    paged_decode_attention,
    paged_extend_attention,
    set_seq_lens,
)
from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
    flash_attention_bwd,
)

ATOL = 1e-5


def _qkv(seed, b, hq, hkv, lq, lkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lkv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lkv, d)).astype(np.float32)
    return q, k, v


# (route, Lq, Lkv): B4 is the causal one-pass kernel (L % 8 == 0), B8 the
# split-KV partial kernel the ragged prompt falls to
ROUTES = [("b4", 64, 64), ("b8", 17, 17), ("b4_cross", 24, 40)]


@pytest.mark.parametrize("route,lq,lkv", ROUTES)
def test_attention_partial_local_matches_jax(route, lq, lkv):
    d = 64
    assert causal_partial_onepass_eligible(lq, lkv, d) == route.startswith(
        "b4")
    q, k, v = _qkv(0, 2, 4, 2, lq, lkv, d)                 # GQA 4/2
    o_ref, lse_ref = jax_attention_partial_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    o, lse = attention_partial_local(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    # each side against the f64 oracle first, so that a failure names the
    # side that drifted (this case once failed in a full parallel run with
    # a uniform 4.4e-5 relative error over ~10 rows, and never alone)
    rep = lambda x: np.repeat(x, 2, axis=1)                # noqa: E731
    o64, lse64 = naive_attention(q, rep(k), rep(v), causal=True,
                                 return_lse=True)
    for side, (o_x, lse_x) in {"jax": (o_ref, lse_ref),
                               "port": (o.numpy(), lse.numpy())}.items():
        np.testing.assert_allclose(np.asarray(o_x), o64, atol=ATOL,
                                   err_msg=f"{side} O vs f64 oracle")
        np.testing.assert_allclose(np.asarray(lse_x), lse64, atol=ATOL,
                                   err_msg=f"{side} LSE vs f64 oracle")
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)


def _same_default(ours, theirs) -> bool:
    """Defaults the two packages spell in their own types: a dtype by its
    name, a config dataclass by the fields both have (the JAX
    ``ModelConfig``'s TPU ``tile`` has no counterpart)."""
    if isinstance(ours, torch.dtype):
        return str(ours).removeprefix("torch.") == np.dtype(theirs).name
    if dataclasses.is_dataclass(ours):
        shared = ({f.name for f in dataclasses.fields(ours)}
                  & {f.name for f in dataclasses.fields(theirs)})
        return bool(shared) and all(
            _same_default(getattr(ours, n), getattr(theirs, n))
            for n in shared)
    return ours == theirs


# every module whose public functions the port exports, and its JAX
# counterpart: each exported callable that JAX has by the same name is a
# case of test_port_defaults_match_jax below
_EXPORTING = ["", ".configs", ".ops", ".models", ".models.transformer",
              ".models.encoder", ".models.seq2seq", ".models.parallel_layers",
              ".parallel", ".parallel.mesh", ".parallel.ring",
              ".parallel.ulysses", ".parallel.window", ".serving"]
# the multi-device entry points, which must be among those cases
_MESH_ENTRIES = {"make_mesh", "MeshConfig", "param_spec", "shard_params",
                 "seq2seq_param_spec", "shard_seq2seq_params",
                 "make_train_step", "make_mlm_train_step",
                 "make_seq2seq_train_step", "ring_attention",
                 "ring_flash_attention", "ulysses_attention",
                 "ulysses_flash_attention", "sp_window_attention",
                 "splitkv_attention_xhost", "f_tp", "g_tp", "gather_seq"}


def _exported_pairs():
    """(port callable, JAX callable) of every public name the port's
    modules export (their ``__all__``, else their public functions) that
    the JAX module of the same path has, sharing at least one parameter."""
    pairs, names = {}, set()
    for sub in _EXPORTING:
        ours = importlib.import_module("exploring_flash_attention_tpu_torch"
                                       + sub)
        theirs = importlib.import_module("exploring_flash_attention_tpu"
                                         + sub)
        public = getattr(ours, "__all__", None) or [
            n for n, x in vars(ours).items() if not n.startswith("_")
            and (inspect.isfunction(x) or inspect.isclass(x))
            and x.__module__ == ours.__name__]
        for name in public:
            port, jax_fn = getattr(ours, name, None), getattr(theirs, name,
                                                              None)
            if not (callable(port) and callable(jax_fn)):
                continue
            try:
                a = inspect.signature(port).parameters
                b = inspect.signature(jax_fn).parameters
            except (TypeError, ValueError):
                continue
            if any(n in b for n in a):
                pairs[(id(port), id(jax_fn))] = (port, jax_fn, (), 1)
                names.add(name)
    assert _MESH_ENTRIES <= names, _MESH_ENTRIES - names
    return list(pairs.values())


# (port, JAX counterpart, parameters both must have, fewest shared)
DEFAULTS_CASES = [
    (attention_partial_local, jax_attention_partial_local, ("causal",), 6),
    (flash_attention_bwd, jax_bwd_mod.flash_attention_bwd, ("causal",), 6),
    (flash_attention_splitkv_partial, jax_v2_mod.flash_attention_splitkv_partial,
     ("config", "scale", "causal", "workspace_dtype", "positions",
      "static_positions"), 9),
    (flash_attention_v2, jax_v2_mod.flash_attention_v2,
     ("config", "scale", "causal", "out_dtype"), 7),
    (merge_partials, jax_partials_mod.merge_partials,
     ("o_a", "lse_a", "o_b", "lse_b"), 4),
    (ContinuousBatchingScheduler, jax_sched_mod.ContinuousBatchingScheduler,
     ("n_pages", "page_size", "max_seqs", "max_pages_per_seq"), 7),
    (Request, jax_sched_mod.Request, ("max_new_tokens", "step_inputs"), 5),
    (make_cache, jax_kv_mod.make_cache,
     ("page_size", "max_seqs", "max_pages_per_seq"), 6),
    (append_tokens, jax_kv_mod.append_tokens, ("seq_ids",), 4),
    (append_chunks, jax_kv_mod.append_chunks, ("seq_ids",), 4),
    (append_prompt, jax_kv_mod.append_prompt, ("start", "page_ids"), 6),
    (append_prompts, jax_kv_mod.append_prompts, ("page_ids",), 5),
    (set_seq_lens, jax_kv_mod.set_seq_lens, ("new_lens",), 3),
    (gather_kv, jax_kv_mod.gather_kv, ("seq_id",), 2),
    (paged_decode_attention, jax_decode_mod.paged_decode_attention,
     ("scale", "window"), 5),
    (paged_extend_attention, jax_decode_mod.paged_extend_attention,
     ("scale", "window"), 5),
]


_LISTED = {(id(c[0]), id(c[1])) for c in DEFAULTS_CASES}
DEFAULTS_CASES += [c for c in _exported_pairs()
                   if (id(c[0]), id(c[1])) not in _LISTED]


@pytest.mark.parametrize("port,jax_fn,required,n_shared", DEFAULTS_CASES,
                         ids=[f"port{i}-jax_fn{i}"
                              for i in range(len(DEFAULTS_CASES))])
def test_port_defaults_match_jax(port, jax_fn, required, n_shared):
    """Every parameter the port shares with the JAX function has its name
    and its default: a caller who leaves one out gets the same function on
    both sides (the scheduler's ``n_pages=256, page_size=128,
    max_seqs=16``, ``causal=False`` on both V2 functions).  The cases are
    the listed ones and every other public callable the port's modules
    export that JAX has by name (``_exported_pairs``: the parallel package,
    ``make_mesh``, ``param_spec``, the ``mesh=`` train steps, ...).  Then
    ``attention_partial_local`` without ``causal`` is held against JAX's
    non-causal result on a case where causal differs."""
    ours = inspect.signature(port).parameters
    theirs = inspect.signature(jax_fn).parameters
    shared = [name for name in ours if name in theirs]
    assert set(required) <= set(shared) and len(shared) >= n_shared
    for name in shared:
        assert _same_default(ours[name].default, theirs[name].default), name
    if port is attention_partial_local:
        q, k, v = _qkv(11, 1, 4, 2, 32, 48, 64)
        o_ref, lse_ref = jax_attention_partial_local(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        o, lse = port(*(torch.from_numpy(x) for x in (q, k, v)))
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                                   atol=ATOL)
        causal_o, _ = port(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=True)
        assert (causal_o - o).abs().max() > 100 * ATOL


@pytest.mark.parametrize("lq,lkv", [(64, 64), (17, 17), (24, 16)])
def test_attention_partial_local_matches_f64_oracle(lq, lkv):
    """(24, 16): the first 8 q rows see no key and must give (0, -inf)."""
    q, k, v = _qkv(1, 1, 4, 2, lq, lkv, 64)
    rep = lambda x: np.repeat(x, 2, axis=1)                # noqa: E731
    o_ref, lse_ref = naive_attention(q, rep(k), rep(v), causal=True,
                                     return_lse=True)
    o, lse = attention_partial_local(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)
    if lq > lkv:
        assert np.isneginf(lse.numpy()[..., :lq - lkv]).all()
        assert (o.numpy()[..., :lq - lkv, :] == 0).all()


def test_flash_attention_forward_matches_jax():
    q, k, v = _qkv(2, 2, 4, 2, 32, 32, 64)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_flash_attention_refuses_what_is_not_ported():
    """A window at positions other than the decode convention raises on
    both sides, and so does a window at traced positions; traced positions
    without a window, the non-causal and the windowed calls, once refused,
    now match JAX's (their gradients: ``tests/test_torch_bwd.py``)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 2, 8, 8, 64))
    # gradients flow: the backward is ported (tests/test_torch_bwd.py
    # checks their values)
    qg = q.clone().requires_grad_()
    flash_attention(qg, k, v, causal=True).sum().backward()
    assert qg.grad.shape == q.shape and torch.isfinite(qg.grad).all()
    assert qg.grad.abs().max() > 0
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    np.testing.assert_allclose(
        flash_attention(q, k, v, causal=True,
                        positions=(torch.tensor(0), torch.tensor(0))).numpy(),
        np.asarray(jax_flash_attention(
            jq, jk, jv, causal=True,
            positions=(jnp.int32(0), jnp.int32(0)))), atol=ATOL)
    np.testing.assert_allclose(
        flash_attention(q, k, v, causal=False).numpy(),
        np.asarray(jax_flash_attention(jq, jk, jv, causal=False)), atol=ATOL)
    # JAX's band forward takes Lkv in multiples of 128
    qw, kw, vw = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 2, 128, 128, 64))
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (qw, kw, vw))
    np.testing.assert_allclose(
        flash_attention(qw, kw, vw, causal=True, window=48).numpy(),
        np.asarray(jax_flash_attention(jq, jk, jv, causal=True, window=48)),
        atol=ATOL)
    with pytest.raises(NotImplementedError, match="positions"):
        flash_attention(qw, kw, vw, causal=True, positions=(8, 8), window=48)
    with pytest.raises(NotImplementedError, match="positions"):
        jax_flash_attention(jq, jk, jv, causal=True, positions=(8, 8),
                            window=48)
    with pytest.raises(NotImplementedError, match="traced"):
        flash_attention(qw, kw, vw, causal=True, window=48,
                        positions=(torch.tensor(0), torch.tensor(0)))
    with pytest.raises(NotImplementedError, match="traced"):
        jax_flash_attention(jq, jk, jv, causal=True, window=48,
                            positions=(jnp.int32(0), jnp.int32(0)))


def test_flash_attention_records_no_graph_without_grad():
    """Under ``no_grad``, or with no input that requires grad, the call is
    the forward alone: the same output, no graph kept."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 1, 2, 2, 8, 8, 64))
    qg = q.clone().requires_grad_()
    with_graph = flash_attention(qg, k, v, causal=True)
    assert with_graph.grad_fn is not None
    with torch.no_grad():
        under_no_grad = flash_attention(qg, k, v, causal=True)
    no_leaf = flash_attention(q, k, v, causal=True)
    for got in (under_no_grad, no_leaf):
        assert got.grad_fn is None and not got.requires_grad
        assert torch.equal(got, with_graph.detach())


def test_flash_attention_takes_numpy_int_positions_as_static():
    """JAX counts ``np.integer`` positions as static
    (``ops/attention_vjp.py:65``)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 2, 2, 8, 12, 64))
    want = flash_attention(q, k, v, causal=True, positions=(6, 1))
    for pos in [(np.int32(6), np.int64(1)), (np.int64(6), 1)]:
        got = flash_attention(q, k, v, causal=True, positions=pos)
        assert torch.equal(got, want)
    ref = jax_flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), causal=True,
                              positions=(np.int32(6), np.int32(1)))
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("window", [12, 13, 100])
def test_flash_attention_window_covering_every_key_is_causal(window):
    """A window of Lkv or more is plain causal (``ops/attention_vjp.py:61``);
    Lkv = 12 here."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 2, 2, 8, 12, 64))
    assert torch.equal(flash_attention(q, k, v, causal=True, window=window),
                       flash_attention(q, k, v, causal=True))


def test_flash_attention_window_without_causal_raises_value_error():
    """As the JAX package does (``ops/attention_vjp.py:59-60``)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 1, 2, 2, 8, 8, 64))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="causal"):
        jax_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                            causal=False, window=8)


@pytest.mark.parametrize("a,b", [(0, 128), (1, 128), (128, 128),
                                 (129, 128), (280, 128), (1024, 128)])
def test_cdiv_matches_jax(a, b):
    assert cdiv(a, b) == jax_cdiv(a, b) == -(-a // b)


def test_check_accuracy_passes_and_fails():
    rng = np.random.default_rng(4)
    ref = rng.standard_normal((2, 8, 16))
    stats = check_accuracy(ref + 1e-4, ref)
    assert stats["max_abs"] < 2e-4
    with pytest.raises(AccuracyError, match="max_abs"):
        check_accuracy(ref + 0.1, ref)
