"""The port's sharded train steps on gloo ranks vs the JAX package's on its
virtual mesh.

Mirrors the sharded cases of tests/test_model.py (the LM at (2, 2, 2),
(1, 4, 2), (2, 1, 4); the windowed LM at (1, 2, 2), (2, 1, 2); the MLM
encoder at (2, 2, 2), (1, 4, 2), (1, 1, 4)) and of tests/test_seq2seq.py
(seq2seq at (2, 2, 2), (1, 4, 2), (1, 1, 4)), plus the LM with
``sp_attn="allgather"`` (K/V gathered, the causal mask at each shard's
traced offset) at (1, 1, 4).  Each mesh is one spawned job
(``parallel.dryrun.spawn``) that runs every case of that mesh from
``init_params(seed=0)`` (the JAX package's numbers) with SGD at 0.1, and
returns the loss and every updated parameter gathered over tp.  JAX runs
the same step with ``shard_map`` on its 8-device CPU mesh (conftest).
Tolerances are the JAX tests' own: the loss within 1e-4, every parameter
within atol 5e-4, rtol 1e-3."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from exploring_flash_attention_tpu.configs import MeshConfig as JMeshConfig
from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import encoder as jenc
from exploring_flash_attention_tpu.models import seq2seq as js2s
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu.parallel import make_mesh as jax_make_mesh
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    Seq2SeqConfig,
)
from exploring_flash_attention_tpu_torch.parallel.dryrun import spawn
from torch_parallel_workers import model_rank

LM = dict(vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=4, d_model=64,
          d_head=16, d_ff=128)
WIN = dict(vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
           d_model=128, d_head=64, d_ff=256, window=96)
S2S = dict(vocab_size=256, n_layers=1, n_heads=4, n_kv_heads=4, d_model=64,
           d_head=16, d_ff=128)
TILE32, TILE128 = (JTileConfig(block_q=32, block_kv=32),
                   JTileConfig(block_q=128, block_kv=128))
LOSS_TOL, ATOL, RTOL = 1e-4, 5e-4, 1e-3       # tests/test_model.py:80-87


def _cases():
    """name -> (mesh, kind, port config, JAX config, inputs)."""
    out = {}
    toks = np.random.default_rng(2).integers(0, 256, (4, 65)).astype(
        np.int32)
    for mesh in [(2, 2, 2), (1, 4, 2), (2, 1, 4)]:
        out[f"lm{mesh}"] = (mesh, "lm", ModelConfig(**LM),
                            jtf.ModelConfig(**LM, tile=TILE32), (toks,))
    for dp, tp, sp in [(1, 2, 2), (2, 1, 2)]:
        wt = np.random.default_rng(5).integers(
            0, 256, (2 * dp, 256 * sp + 1)).astype(np.int32)
        out[f"window{(dp, tp, sp)}"] = (
            (dp, tp, sp), "lm", ModelConfig(**WIN),
            jtf.ModelConfig(**WIN, tile=TILE128), (wt,))
    mt = np.random.default_rng(8).integers(0, 256, (4, 128)).astype(np.int32)
    for mesh in [(2, 2, 2), (1, 4, 2), (1, 1, 4)]:
        out[f"mlm{mesh}"] = (mesh, "mlm", ModelConfig(**LM),
                             jtf.ModelConfig(**LM, tile=TILE32), (mt,))
    rng = np.random.default_rng(9)
    src = rng.integers(0, 255, (4, 64)).astype(np.int32)
    tgt = rng.integers(0, 255, (4, 129)).astype(np.int32)
    for mesh in [(2, 2, 2), (1, 4, 2), (1, 1, 4)]:
        out[f"seq2seq{mesh}"] = (
            mesh, "seq2seq",
            Seq2SeqConfig(base=ModelConfig(**S2S), n_enc_layers=2,
                          n_dec_layers=2),
            js2s.Seq2SeqConfig(base=jtf.ModelConfig(**S2S, tile=TILE32),
                               n_enc_layers=2, n_dec_layers=2),
            (src, tgt))
    out["allgather(1, 1, 4)"] = (
        (1, 1, 4), "lm", ModelConfig(**LM, sp_attn="allgather"),
        jtf.ModelConfig(**LM, tile=TILE32, sp_attn="allgather"), (toks,))
    return out


CASES = _cases()
MLM_KEY = 7


def _mlm_mask(tokens):
    """JAX's MLM mask of the JAX test's key, handed to the port."""
    _, mask = jenc.mask_tokens(jnp.asarray(tokens), jax.random.PRNGKey(
        MLM_KEY), 255, 0.15)
    return np.asarray(mask)


@pytest.fixture(scope="module")
def port():
    """Every case's (loss, gathered params) from one spawned job a mesh."""
    by_mesh = {}
    for name, (mesh, kind, cfg, _, inputs) in CASES.items():
        if kind == "mlm":
            inputs = (inputs[0], _mlm_mask(inputs[0]))
        by_mesh.setdefault(mesh, {})[name] = (kind, cfg, inputs)
    out = {}
    for mesh, cases in by_mesh.items():
        ranks = spawn(model_rank, math.prod(mesh), (mesh, cases))
        for name in cases:
            # every rank holds the same loss and full parameters
            for r in ranks[1:]:
                assert r[name][0] == ranks[0][name][0]
            out[name] = ranks[0][name]
    return out


def _jax_step(name):
    """JAX's sharded step of ``name`` on its virtual mesh (the JAX tests'
    own call): (loss, updated parameter leaves)."""
    mesh_shape, kind, _, jcfg, inputs = CASES[name]
    mesh = jax_make_mesh(JMeshConfig(*mesh_shape))
    sgd = optax.sgd(0.1)
    if kind == "seq2seq":
        params = js2s.init_seq2seq_params(jcfg, seed=0)
        step, opt = js2s.make_seq2seq_train_step(jcfg, optimizer=sgd,
                                                 mesh=mesh)
        params = js2s.shard_seq2seq_params(params, mesh, jcfg)
    else:
        params = jtf.init_params(jcfg, seed=0)
        make = (jenc.make_mlm_train_step if kind == "mlm"
                else jtf.make_train_step)
        step, opt = make(jcfg, optimizer=sgd, mesh=mesh)
        params = jtf.shard_params(params, mesh, jcfg)
    args = [jnp.asarray(x) for x in inputs]
    if kind == "mlm":
        args.append(jax.random.PRNGKey(MLM_KEY))
    new, _, loss = step(params, opt.init(params), *args)
    return float(loss), [np.asarray(x) for x in
                         jax.tree.leaves(jax.device_get(new))]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(port, name):
    loss, leaves = port[name]
    j_loss, j_leaves = _jax_step(name)
    assert abs(loss - j_loss) < LOSS_TOL, (loss, j_loss)
    assert len(leaves) == len(j_leaves)
    for i, (a, b) in enumerate(zip(leaves, j_leaves)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("n", [3, 8])
def test_dryrun_multichip_on_gloo_ranks(n):
    """The port's ``dryrun_multichip`` (``__graft_entry__.dryrun_multichip``'s
    counterpart) on n gloo ranks: (dp, tp, sp) = (1, 1, 3) and (2, 2, 2) by
    ``__graft_entry__._factor``'s rule; it raises if the sharded step, the
    ring or the windowed hop leaves its limit (1e-4 loss, 1e-3 elsewhere)."""
    from exploring_flash_attention_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
        factor,
    )

    r = dryrun_multichip(n, "cpu")
    assert tuple(r["mesh"]) == factor(n) == {3: (1, 1, 3), 8: (2, 2, 2)}[n]
    assert r["loss2"] < r["loss"]
