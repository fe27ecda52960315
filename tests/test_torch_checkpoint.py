"""The port's checkpoint (``models/checkpoint.py``) against the JAX package's.

Mirrors ``tests/test_checkpoint.py`` (round trip, latest, mismatch,
resume) on the port, and holds the file format to JAX's: a checkpoint of
params written by either package restores in the other bit for bit
(tolerance: none, every leaf bitwise).  The leaf order of the port's trees
(``models/tree.py``) is ``jax.tree_util``'s, for the LM and seq2seq trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import checkpoint as jckpt
from exploring_flash_attention_tpu.models import seq2seq as js2s
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    Seq2SeqConfig,
    init_params,
    init_seq2seq_params,
    latest_checkpoint,
    make_train_step,
    named_param_leaves,
    params_from_jax,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
    tree_unflatten,
)

KW = dict(vocab_size=128, n_layers=1, n_heads=2, n_kv_heads=2, d_model=32,
          d_head=16, d_ff=64)
CFG = ModelConfig(**KW)
BF16 = {"port": torch.bfloat16, "jax": jnp.bfloat16}


def _jcfg(dtype=jnp.float32, **kw):
    return jtf.ModelConfig(**{**KW, **kw}, dtype=dtype,
                           tile=JTileConfig(block_q=32, block_kv=32))


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_roundtrip_exact(tmp_path):
    params = init_params(CFG, seed=0, device="cpu")
    # a bf16 leaf exercises the uint16 view
    tree = {"p": params, "x": torch.arange(8, dtype=torch.bfloat16)}
    path = save_checkpoint(str(tmp_path), 7, tree)
    restored, step = restore_checkpoint(path, tree)
    assert step == 7
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_latest_selection(tmp_path):
    params = {"w": torch.ones(4)}
    save_checkpoint(str(tmp_path), 3, params)
    p10 = save_checkpoint(str(tmp_path), 10, params)
    save_checkpoint(str(tmp_path), 9, params)
    assert latest_checkpoint(str(tmp_path)) == p10
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert not [n for n in tmp_path.iterdir() if n.suffix == ".tmp"]


def test_structure_mismatch_rejected(tmp_path):
    path = save_checkpoint(str(tmp_path), 0, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(path, {"a": torch.ones(2), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, {"a": torch.ones(3)})


def test_resume_training(tmp_path):
    """Three AdamW steps, a checkpoint of params and optimizer, then the
    fourth step from the live state and from the restored one (an optimizer
    over the restored params, loaded from the restored state) give the same
    loss and params, bitwise."""
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size,
                                             (2, 33)).astype(np.int32)
    step_fn, opt_init = make_train_step(CFG)
    params = init_params(CFG, seed=1, device="cpu")
    opt = opt_init(params)
    for _ in range(3):
        step_fn(params, opt, toks)
    save_checkpoint(str(tmp_path), 3, {"params": params, "opt": opt})
    restored, step = restore_checkpoint(latest_checkpoint(str(tmp_path)),
                                        {"params": params, "opt": opt})
    assert step == 3
    loss_a = step_fn(params, opt, toks)                # continue the original
    opt_b = opt_init(restored["params"])
    opt_b.load_state_dict(restored["opt"])
    loss_b = step_fn(restored["params"], opt_b, toks)
    assert float(loss_a) == float(loss_b)
    for a, b in zip(tree_leaves(params), tree_leaves(restored["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jax_checkpoint_restores_into_port_bitwise(tmp_path, dtype):
    jdt = BF16["jax"] if dtype == "bf16" else jnp.float32
    pdt = BF16["port"] if dtype == "bf16" else torch.float32
    jparams = jtf.init_params(_jcfg(jdt), seed=2)
    path = jckpt.save_checkpoint(str(tmp_path), 5, jparams)
    like = init_params(ModelConfig(**KW, dtype=pdt), seed=0, device="cpu")
    restored, step = restore_checkpoint(path, like)
    assert step == 5
    want = params_from_jax(jax.device_get(jparams), device="cpu")
    for (name, got), ref, jleaf in zip(named_param_leaves(restored),
                                       tree_leaves(want),
                                       jax.tree_util.tree_leaves(jparams)):
        assert got.dtype == pdt, name
        np.testing.assert_array_equal(_as_numpy(got), _jax_bits(jleaf),
                                      err_msg=name)
        assert torch.equal(got, ref), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_checkpoint_restores_into_jax_bitwise(tmp_path, dtype):
    pdt = BF16["port"] if dtype == "bf16" else torch.float32
    jdt = BF16["jax"] if dtype == "bf16" else jnp.float32
    params = init_params(ModelConfig(**KW, dtype=pdt), seed=3, device="cpu")
    path = save_checkpoint(str(tmp_path), 11, params)
    like = jtf.init_params(_jcfg(jdt), seed=0)
    restored, step = jckpt.restore_checkpoint(path, like)
    assert step == 11
    for got, ref in zip(jax.tree_util.tree_leaves(restored),
                        tree_leaves(params)):
        assert got.dtype == jdt
        np.testing.assert_array_equal(_jax_bits(got), _as_numpy(ref))


def test_seq2seq_tree_order_is_jax_order(tmp_path):
    """The seq2seq tree (nested ``cross`` blocks) in both packages' leaf
    order: a JAX checkpoint restores into the port's tree, each leaf where
    ``params_from_jax`` puts it, and ``tree_unflatten`` inverts
    ``tree_leaves``.  The same seed draws the same weights."""
    jcfg = js2s.Seq2SeqConfig(base=_jcfg(), n_enc_layers=1, n_dec_layers=2)
    cfg = Seq2SeqConfig(base=CFG, n_enc_layers=1, n_dec_layers=2)
    jparams = js2s.init_seq2seq_params(jcfg, seed=4)
    path = jckpt.save_checkpoint(str(tmp_path), 1, jparams)
    like = init_seq2seq_params(cfg, seed=4, device="cpu")
    restored, _ = restore_checkpoint(path, like)
    want = params_from_jax(jax.device_get(jparams), device="cpu")
    leaves = tree_leaves(restored)
    assert len(leaves) == len(jax.tree_util.tree_leaves(jparams))
    for got, ref, drawn in zip(leaves, tree_leaves(want), tree_leaves(like)):
        assert torch.equal(got, ref) and torch.equal(drawn, ref)
    again = tree_unflatten(restored, leaves)
    assert again["dec_layers"][1]["cross"]["wk"] is \
        restored["dec_layers"][1]["cross"]["wk"]


def test_named_param_leaves_follow_tree_order():
    params = init_params(ModelConfig(**{**KW, "n_layers": 2}), seed=0,
                         device="cpu")
    named = named_param_leaves(params)
    assert all(a is b for (_, a), b in zip(named, tree_leaves(params)))
    assert len(named) == len(tree_leaves(params))
    jleaves = jax.tree_util.tree_leaves_with_path(
        jtf.init_params(_jcfg(n_layers=2), seed=0))
    assert [name for name, _ in named] == [
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jleaves]
