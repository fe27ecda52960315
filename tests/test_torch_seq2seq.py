"""The port's encoder-decoder family (``models/seq2seq.py``) against the JAX
package's.

Mirrors ``tests/test_seq2seq.py:41-104`` on the port (shapes across
lengths, a causal decoder over a bidirectional encoder, the cross block
against a dense softmax, training), then holds the forward, the loss,
every gradient and one Adam step to JAX's on the same weights
(``params_from_jax``) and tokens, in f32.  Tolerances: logits and loss
2e-5 absolute (both sides f32; the attention's summation order differs:
JAX's Pallas kernel in interpret mode, the port's plain version);
gradients 1e-4 of each leaf's largest entry; after one Adam step (an
update of lr * g / (|g| + eps), lr = 3e-3) the params within 2e-5 absolute
wherever |g| >= 1e-6, and within 2 lr elsewhere: where |g| is near eps =
1e-8 the first step's g / (|g| + eps) turns an f32 summation-order
difference of g into one of up to lr.  The sharded case waits for the
multi-GPU port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_flash_attention_tpu.configs import TileConfig as JTileConfig
from exploring_flash_attention_tpu.models import seq2seq as js2s
from exploring_flash_attention_tpu.models import transformer as jtf
from exploring_flash_attention_tpu_torch.models import (
    ModelConfig,
    Seq2SeqConfig,
    init_seq2seq_params,
    make_seq2seq_train_step,
    params_from_jax,
    seq2seq_forward,
    seq2seq_loss,
    tree_leaves,
)
from exploring_flash_attention_tpu_torch.models.seq2seq import (
    _cross_attn,
    encode,
)
from exploring_flash_attention_tpu_torch.models.transformer import _rmsnorm

KW = dict(vocab_size=64, n_heads=4, n_kv_heads=4, d_model=64, d_head=16,
          d_ff=128)
CFG = Seq2SeqConfig(base=ModelConfig(**KW), n_enc_layers=1, n_dec_layers=2)
JCFG = js2s.Seq2SeqConfig(
    base=jtf.ModelConfig(**KW, tile=JTileConfig(block_q=32, block_kv=32)),
    n_enc_layers=1, n_dec_layers=2)


def _toks(rng, b, l):
    return torch.from_numpy(rng.integers(0, KW["vocab_size"],
                                         (b, l)).astype(np.int32))


def _params(seed=0):
    return init_seq2seq_params(CFG, seed=seed, device="cpu")


@pytest.mark.parametrize("l_src,l_tgt", [(96, 48), (40, 72)])
def test_shapes_cross_length(l_src, l_tgt):
    """L_src != L_tgt either way round: the cross attention sees Lq = L_tgt
    against Lkv = L_src."""
    rng = np.random.default_rng(0)
    src, tgt = _toks(rng, 2, l_src), _toks(rng, 2, l_tgt)
    logits = seq2seq_forward(_params(), src, tgt, CFG)
    assert logits.shape == (2, l_tgt, KW["vocab_size"])
    assert logits.dtype == torch.float32 and logits.isfinite().all()


def test_decoder_is_causal_encoder_is_not():
    rng = np.random.default_rng(1)
    params = _params()
    src, tgt = _toks(rng, 2, 64), _toks(rng, 2, 64)
    logits = seq2seq_forward(params, src, tgt, CFG)
    # a late target token moves no earlier logit
    tgt2 = tgt.clone()
    tgt2[:, 50] = (tgt[:, 50] + 1) % KW["vocab_size"]
    logits2 = seq2seq_forward(params, src, tgt2, CFG)
    torch.testing.assert_close(logits[:, :50], logits2[:, :50], rtol=0,
                               atol=1e-5)
    assert (logits - logits2)[:, 50:].abs().max() > 1e-4
    # any source token reaches every decoder position, and every encoder
    # position (bidirectional)
    src2 = src.clone()
    src2[:, 60] = (src[:, 60] + 1) % KW["vocab_size"]
    delta = (logits - seq2seq_forward(params, src2, tgt, CFG)).abs()
    assert (delta.amax(dim=(0, 2)) > 1e-6).all()
    enc_delta = (encode(params, src, CFG) - encode(params, src2, CFG)).abs()
    assert (enc_delta.amax(dim=(0, 2)) > 1e-8).all()


def test_cross_attention_matches_oracle():
    """The decoder's cross block against a dense softmax composition."""
    rng = np.random.default_rng(2)
    p = _params()["dec_layers"][0]
    c = CFG.base
    x = torch.from_numpy(rng.normal(size=(2, 32, c.d_model)).astype(
        np.float32))
    mem = torch.from_numpy(rng.normal(size=(2, 64, c.d_model)).astype(
        np.float32))
    got = _cross_attn(p, x, mem, c)
    h = _rmsnorm(x, p["ln_x"], c.norm_eps)
    q = torch.einsum("ble,ehd->bhld", h, p["cross"]["wq"])
    k = torch.einsum("ble,ehd->bhld", mem, p["cross"]["wk"])
    v = torch.einsum("ble,ehd->bhld", mem, p["cross"]["wv"])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(c.d_head)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
    want = torch.einsum("bhld,hde->ble", o, p["cross"]["wo"])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-3)


def test_seq2seq_trains():
    """A copy task (target = source) is learnt: the loss drops by 0.5 over
    10 Adam steps, and the cross attention receives gradient."""
    rng = np.random.default_rng(3)
    params = _params()
    step, opt_init = make_seq2seq_train_step(CFG)
    opt = opt_init(params)
    src = _toks(rng, 4, 32)
    tgt = torch.cat([torch.zeros((4, 1), dtype=torch.int32), src], dim=1)
    losses = [float(step(params, opt, src, tgt)) for _ in range(10)]
    assert losses[-1] < losses[0] - 0.5, losses
    seq2seq_loss(params, src, tgt, CFG).backward()
    assert params["dec_layers"][0]["cross"]["wq"].grad.abs().max() > 0.0


def test_train_step_refuses_a_mesh():
    """The sharded step takes a ``DeviceMesh`` with the axes (dp, tp, sp)
    (``parallel.make_mesh``; its cases: ``tests/test_torch_sharded.py``);
    anything else is refused."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_seq2seq_train_step(CFG, mesh=object())


def _jax_case(seed=5, l_src=40, l_tgt=24):
    rng = np.random.default_rng(seed)
    jparams = js2s.init_seq2seq_params(JCFG, seed=seed)
    src = rng.integers(0, KW["vocab_size"], (2, l_src)).astype(np.int32)
    tgt = rng.integers(0, KW["vocab_size"], (2, l_tgt + 1)).astype(np.int32)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    return jparams, params, src, tgt


def test_params_forward_and_loss_match_jax():
    jparams, params, src, tgt = _jax_case()
    drawn = init_seq2seq_params(CFG, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(drawn),
                                                  tree_leaves(params)))
    want = np.asarray(js2s.seq2seq_forward(jparams, jnp.asarray(src),
                                           jnp.asarray(tgt[:, :-1]), JCFG))
    got = seq2seq_forward(params, torch.from_numpy(src),
                          torch.from_numpy(tgt[:, :-1]), CFG)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    jloss = float(js2s.seq2seq_loss(jparams, jnp.asarray(src),
                                    jnp.asarray(tgt), JCFG))
    loss = float(seq2seq_loss(params, torch.from_numpy(src),
                              torch.from_numpy(tgt), CFG))
    assert abs(loss - jloss) < 2e-5, (loss, jloss)


def test_every_gradient_matches_jax():
    jparams, params, src, tgt = _jax_case(seed=6)
    jgrads = jax.grad(js2s.seq2seq_loss)(jparams, jnp.asarray(src),
                                          jnp.asarray(tgt), JCFG)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = seq2seq_loss(params, torch.from_numpy(src), torch.from_numpy(tgt),
                        CFG)
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        scale = max(np.abs(jg).max(), 1e-12)
        assert np.abs(g.numpy() - jg).max() <= 1e-4 * scale


def test_one_adam_step_matches_jax():
    jparams, params, src, tgt = _jax_case(seed=7)
    jstep, jopt = js2s.make_seq2seq_train_step(JCFG)
    jnew, _, jloss = jstep(jparams, jopt.init(jparams), jnp.asarray(src),
                           jnp.asarray(tgt))
    step, opt_init = make_seq2seq_train_step(CFG)
    loss = step(params, opt_init(params), src, tgt)
    assert abs(float(loss) - float(jloss)) < 2e-5
    lr, moved = 3e-3, 0
    for got, want in zip(tree_leaves(params),
                         jax.tree_util.tree_leaves(jnew)):
        diff = np.abs(got.detach().numpy() - np.asarray(want))
        steep = got.grad.abs().numpy() >= 1e-6     # the port's g of the step
        assert diff[steep].max(initial=0.0) <= 2e-5
        assert diff.max() <= 2 * lr
        moved += int(steep.sum())
    assert moved > 0.9 * sum(x.numel() for x in tree_leaves(params))
