"""Rank functions of the port's multi-rank tests (tests/test_torch_parallel.py
and tests/test_torch_sharded.py).

Each runs in a gloo rank that ``parallel.dryrun.spawn`` starts on the CPU,
computes every case of one mesh and returns NumPy arrays, which the test
holds against the JAX package in the parent process.  This module imports
no JAX (a spawned rank imports it by name), so its inputs either come from
the port's ``make_qkv`` (the JAX oracle's numbers) or from the parent.
"""

from __future__ import annotations

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.configs import MeshConfig
from exploring_flash_attention_tpu_torch.models.tree import tree_leaves
from exploring_flash_attention_tpu_torch.oracle import make_qkv
from exploring_flash_attention_tpu_torch.parallel import (
    make_mesh,
    ring_attention,
    sp_window_attention,
    splitkv_attention_xhost,
    ulysses_attention,
)
from exploring_flash_attention_tpu_torch.parallel.mesh import (
    gather_tree,
    shard,
)
from exploring_flash_attention_tpu_torch.parallel.ring import (
    ring_flash_attention,
)

# (sp, window) of the windowed cases of tests/test_parallel.py
WINDOW_FWD = [(2, 96), (4, 128), (8, 32)]
WINDOW_GRADS = [(2, 96), (4, 128)]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _grads(fn, q, k, v):
    """(out, dq, dk, dv) of this rank's block under the loss sum(out**2),
    every rank's blocks together making the global loss's gradient."""
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    (out.float() ** 2).sum().backward()
    return tuple(_np(x) for x in (out, q.grad, k.grad, v.grad))


def attention_rank(rank: int, shape) -> dict:
    """Every case of tests/test_parallel.py on the mesh ``shape``: the
    forward outputs and (out, dq, dk, dv) of this rank's block, by case."""
    mesh = make_mesh(MeshConfig(*shape), "cpu")
    sp_g = mesh.get_group("sp")
    sp = shape[2]
    res = {}

    def block(*xs):
        return [shard(x, mesh, "sp", 2) for x in _t(*xs)]

    if shape[:2] == (1, 1):
        q, k, v = make_qkv(1, 2, 128, 64, seq_len_kv=512, seed=2)
        res["xhost"] = _np(splitkv_attention_xhost(*_t(q, k, v), mesh))
        for w_sp, window in WINDOW_FWD:
            if w_sp == sp:
                q, k, v = make_qkv(1, 2, 1024, 64, seed=20)
                res["window"] = _np(sp_window_attention(*block(q, k, v),
                                                        sp_g, window))
        for w_sp, window in WINDOW_GRADS:
            if w_sp == sp:
                q, k, v = make_qkv(1, 2, 1024, 64, seed=21)
                res["window_grads"] = _grads(
                    lambda a, b, c: sp_window_attention(a, b, c, sp_g,
                                                        window),
                    *block(q, k, v))
    if shape[:2] == (1, 1) and sp in (2, 4):
        q, k, v = make_qkv(1, 2, 256, 64, seed=3)
        res["ring"] = _np(ring_attention(*_t(q, k, v), mesh))
        q, k, v = make_qkv(1, 2, 256, 64, seed=5)
        res["ring_causal"] = _np(ring_attention(*_t(q, k, v), mesh,
                                                causal=True))
        q, k, v = make_qkv(1, 2, 256, 64, seed=11)
        for causal in (False, True):
            res[f"ring_grads_{causal}"] = _grads(
                lambda a, b, c: ring_flash_attention(a, b, c, sp_g,
                                                     causal=causal),
                *block(q, k, v))
        q, k, v = make_qkv(1, 4, 256, 64, seed=7)
        for causal in (False, True):
            res[f"ulysses_{causal}"] = _np(ulysses_attention(
                *_t(q, k, v), mesh, causal=causal))
    if shape == (1, 1, 2):
        q = make_qkv(1, 4, 128, 32, seed=12)[0]
        k, v = make_qkv(1, 2, 128, 32, seed=13)[1:]
        res["ring_gqa_grads"] = _grads(
            lambda a, b, c: ring_flash_attention(a, b, c, sp_g, causal=True),
            *block(q, k, v))
        q = make_qkv(1, 4, 128, 32, seed=8)[0]
        k, v = make_qkv(1, 2, 128, 32, seed=9)[1:]
        res["ulysses_gqa_grads"] = _grads(
            lambda a, b, c: ulysses_attention(a, b, c, mesh, causal=True),
            *_t(q, k, v))
        q = make_qkv(1, 4, 512, 64, seed=22)[0]
        k, v = make_qkv(1, 2, 512, 64, seed=23)[1:]
        res["window_gqa_grads"] = _grads(
            lambda a, b, c: sp_window_attention(a, b, c, sp_g, 128),
            *block(q, k, v))
    if shape == (1, 1, 4):
        q, k, v = make_qkv(1, 2, 64, 32, seed=10)
        try:
            ulysses_attention(*_t(q, k, v), mesh)
        except ValueError as exc:
            res["ulysses_refusal"] = str(exc)
    if shape == (1, 1, 8):
        q, k, v = make_qkv(1, 2, 1024, 64, seed=24)
        try:
            sp_window_attention(*block(q, k, v), sp_g, 256)
        except NotImplementedError as exc:
            res["window_refusal"] = str(exc)
    if shape == (2, 2, 2):
        q, k, v = make_qkv(2, 4, 128, 32, seed=4)
        for causal in (False, True):
            out = ring_attention(*_t(q, k, v), mesh, causal=causal,
                                 batch_axis="dp", head_axis="tp")
            res[f"ring_3d_{causal}"] = _np(out)
    return res


def model_rank(rank: int, shape, cases: dict) -> dict:
    """The sharded train steps of ``cases`` (name -> (kind, config, inputs))
    on the mesh ``shape``, each from ``init_params(seed=0)`` with SGD at
    0.1: the loss and every updated parameter, gathered over tp, in leaf
    order."""
    from exploring_flash_attention_tpu_torch.models import encoder, seq2seq
    from exploring_flash_attention_tpu_torch.models import transformer as tf

    mesh = make_mesh(MeshConfig(*shape), "cpu")

    def sgd(leaves):
        return torch.optim.SGD(leaves, lr=0.1)

    res = {}
    for name, (kind, cfg, inputs) in cases.items():
        if kind == "seq2seq":
            init = seq2seq.init_seq2seq_params
            spec = seq2seq.seq2seq_param_spec
            params = seq2seq.shard_seq2seq_params(
                init(cfg, seed=0, device="cpu"), mesh, cfg)
            step, opt_init = seq2seq.make_seq2seq_train_step(
                cfg, optimizer=sgd, mesh=mesh)
        else:
            init, spec = tf.init_params, tf.param_spec
            params = tf.shard_params(init(cfg, seed=0, device="cpu"), mesh,
                                     cfg)
            make = (encoder.make_mlm_train_step if kind == "mlm"
                    else tf.make_train_step)
            step, opt_init = make(cfg, optimizer=sgd, mesh=mesh)
        opt = opt_init(params)
        if kind == "mlm":
            tokens, mask = inputs
            loss = step(params, opt, torch.from_numpy(tokens), None,
                        mask=torch.from_numpy(mask))
        else:
            loss = step(params, opt, *_t(*inputs))
        full = gather_tree(params, spec(cfg), mesh)
        res[name] = (loss.item(), [_np(x) for x in tree_leaves(full)])
    return res
