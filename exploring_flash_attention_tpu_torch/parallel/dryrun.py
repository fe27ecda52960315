"""Run a function on every rank of a fresh ``torch.distributed`` job, and
the port's multi-device dry run.

Counterpart of ``__graft_entry__.dryrun_multichip`` in the JAX package,
which checks the sharded programs on ``n`` virtual CPU devices: here ``n``
processes, on gloo over the CPU or NCCL over ``n`` cards.

    python -m exploring_flash_attention_tpu_torch.parallel.dryrun 4 --cpu

runs it on 4 CPU ranks (gloo); without ``--cpu`` each rank takes a card.
"""

from __future__ import annotations

import math
import os
import queue
import sys
import tempfile
import traceback
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from exploring_flash_attention_tpu_torch.configs import MeshConfig
from exploring_flash_attention_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
)


def _rank_main(rank: int, n: int, init_method: str, device_type: str,
               fn: Callable, args: Tuple, results) -> None:
    try:
        torch.set_num_threads(1)
        init_distributed(rank, n, init_method, device_type)
        try:
            out = fn(rank, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:                   # the parent reports it
        results.put((rank, None, traceback.format_exc()))
        raise


def spawn(fn: Callable, n: int, args: Sequence[Any] = (),
          device_type: str = "cpu", timeout: float = 600.0) -> List[Any]:
    """``fn(rank, *args)`` on each of ``n`` spawned ranks of one process
    group (gloo for ``"cpu"``, NCCL for ``"cuda"``: a card a rank), with a
    file rendezvous of its own under ``TMPDIR``; returns the ranks' return
    values (picklable, NumPy arrays rather than tensors) in rank order.
    ``fn`` must be importable by name.  A rank that raises, or a job that
    outlasts ``timeout`` seconds, raises here with the rank's traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            r, n, init_method, device_type, fn, tuple(args), results))
            for r in range(n)]
        for p in procs:
            p.start()
        out, errors = [None] * n, []
        try:
            for _ in range(n):
                rank, value, err = results.get(timeout=timeout)
                out[rank] = value
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                    break
        except queue.Empty:
            errors.append(f"the job outlasted {timeout} s")
        finally:
            for p in procs:
                p.join(timeout=5 if errors else timeout)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("a rank failed: " + "\n".join(errors))
    return out


def factor(n: int) -> Tuple[int, int, int]:
    """(dp, tp, sp) of ``n`` ranks, as ``__graft_entry__._factor``: 2 on dp
    and 2 on tp where they divide, the rest on sp."""
    dp = 2 if n % 2 == 0 else 1
    rest = n // dp
    tp = 2 if rest % 2 == 0 else 1
    return dp, tp, rest // tp


def _dryrun_rank(rank: int, n: int, device_type: str) -> dict:
    from exploring_flash_attention_tpu_torch.models.tree import tree_leaves
    from exploring_flash_attention_tpu_torch.models.transformer import (
        ModelConfig,
        init_params,
        make_train_step,
        param_spec,
        shard_params,
    )
    from exploring_flash_attention_tpu_torch.ops.attention import (
        flash_attention,
    )
    from exploring_flash_attention_tpu_torch.parallel.mesh import (
        gather_tree,
        shard,
    )
    from exploring_flash_attention_tpu_torch.parallel.ring import (
        ring_attention,
    )
    from exploring_flash_attention_tpu_torch.parallel.window import (
        sp_window_attention,
    )

    dp, tp, sp = factor(n)
    mesh = make_mesh(MeshConfig(dp, tp, sp), device_type)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    dtype = torch.bfloat16 if device_type == "cuda" else torch.float32
    config = ModelConfig(vocab_size=512, n_layers=2, n_heads=2 * tp,
                         n_kv_heads=2 * tp, d_model=128, d_head=64,
                         d_ff=64 * tp, dtype=dtype)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, config.vocab_size, (2 * dp, 128 * sp + 1))).to(dev)

    # the sharded step against the one-device step on the same weights
    sgd = lambda leaves: torch.optim.SGD(leaves, lr=0.1)     # noqa: E731
    step1, init1 = make_train_step(config, optimizer=sgd)
    full = init_params(config, seed=0, device=dev)
    loss1 = step1(full, init1(full), tokens).item()
    stepn, initn = make_train_step(config, mesh=mesh, optimizer=sgd)
    params = shard_params(init_params(config, seed=0, device=dev), mesh,
                          config)
    opt = initn(params)
    loss = stepn(params, opt, tokens).item()
    got = gather_tree(params, param_spec(config), mesh)
    p_err = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(tree_leaves(got), tree_leaves(full)))
    loss2 = stepn(params, opt, tokens).item()

    # the causal ring (heads over tp) and the windowed hop against one
    # device's attention, each rank on its block
    def qkv(shape):
        x = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             .to(dev, dtype) for _ in range(3)]
        return x

    q, k, v = qkv((2, 2 * tp, 128 * sp, 64))
    o_ring = ring_attention(q, k, v, mesh, causal=True, head_axis="tp")
    ref = shard(shard(flash_attention(q, k, v, causal=True), mesh, "tp", 1),
                mesh, "sp", 2)
    ring_err = (o_ring.float() - ref.float()).abs().max().item()
    q, k, v = qkv((2, 2 * tp, 128 * sp, 64))
    local = [shard(shard(x, mesh, "tp", 1), mesh, "sp", 2) for x in (q, k, v)]
    o_win = sp_window_attention(*local, mesh.get_group("sp"), 96)
    ref = shard(shard(flash_attention(q, k, v, causal=True, window=96),
                      mesh, "tp", 1), mesh, "sp", 2)
    win_err = (o_win.float() - ref.float()).abs().max().item()
    return {"mesh": (dp, tp, sp), "loss": loss, "loss_one_device": loss1,
            "loss2": loss2, "param_err": p_err, "ring_err": ring_err,
            "window_err": win_err}


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """The port's multi-device dry run: ``n_devices`` ranks (gloo over the
    CPU for ``device_type="cpu"``, NCCL over as many cards for
    ``"cuda"``), a (dp, tp, sp) mesh by :func:`factor`, one sharded train
    step (SGD, 0.1) against the one-device step on the same weights (loss
    and every updated parameter), a second step whose loss must fall, and
    the causal ring and the windowed tail hop against one device's
    attention.  Limits: 1e-4 on the loss and 1e-3 elsewhere in f32 on the
    CPU, 2e-2 in bf16 on cards.  Returns the readings (the largest error
    over the ranks); raises if one is outside its limit."""
    ranks = spawn(_dryrun_rank, n_devices, (n_devices, device_type),
                  device_type)
    r = dict(ranks[0], **{x: max(rk[x] for rk in ranks) for x in (
        "param_err", "ring_err", "window_err")})
    loss_tol, tol = (1e-4, 1e-3) if device_type == "cpu" else (2e-2, 2e-2)
    ok = (abs(r["loss"] - r["loss_one_device"]) < loss_tol
          and r["param_err"] < tol and r["loss2"] < r["loss"]
          and r["ring_err"] < tol and r["window_err"] < tol
          and all(math.isfinite(r[x]) for x in ("loss", "loss2")))
    print(f"dryrun_multichip {'ok' if ok else 'FAILED'}: mesh(dp, tp, sp)="
          f"{r['mesh']}, loss {r['loss']:.6f} (one device "
          f"{r['loss_one_device']:.6f}) -> {r['loss2']:.6f}, max|dparam| "
          f"{r['param_err']:.2e}, ring {r['ring_err']:.2e}, window "
          f"{r['window_err']:.2e}")
    if not ok:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed: {r}")
    return r


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1,
                     "cpu" if "--cpu" in sys.argv else "cuda")
