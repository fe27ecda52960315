"""Where a train step of the flagship LM spends its time on the card.

Run from the repository root on a machine with one CUDA card:

    python -m exploring_flash_attention_tpu_torch.utils.profile_train

It builds the flagship LM (``models.flagship_config``, random weights from
seed 0) and takes ``make_train_step``'s AdamW steps on tokens [8, 1025]
from ``np.random.default_rng(0)``, as ``chip_smoke.py``'s train phase
does.  It prints:

- the host-clock time of a step and of its three parts (forward and loss;
  backward; the optimizer step), each ended by a synchronize, over
  ``--repeats`` steps, sorted;
- one ``torch.profiler`` run of a whole step, as
  ``utils/profile_generate.py`` reads one: the wall time, the summed kernel
  time, their ratio (the device busy share), the number of kernel
  launches, the kernels that take the most device time, and H1, H3-dkv
  and H3-dq's share of the kernel time.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.models import (
    flagship_config,
    init_params,
    loss_fn,
    make_train_step,
)
from exploring_flash_attention_tpu_torch.models import transformer
from exploring_flash_attention_tpu_torch.utils.profile_generate import (
    profile_call,
)

ATTENTION_KERNELS = ("prefill_attention_kernel", "attention_bwd_dkv_kernel",
                     "attention_bwd_dq_kernel")


def _sync_clock() -> float:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def split_step(step, params, opt, tokens):
    """Host seconds of (forward and loss, backward, optimizer step) of one
    call of ``step``, the step that ``make_train_step`` built, with a
    synchronize at each boundary.  The step itself is not copied: its loss
    function is wrapped (the end of the forward) and ``opt`` hooked (the
    end of the backward and of the update).  Returns the parts and the
    step's loss."""
    marks = []

    def mark(*_):
        marks.append(_sync_clock())

    def marked_loss_fn(*args, **kwargs):
        loss = loss_fn(*args, **kwargs)
        mark()
        return loss

    hooks = (opt.register_step_pre_hook(mark),
             opt.register_step_post_hook(mark))
    try:
        with mock.patch.object(transformer, "loss_fn", marked_loss_fn):
            t0 = _sync_clock()
            loss = step(params, opt, tokens)
    finally:
        for hook in hooks:
            hook.remove()
    t1, t2, t3 = marks
    return (t1 - t0, t2 - t1, t3 - t2), loss


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--top", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = flagship_config()
    params = init_params(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 1025)).astype(np.int32)).to(dev)
    step, opt_init = make_train_step(cfg)
    opt = opt_init(params)
    for _ in range(3):                                  # builds, warms up
        step(params, opt, tokens)

    total, fwd, bwd, upd = [], [], [], []
    for _ in range(args.repeats):
        t0 = _sync_clock()
        step(params, opt, tokens)
        total.append(_sync_clock() - t0)
        (f, b, u), _ = split_step(step, params, opt, tokens)
        fwd.append(f)
        bwd.append(b)
        upd.append(u)
    print(f"train step s {sorted(total)}")
    print(f"  forward + loss s {sorted(fwd)}")
    print(f"  backward s {sorted(bwd)}")
    print(f"  optimizer s {sorted(upd)}")
    dev_ms, kern = profile_call("train step",
                                lambda: step(params, opt, tokens), args.top)
    attn_ms = sum(e.self_device_time_total for e in kern
                  if any(n in e.key for n in ATTENTION_KERNELS)) / 1e3
    print(f"  H1 + H3-dkv + H3-dq: {attn_ms:.3f} ms, "
          f"{attn_ms / dev_ms:.4f} of the kernel time")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
