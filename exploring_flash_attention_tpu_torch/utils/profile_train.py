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
  and H3-dq's share of the kernel time;
- the same for one step of the encoder (``make_mlm_train_step``, the same
  geometry bidirectional, tokens [8, 1024] under one fixed mask, as
  ``chip_smoke.py``'s encoder phase runs it): its host-clock step times
  and its profiled step;
- the same for one seq2seq step (``make_seq2seq_train_step``, 2 encoder
  and 2 decoder layers at the flagship's widths, src [8, 1024], tgt
  [8, 257], as ``chip_smoke.py``'s seq2seq phase runs it): its host-clock
  step times, their three parts, and its profiled step.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.models import (
    Seq2SeqConfig,
    flagship_config,
    init_params,
    init_seq2seq_params,
    make_mlm_train_step,
    make_seq2seq_train_step,
    make_train_step,
    mask_tokens,
)
from exploring_flash_attention_tpu_torch.models import seq2seq, transformer
from exploring_flash_attention_tpu_torch.utils.profile_generate import (
    profile_call,
)

ATTENTION_KERNELS = ("prefill_attention_kernel", "attention_bwd_dkv_kernel",
                     "attention_bwd_dq_kernel")


def _sync_clock() -> float:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def split_step(step, params, opt, *inputs, module=transformer,
               loss_name="loss_fn"):
    """Host seconds of (forward and loss, backward, optimizer step) of one
    call ``step(params, opt, *inputs)``, the step that ``make_train_step``
    built (or, with ``module`` and ``loss_name``, another train step whose
    loss function is ``module.<loss_name>``: ``models.seq2seq``'s
    ``seq2seq_loss``), with a synchronize at each boundary.  The step
    itself is not copied: its loss function is wrapped (the end of the
    forward) and ``opt`` hooked (the end of the backward and of the
    update).  Returns the parts and the step's loss."""
    marks = []
    loss_fn = getattr(module, loss_name)

    def mark(*_):
        marks.append(_sync_clock())

    def marked_loss_fn(*args, **kwargs):
        loss = loss_fn(*args, **kwargs)
        mark()
        return loss

    hooks = (opt.register_step_pre_hook(mark),
             opt.register_step_post_hook(mark))
    try:
        with mock.patch.object(module, loss_name, marked_loss_fn):
            t0 = _sync_clock()
            loss = step(params, opt, *inputs)
    finally:
        for hook in hooks:
            hook.remove()
    t1, t2, t3 = marks
    return (t1 - t0, t2 - t1, t3 - t2), loss


def profile_attention(what, call, top) -> None:
    """Profile one call and print H1, H3-dkv and H3-dq's share of its
    kernel time."""
    prof = profile_call(what, call, top)
    dev_ms = prof["kernel_ms"]
    attn_ms = sum(e.self_device_time_total for e in prof["kernels"]
                  if any(n in e.key for n in ATTENTION_KERNELS)) / 1e3
    print(f"  H1 + H3-dkv + H3-dq: {attn_ms:.3f} ms, "
          f"{attn_ms / dev_ms:.4f} of the kernel time")


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
    profile_attention("train step", lambda: step(params, opt, tokens),
                      args.top)
    del params, opt

    params = init_params(cfg, seed=0, device=dev)
    mlm_tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (8, 1024)).astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, mask = mask_tokens(mlm_tokens, gen, cfg.vocab_size - 1)
    step, opt_init = make_mlm_train_step(cfg)
    opt = opt_init(params)
    run = lambda: step(params, opt, mlm_tokens, None, mask)  # noqa: E731
    for _ in range(3):
        run()
    total = []
    for _ in range(args.repeats):
        t0 = _sync_clock()
        run()
        total.append(_sync_clock() - t0)
    print(f"encoder step s {sorted(total)}")
    profile_attention("encoder step", run, args.top)
    del params, opt

    s2s_cfg = Seq2SeqConfig(base=cfg, n_enc_layers=2, n_dec_layers=2)
    params = init_seq2seq_params(s2s_cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    src, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                 .astype(np.int32)).to(dev)
                for shape in ((8, 1024), (8, 257)))
    step, opt_init = make_seq2seq_train_step(s2s_cfg)
    opt = opt_init(params)
    run = lambda: step(params, opt, src, tgt)  # noqa: E731
    for _ in range(3):
        run()
    total, parts = [], []
    for _ in range(args.repeats):
        t0 = _sync_clock()
        run()
        total.append(_sync_clock() - t0)
        parts.append(split_step(step, params, opt, src, tgt, module=seq2seq,
                                loss_name="seq2seq_loss")[0])
    print(f"seq2seq step s {sorted(total)}")
    for i, what in enumerate(("forward + loss", "backward", "optimizer")):
        print(f"  {what} s {sorted(p[i] for p in parts)}")
    profile_attention("seq2seq step", run, args.top)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
