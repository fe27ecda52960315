"""Where a generation call spends its time on the card: one
``GenerationEngine.generate`` (turn 1) and one ``continue_generation``
over the held cache (turn 2).

Run from the repository root on a machine with one CUDA card:

    python -m exploring_flash_attention_tpu_torch.utils.profile_generate

It drives the flagship LM (``models.flagship_config``, random weights from
seed 0) on [8, 256] prompts for 24 new tokens, then a second turn of 256
tokens (turn 1's last token and 255 new ones) for 24 more, as
``chip_smoke.py`` does; with ``--model windowed``, the windowed LM
(``models.long_context_config``, window 4096) on [8, 4608] prompts
(``max_len`` 5120), as ``chip_smoke.py``'s window_generate phase does.
The engine replays each decode step as a CUDA graph; beside it runs the
same call with the decode steps eager, a loop over ``_decode_forward``
(``eager_generate``).  For each turn it prints:

- the host-clock time of the call, graphed and eager, and of the eager
  call's two halves (the first forward: prefill, or the extend over the
  held cache, with the cache writes and the first sample; decode: the
  other 23 steps), over ``--repeats`` synchronized calls, sorted;
- one ``torch.profiler`` run of each call: the wall time, the kernel time
  summed over the device rows of ``key_averages()`` (the CPU-op and
  annotation rows repeat their kernels' time, so they are left out), their
  ratio (the device busy share), the number of kernel launches, the share
  of the kernel time that the paged attention takes (H6-decode, H2 and
  H6-extend), and the kernels that take the most device time; for
  ``generate``, also a call of one new token (prefill and the first
  sample only), so that the launches, kernel time and host time of one
  decode step, graphed and eager, are the difference over the other 23.

With ``--model speculative`` it drives ``SpeculativeEngine`` instead, at
``chip_smoke.py``'s speculative legs (the flagship target on the same
prompts, 24 new tokens, gamma 4; a 1-layer paged draft at the flagship's
widths from seed 7, then the target as its own draft): the host-clock
time of a call, its rounds graphed and eager, and one profiled graphed
call beside a call of one new token (the two prefills only), so that one
round's launches, kernel time, wall time and busy share are the
difference over the rounds.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    SpeculativeEngine,
    flagship_config,
    init_params,
    long_context_config,
)
from exploring_flash_attention_tpu_torch.models.generate import (
    _decode_forward,
    _extend_forward,
    forward_collect_kv,
    sample,
)
from exploring_flash_attention_tpu_torch.serving import append_prompts


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@torch.no_grad()
def split_first_decode(eng: GenerationEngine, first, slots: torch.Tensor,
                       n_new: int):
    """Host seconds of (``first()``, the logits of the call's first forward,
    and its sample; the other decode steps) of one greedy call, run step
    by step as the engine runs it."""
    state = {}

    def head():
        state["tok"] = sample(first())

    def decode():
        tok = state["tok"]
        for _ in range(n_new - 1):
            tok = sample(_decode_forward(eng.params, tok, eng.caches, slots,
                                         eng.config))

    return _timed(head), _timed(decode)


def _prefill(eng: GenerationEngine, prompt: np.ndarray,
             slots: torch.Tensor) -> torch.Tensor:
    """``generate``'s prefill on mapped slots: the last position's logits."""
    logits, kvs = forward_collect_kv(
        eng.params, torch.as_tensor(prompt, device=eng.device), eng.config)
    for cache, (k, v) in zip(eng.caches, kvs):
        append_prompts(cache, slots, k, v)
    return logits[:, -1]


@torch.no_grad()
def eager_generate(eng: GenerationEngine, prompt: np.ndarray,
                   n_new: int) -> np.ndarray:
    """Greedy ``eng.generate(prompt, n_new)`` with every decode step run
    eagerly, a loop over ``_decode_forward``: the reference the engine's
    replayed step graph is held to, bitwise."""
    slots = eng._map_slots(prompt.shape[0])
    try:
        out = [sample(_prefill(eng, prompt, slots))]
        for _ in range(n_new - 1):
            out.append(sample(_decode_forward(eng.params, out[-1],
                                              eng.caches, slots,
                                              eng.config)))
        return torch.stack(out, dim=1).cpu().numpy()
    finally:
        eng._release_slots()


def split_prefill_decode(eng: GenerationEngine, prompt: np.ndarray,
                         n_new: int):
    slots = eng._map_slots(prompt.shape[0])
    try:
        return split_first_decode(eng, lambda: _prefill(eng, prompt, slots),
                                  slots, n_new)
    finally:
        eng._release_slots()


def split_extend_decode(eng: GenerationEngine, prompt: np.ndarray,
                        turn: np.ndarray, n_new: int):
    eng.generate(prompt, n_new, hold=True)
    tokens = torch.as_tensor(turn, device=eng.device)

    def extend():
        return _extend_forward(eng.params, tokens, eng.caches,
                               eng._held_slots, eng.config)[:, -1]

    try:
        return split_first_decode(eng, extend, eng._held_slots, n_new)
    finally:
        eng.release()


# the kernel functions of the paged attention, by the names they print as
PAGED_KERNELS = {"paged_decode_kernel": "H6-decode",
                 "splitkv_combine_kernel": "H2",
                 "paged_extend_kernel": "H6-extend"}


def profile_call(name: str, call, top: int):
    """Profile one ``call()`` and print its wall time, summed kernel time,
    device busy share, launches and top kernels; return them (``wall_ms``,
    ``kernel_ms``, ``launches``) and the kernel rows (``kernels``).  Rows
    of user annotations
    (``Optimizer.step``, for one) span kernels that have rows of their
    own, so they are left out."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _timed(call)
    kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    paged = {tag: sum(e.self_device_time_total for e in kern
                      if tag in e.key) / 1e3
             for tag in PAGED_KERNELS}
    launches = sum(e.count for e in kern)
    print(f"{name}: profiled wall {wall * 1e3:.3f} ms, summed kernel time "
          f"{dev_ms:.3f} ms, device busy share {dev_ms / (wall * 1e3):.4f}, "
          f"kernels launched {launches}; paged attention "
          + ", ".join(f"{PAGED_KERNELS[t]} {ms:.3f} ms ({ms / dev_ms:.1%})"
                      for t, ms in paged.items()))
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  n={e.count:5d}  "
              f"{e.key[:100]}")
    return {"wall_ms": wall * 1e3, "kernel_ms": dev_ms, "launches": launches,
            "kernels": kern}


def profile_speculative(dev: torch.device, repeats: int, top: int) -> None:
    """The ``--model speculative`` run (see the module note)."""
    cfg = flagship_config()
    bsz, n_new, gamma = 8, 24, 4
    params = init_params(cfg, seed=0, device=dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, 256)).astype(np.int32)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    for name, dparams, draft_cfg in (
            ("1-layer paged draft", init_params(dcfg, seed=7, device=dev),
             dcfg),
            ("self draft", params, cfg)):
        eng = SpeculativeEngine(params, cfg, dparams, draft_cfg,
                                max_seqs=bsz, max_len=1024)
        run = lambda: eng.generate(prompt, n_new, gamma=gamma)  # noqa: E731
        for _ in range(3):                              # builds, captures
            _, stats = run()
        rounds = int(stats["rounds"])
        graphed = [_timed(run) for _ in range(repeats)]
        eng.graphed = False
        eager = [_timed(run) for _ in range(repeats)]
        eng.graphed = True
        print(f"speculative generate, {name}, gamma {gamma}, {rounds} rounds "
              f"(acceptance {stats['acceptance_rate']:.4f}): s, rounds "
              f"graphed {sorted(graphed)}; eager {sorted(eager)}")
        one = profile_call(f"{name}: 1 new token (the two prefills)",
                           lambda: eng.generate(prompt, 1, gamma=gamma), top)
        full = profile_call(f"{name}: {n_new} new tokens, rounds graphed",
                            run, top)
        per = {k: (full[k] - one[k]) / rounds
               for k in ("wall_ms", "kernel_ms", "launches")}
        print(f"one round, {name}: {per['launches']:.1f} launches, kernel "
              f"time {per['kernel_ms']:.4f} ms, profiled wall "
              f"{per['wall_ms']:.4f} ms, device busy share "
              f"{per['kernel_ms'] / per['wall_ms']:.4f}")
        del eng


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--model", choices=("flagship", "windowed",
                                        "speculative"), default="flagship")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    if args.model == "speculative":
        profile_speculative(dev, args.repeats, args.top)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip())
        return
    if args.model == "flagship":
        cfg, l_prompt, max_len = flagship_config(), 256, 1024
    else:
        cfg, l_prompt, max_len = long_context_config(), 4608, 5120
    bsz, l_turn, n_new = 8, 256, 24
    params = init_params(cfg, seed=0, device=dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, l_prompt)).astype(np.int32)
    eng = GenerationEngine(params, cfg, max_seqs=bsz, max_len=max_len)
    out1 = eng.generate(prompt, n_new, hold=True)
    turn = np.concatenate([out1[:, -1:], np.random.default_rng(1).integers(
        0, cfg.vocab_size, (bsz, l_turn - 1)).astype(np.int32)], axis=1)
    for _ in range(3):                                  # builds, warms up
        eng.continue_generation(turn, n_new)
        eng.release()
        eng.generate(prompt, n_new, hold=True)
    eng.release()

    def turn2():
        eng.generate(prompt, n_new, hold=True)
        try:
            return _timed(lambda: eng.continue_generation(turn, n_new))
        finally:
            eng.release()

    total, eager, pre, dec, total2, ext, dec2 = ([] for _ in range(7))
    for _ in range(args.repeats):
        total.append(_timed(lambda: eng.generate(prompt, n_new)))
        eager.append(_timed(lambda: eager_generate(eng, prompt, n_new)))
        p, d = split_prefill_decode(eng, prompt, n_new)
        pre.append(p)
        dec.append(d)
        total2.append(turn2())
        e, d = split_extend_decode(eng, prompt, turn, n_new)
        ext.append(e)
        dec2.append(d)
    print(f"generate s, decode steps graphed {sorted(total)}")
    print(f"generate s, decode steps eager {sorted(eager)}")
    print(f"  eager: prefill s {sorted(pre)}")
    print(f"  eager: decode ({n_new - 1} steps) s {sorted(dec)}")
    print(f"continue_generation s, decode steps graphed {sorted(total2)}")
    print(f"  eager: extend ({l_turn} tokens) s {sorted(ext)}")
    print(f"  eager: decode ({n_new - 1} steps) s {sorted(dec2)}")

    one = profile_call("generate, 1 new token (prefill and first sample)",
                       lambda: eng.generate(prompt, 1), args.top)
    runs = {"graphed": profile_call(
        "generate, decode steps graphed",
        lambda: eng.generate(prompt, n_new), args.top),
        "eager": profile_call(
        "generate, decode steps eager",
        lambda: eager_generate(eng, prompt, n_new), args.top)}
    for mode, r in runs.items():
        per = {k: (r[k] - one[k]) / (n_new - 1)
               for k in ("wall_ms", "kernel_ms", "launches")}
        print(f"one decode step, {mode}: {per['launches']:.1f} launches, "
              f"kernel time {per['kernel_ms']:.4f} ms, profiled wall "
              f"{per['wall_ms']:.4f} ms, device busy share "
              f"{per['kernel_ms'] / per['wall_ms']:.4f}")
    eng.generate(prompt, n_new, hold=True)
    profile_call("continue_generation, decode steps graphed",
                 lambda: eng.continue_generation(turn, n_new), args.top)
    eng.release()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
