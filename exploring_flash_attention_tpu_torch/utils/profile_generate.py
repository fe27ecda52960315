"""Where one ``GenerationEngine.generate`` call spends its time on the card.

Run from the repository root on a machine with one CUDA card:

    python -m exploring_flash_attention_tpu_torch.utils.profile_generate

It drives the flagship LM (``models.flagship_config``, random weights from
seed 0) on [8, 256] prompts for 24 new tokens, as ``chip_smoke.py`` does,
and prints:

- the host-clock time of ``generate`` and of its two halves (prefill:
  ``forward_collect_kv`` + the cache writes + the first sample; decode: the
  other 23 steps), over ``--repeats`` synchronized calls, sorted;
- one ``torch.profiler`` run of ``generate``: the wall time, the kernel
  time summed over the device rows of ``key_averages()`` (the CPU-op rows
  repeat their kernels' time, so they are left out), their ratio (the
  device busy share), the number of kernel launches, and the kernels that
  take the most device time.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    flagship_config,
    init_params,
)
from exploring_flash_attention_tpu_torch.models.generate import (
    _decode_forward,
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
def split_prefill_decode(eng: GenerationEngine, prompt: np.ndarray,
                         n_new: int):
    """Host seconds of (prefill, decode) of one greedy generation, run step
    by step as ``generate`` runs it."""
    slots = eng._map_slots(prompt.shape[0])
    tokens = torch.as_tensor(prompt, device=eng.device)
    state = {}

    def prefill():
        logits, kvs = forward_collect_kv(eng.params, tokens, eng.config)
        for cache, (k, v) in zip(eng.caches, kvs):
            append_prompts(cache, slots, k, v)
        state["tok"] = sample(logits[:, -1])

    def decode():
        tok = state["tok"]
        for _ in range(n_new - 1):
            tok = sample(_decode_forward(eng.params, tok, eng.caches, slots,
                                         eng.config))

    try:
        return _timed(prefill), _timed(decode)
    finally:
        eng._release_slots()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = flagship_config()
    bsz, l_prompt, n_new = 8, 256, 24
    params = init_params(cfg, seed=0, device=dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, l_prompt)).astype(np.int32)
    eng = GenerationEngine(params, cfg, max_seqs=bsz, max_len=1024)
    for _ in range(3):                                  # builds, warms up
        eng.generate(prompt, n_new)

    total, pre, dec = [], [], []
    for _ in range(args.repeats):
        total.append(_timed(lambda: eng.generate(prompt, n_new)))
        p, d = split_prefill_decode(eng, prompt, n_new)
        pre.append(p)
        dec.append(d)
    print(f"generate s {sorted(total)}")
    print(f"prefill s {sorted(pre)}")
    print(f"decode ({n_new - 1} steps) s {sorted(dec)}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _timed(lambda: eng.generate(prompt, n_new))
    kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"profiled wall {wall * 1e3:.3f} ms, summed kernel time "
          f"{dev_ms:.3f} ms, device busy share {dev_ms / (wall * 1e3):.4f}, "
          f"kernels launched {sum(e.count for e in kern)}")
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  n={e.count:5d}  "
              f"{e.key[:100]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
