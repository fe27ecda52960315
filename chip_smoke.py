#!/usr/bin/env python3
"""Drive the PyTorch port's generation path once on one NVIDIA H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:

1. device: a CUDA card of compute capability 9.0, with its name and power
   limit from nvidia-smi;
2. build:  nvcc builds the kernels of exploring_flash_attention_tpu_torch/
   csrc/ and its -Xptxas -v report (registers, shared memory) is printed;
3. h1:     kernel H1 (causal prefill attention) vs its plain PyTorch
   version and the f64 oracle, at the slice's shapes and one ragged case;
4. decode: kernel H6-decode (paged INT8 decode) vs its plain version and
   the f64 oracle over the dequantized cache, at ragged contexts 257..280;
5. slice:  the full-width flagship LM (vocab 32768, 4 layers, d_model 1024,
   GQA 8/4, d_head 128, d_ff 4096, bf16, random weights from seed 0) runs
   GenerationEngine.generate on [8, 256] prompts for 24 tokens.  Every
   kernel's launch counter is zeroed just before and read just after: H1
   must launch n_layers = 4 times, H6-decode 4 * 23 = 92.  Each generated
   token is checked against a fresh full forward over the sequence so far
   (agreement, or a near-tie under LOGIT_GAP).  Tokens/s come from the
   host clock around a second, synchronized call; kernel times from CUDA
   events (L2 flushed before each call) beside their plain versions.

Every check also runs a control: the same comparison against a known-wrong
path that hides one key from each row.  The control must read beyond the
check's limit, so each limit is shown to tell a wrong mask from a right one.

Then a JSON line describing the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances (bf16 inputs, f32 accumulation).  Each lies between what a
# sound kernel reads and what a known-wrong path reads (one key hidden from
# every row, printed as "control" beside each check, which must exceed it):
H1_O_TOL = 2e-2        # P and O rounded to bf16; one ulp at |x|~2 is 7.8e-3
H1_LSE_TOL = 4e-3      # l sums bf16-rounded P: ln(l) within ~2^-9
DECODE_O_TOL = 5e-3    # P*v_scale and O rounded to bf16; sound runs 1.4e-3
LOGIT_GAP = 0.0625     # decode vs full forward: a flip must be a near-tie,
                       # 4 bf16 ulps of a logit in [2, 4); sound runs 0.0312

H1_SRC = "exploring_flash_attention_tpu_torch/csrc/prefill_attention.cu"
H6_SRC = "exploring_flash_attention_tpu_torch/csrc/paged_decode.cu"


class PhaseError(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def phase_device(torch):
    _require(torch.cuda.is_available(), "no CUDA device is visible")
    _require(torch.cuda.device_count() >= 1, "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    _require(cap == (9, 0), f"compute capability {cap}, need (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase device: ok {smi}, capability {cap}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi


def phase_build(kernels):
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    dt = time.perf_counter() - t0
    report = [ln.strip() for ln in kernels.ptxas_report().splitlines()
              if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    for ln in report:
        print(f"  ptxas: {ln}")
    print(f"phase build: ok {lib.relative_to(ROOT)} in {dt:.1f} s")


def _bf16(torch, dev, gen, *shape):
    return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)


def phase_h1(torch, dev):
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops.attention import (
        causal_attention_plain,
        prefill_attention,
    )

    gen = torch.Generator().manual_seed(0)
    main_err = None             # vs plain, at the main path's shape
    for b, hq, hkv, lq, lkv, d in [(8, 8, 4, 256, 256, 128),
                                   (8, 8, 4, 200, 216, 128)]:
        q = _bf16(torch, dev, gen, b, hq, lq, d)
        k = _bf16(torch, dev, gen, b, hkv, lkv, d)
        v = _bf16(torch, dev, gen, b, hkv, lkv, d)
        scale = 1.0 / math.sqrt(d)
        o, lse = prefill_attention(q, k, v, scale, lkv - lq)
        torch.cuda.synchronize()
        o_ref, lse_ref = causal_attention_plain(q, k, v, scale, lkv - lq)
        e_o = (o.float() - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        g = hq // hkv
        oracle = naive_attention(q, k.repeat_interleave(g, 1),
                                 v.repeat_interleave(g, 1), causal=True)
        e_or = float(np.abs(o.float().cpu().numpy() - oracle).max())
        # control: the plain version with each row's diagonal key hidden
        o_bad, _ = causal_attention_plain(q, k, v, scale, lkv - lq - 1)
        e_bad = (o.float() - o_bad).abs().max().item()
        print(f"  h1 B={b} Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} d={d}: "
              f"max|dO| vs plain {e_o:.3e} (tol {H1_O_TOL:g}), "
              f"max|dLSE| {e_lse:.3e} (tol {H1_LSE_TOL:g}), "
              f"max|dO| vs f64 oracle {e_or:.3e} (tol {H1_O_TOL:g}), "
              f"control (diagonal key hidden) {e_bad:.3e}")
        _require(torch.isfinite(o.float()).all().item(), "H1 O not finite")
        _require(e_o < H1_O_TOL and e_lse < H1_LSE_TOL and e_or < H1_O_TOL,
                 "H1 outside tolerance")
        _require(e_bad > H1_O_TOL, "H1 tolerance cannot tell a wrong mask")
        if main_err is None:
            main_err = e_o
    print("phase h1: ok")
    return main_err


def make_decode_case(torch, dev, b=8, hq=8, hkv=4, d=128, ps=128,
                     max_len=1024, seed=1):
    """A cache like the engine's (max_len 1024 -> 8 pages per slot) filled
    through append_prompts with ragged contexts 257..280, and one bf16 q."""
    from exploring_flash_attention_tpu_torch.configs import cdiv
    from exploring_flash_attention_tpu_torch.serving import (
        append_prompts,
        make_cache,
    )

    gen = torch.Generator().manual_seed(seed)
    pages_per_seq = cdiv(max_len, ps)
    cache = make_cache(hkv, d, b * pages_per_seq, page_size=ps, max_seqs=b,
                       max_pages_per_seq=pages_per_seq, device=dev)
    perm = torch.randperm(b * pages_per_seq, generator=gen)
    cache.page_table.copy_(perm.view(b, pages_per_seq).to(torch.int32))
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    lens = np.linspace(257, 280, b).round().astype(int)
    for s, n in enumerate(lens):
        kp = torch.randn(1, int(n), hkv, d, generator=gen).to(dev)
        vp = torch.randn(1, int(n), hkv, d, generator=gen).to(dev)
        append_prompts(cache, slots[s:s + 1], kp, vp)
    q = _bf16(torch, dev, gen, b, hq, d)
    return cache, q, slots, lens


@contextlib.contextmanager
def newest_token_hidden(cache, slots):
    """A known-wrong decode: each sequence's newest cached token is hidden
    (an off-by-one length), for the controls of the decode checks."""
    idx = slots.long()
    cache.seq_lens[idx] -= 1
    try:
        yield
    finally:
        cache.seq_lens[idx] += 1


def phase_decode(torch, dev):
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.serving import (
        gather_kv,
        paged_decode_attention,
        paged_decode_plain,
    )

    cache, q, slots, lens = make_decode_case(torch, dev)
    b, hq, d = q.shape
    hkv = cache.num_kv_heads
    o = paged_decode_attention(q, cache, slots)
    torch.cuda.synchronize()
    ref = paged_decode_plain(q, cache, slots, 1.0 / math.sqrt(d))
    e_o = (o.float() - ref).abs().max().item()
    e_or = 0.0
    for s in range(b):
        kf, vf = gather_kv(cache, s)
        oracle = naive_attention(q[s].view(hkv, hq // hkv, d), kf, vf)
        got = o[s].float().view(hkv, hq // hkv, d).cpu().numpy()
        e_or = max(e_or, float(np.abs(got - oracle).max()))
    with newest_token_hidden(cache, slots):         # control
        bad = paged_decode_plain(q, cache, slots, 1.0 / math.sqrt(d))
    e_bad = (o.float() - bad).abs().max().item()
    print(f"  decode B={b} Hq={hq} Hkv={hkv} d={d} ps={cache.page_size} "
          f"ctx {lens.min()}..{lens.max()}: max|dO| vs plain {e_o:.3e} "
          f"(tol {DECODE_O_TOL:g}), vs f64 oracle on the dequantized cache "
          f"{e_or:.3e} (tol {DECODE_O_TOL:g}), control (newest token "
          f"hidden) {e_bad:.3e}")
    _require(torch.isfinite(o.float()).all().item(), "H6 O not finite")
    _require(e_o < DECODE_O_TOL and e_or < DECODE_O_TOL,
             "H6-decode outside tolerance")
    _require(e_bad > DECODE_O_TOL,
             "H6-decode tolerance cannot tell a wrong mask")
    print("phase decode: ok")
    return e_o


def compare_with_full_forward(torch, params, cfg, prompt, out):
    """Greedy replay: at every step, the decode path's token against the
    full forward's argmax over the sequence so far.  Returns (agreements,
    steps, largest logit gap of a disagreement)."""
    from exploring_flash_attention_tpu_torch.models import forward

    dev = params["embed"].device
    seq = prompt
    agree, worst_gap = 0, 0.0
    for t in range(out.shape[1]):
        logits = forward(params, torch.from_numpy(seq).to(dev), cfg)
        last = logits[:, -1].cpu().numpy()
        _require(np.isfinite(last).all(), "full-forward logits not finite")
        nxt = last.argmax(-1)
        for b in range(out.shape[0]):
            if nxt[b] == out[b, t]:
                agree += 1
            else:
                worst_gap = max(worst_gap, float(
                    abs(last[b, nxt[b]] - last[b, out[b, t]])))
        seq = np.concatenate([seq, out[:, t:t + 1]], axis=1)
    return agree, out.size, worst_gap


def phase_slice(torch, dev):
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        GenerationEngine,
        flagship_config,
        init_params,
    )
    from exploring_flash_attention_tpu_torch.models import (
        generate as generate_module,
    )
    from exploring_flash_attention_tpu_torch.ops.attention import (
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
    )

    cfg = flagship_config()
    bsz, l_prompt, n_new = 8, 256, 24
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, l_prompt)).astype(np.int32)
    eng = GenerationEngine(params, cfg, max_seqs=bsz, max_len=1024)

    prefill_attention.launches = 0
    paged_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompt, max_new_tokens=n_new)
    t_first = time.perf_counter() - t0
    launches = {"h1": prefill_attention.launches,
                "h6": paged_decode_attention.launches}
    want = {"h1": cfg.n_layers, "h6": cfg.n_layers * (n_new - 1)}
    print(f"  slice launches {launches} (expected {want})")
    _require(launches == want, "the main path missed a kernel")
    _require(out.shape == (bsz, n_new) and out.dtype == np.int32
             and (out >= 0).all() and (out < cfg.vocab_size).all(),
             f"bad tokens {out.shape} {out.dtype}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2 = eng.generate(prompt, max_new_tokens=n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tok_s = bsz * n_new / dt

    agree, steps, worst_gap = compare_with_full_forward(
        torch, params, cfg, prompt, out)

    # control: the same engine with every decode step's newest token hidden
    def hide_newest(q, cache, slots):
        with newest_token_hidden(cache, slots):
            return paged_decode_attention(q, cache, slots)

    with mock.patch.object(generate_module, "paged_decode_attention",
                           hide_newest):
        bad = eng.generate(prompt, max_new_tokens=n_new)
    bad_agree, _, bad_gap = compare_with_full_forward(
        torch, params, cfg, prompt, bad)
    print(f"  slice init {t_init:.2f} s, first generate {t_first:.3f} s, "
          f"second {dt:.4f} s: {tok_s:.1f} tokens/s "
          f"(B={bsz}, prompt {l_prompt}, {n_new} new, incl. prefill); "
          f"repeat identical: {bool(np.array_equal(out, out2))}; "
          f"full-forward agreement {agree}/{steps}, largest gap of a "
          f"disagreement {worst_gap:.4f} (limit {LOGIT_GAP}); control "
          f"(newest token hidden) {bad_agree}/{steps}, largest gap "
          f"{bad_gap:.4f}")
    _require(worst_gap < LOGIT_GAP,
             "a decode token differs from the full forward's beyond a tie")
    _require(bad_gap >= LOGIT_GAP,
             "the full-forward check cannot tell a wrong decode path")
    print("phase slice: ok")
    return launches, tok_s


def time_kernels(torch, dev):
    from exploring_flash_attention_tpu_torch.ops.attention import (
        causal_attention_plain,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
        paged_decode_plain,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    gen = torch.Generator().manual_seed(2)
    q = _bf16(torch, dev, gen, 8, 8, 256, 128)
    k = _bf16(torch, dev, gen, 8, 4, 256, 128)
    v = _bf16(torch, dev, gen, 8, 4, 256, 128)
    s = 1.0 / math.sqrt(128)
    h1 = (time_cuda(lambda: prefill_attention(q, k, v, s, 0)),
          time_cuda(lambda: causal_attention_plain(q, k, v, s, 0)))
    cache, qd, slots, _ = make_decode_case(torch, dev)
    h6 = (time_cuda(lambda: paged_decode_attention(qd, cache, slots)),
          time_cuda(lambda: paged_decode_plain(qd, cache, slots, s)))
    print(f"  times (CUDA events, median of 50 calls, L2 flushed before "
          f"each): "
          f"H1 {h1[0]:.4f} ms vs plain {h1[1]:.4f} ms at B=8 Hq=8 Hkv=4 "
          f"L=256 d=128; H6-decode {h6[0]:.4f} ms vs plain {h6[1]:.4f} ms "
          f"at B=8 Hq=8 Hkv=4 ctx 257..280 d=128")
    return h1, h6


def main() -> int:
    import torch

    smi = phase_device(torch)
    sys.path.insert(0, str(ROOT))
    try:
        import exploring_flash_attention_tpu_torch as port
    except ImportError as exc:
        raise PhaseError(f"the port is not beside chip_smoke.py: {exc}")
    _require(Path(port.__file__).resolve().parent.parent == ROOT,
             f"the port was imported from {port.__file__}, not from {ROOT}")
    from exploring_flash_attention_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase_build(kernels)
    h1_err = phase_h1(torch, dev)
    h6_err = phase_decode(torch, dev)
    launches, _ = phase_slice(torch, dev)
    h1_ms, h6_ms = time_kernels(torch, dev)
    _require("jax" not in sys.modules, "JAX was imported")
    print(json.dumps({"kernels": [
        {"name": "H1 causal prefill attention", "route": "cuda",
         "source": H1_SRC,
         "replaces": "exploring_flash_attention_tpu/ops/attention_v1.py:489",
         "also_replaces":
             "exploring_flash_attention_tpu/ops/attention_v2_splitkv.py:51",
         "launches": launches["h1"], "max_abs_err": h1_err,
         "ms": h1_ms[0], "plain_ms": h1_ms[1]},
        {"name": "H6-decode paged INT8 decode attention", "route": "cuda",
         "source": H6_SRC,
         "replaces": "exploring_flash_attention_tpu/serving/decode.py:74",
         "launches": launches["h6"], "max_abs_err": h6_err,
         "ms": h6_ms[0], "plain_ms": h6_ms[1]},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                       # report the failure, exit non-zero
        traceback.print_exc()
        print("chip_smoke FAILED", file=sys.stderr)
        sys.exit(1)
