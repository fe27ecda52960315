#!/usr/bin/env python3
"""Drive the PyTorch port's dense, quantized and d-tiled forwards, generation,
training and encoder training paths on one NVIDIA H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:

1. device: a CUDA card of compute capability 9.0, with its name and power
   limit from nvidia-smi;
2. build:  nvcc builds the kernels of exploring_flash_attention_tpu_torch/
   csrc/ and its -Xptxas -v report (registers, shared memory) is printed;
   the SASS of the kernel functions of H1, H3, H4-int8, H4-kvq and H5
   (cuobjdump) must hold wgmma instructions: HGMMA in every H1, H3-dkv,
   H3-dq, H4-kvq and H5 function and in H4-int8's pv_mode bf16 ones,
   IGMMA in every H4-int8 function, and no HMMA or IMMA (the mma.sync and
   WMMA forms they replaced);
3. h1:     kernel H1 (the attention forward) vs its plain PyTorch
   version and the f64 oracle, causal, at the slice's shapes and one
   ragged case;
4. v1:     flash_attention_v1, the dense forward, on H1 at bench.py's
   canonical shape (B=32, H=8, L=1024, d=128, bf16, non-causal; inputs
   from np.random.default_rng(1) as bench.py makes them): the main call,
   with every counter zeroed before and read after (H1 1), passes
   bench.py's gate (f32 O of [:2, :2] vs the f64 oracle, max|dO| <= 1e-3)
   and matches the plain version over the whole tensor; then one case per
   JAX route (d=32, GQA ragged cross, a ragged KV of 8200, causal cross,
   window 512 at L=4096 and its LSE partial, each one H1 launch; a KV of
   8192 over 16 Q tiles
   per head, one H1 launch over KV spans and one launch of H2, the
   split-KV combine), against the plain version and the oracle.  H1, the
   plain version and scaled_dot_product_attention are timed at the
   canonical shape, the window call must take under half the causal
   call's time, and the split case is timed at several span counts;
5. quant:  flash_attention_kvquant (kernel H4-kvq, int8 or e4m3 K/V) and
   flash_attention_int8 (kernel H4-int8, int8 Q/K/V, pv_mode bf16 and
   int8) at the JAX suite's shapes (bench/suite.py:363, :395, :1173):
   the suite's gates at its gate inputs, then one launch per call at the
   canonical shape, a KV of 8192 and a ragged KV (kvquant), at L=4096
   and the JAX test's ragged case (int8), each against the plain version
   and the f64 oracle over the dequantized tensors, with the neighbouring
   block's scales as a further control; times beside
   scaled_dot_product_attention over the dequantized bf16 tensors, and
   the int8 calls also with the per-call quantize_int8 of Q;
6. dtiled: flash_attention_v1_dtiled (kernel H5) at d=512, B=4, H=8,
   L=1024 with bf16, e4m3 and int8 K/V (bench/suite.py:279, :309) and a
   ragged d=256 case, the suite's gate first; the last d-chunk left out
   of S is a further control;
7. decode: kernel H6-decode (paged INT8 decode) vs its plain version and
   the f64 oracle over the dequantized cache, at ragged contexts 257..280;
8. extend: kernel H6-extend (chunked prefill over the paged INT8 cache) vs
   its plain version and the f64 oracle, a C = 256 chunk appended to
   ragged histories 257..280;
9. bwd:    kernels H3-dkv and H3-dq (the attention backward, through
   flash_attention_bwd) vs attention_bwd_plain and f64 autograd of the
   plain forward, at the training shape (B=8, Hq=8, Hkv=4, L=1024,
   d=128), a ragged cross case (Lq=200, Lkv=216) and L=3072, B=1 (where
   the JAX package takes B12/B13), each under no mask, causal and a
   window of 100 keys; the controls: the last 64-key tile dropped, the
   diagonal key hidden, the window one key narrower; two runs must be
   bitwise equal;
10. slice:  the full-width flagship LM (vocab 32768, 4 layers, d_model 1024,
   GQA 8/4, d_head 128, d_ff 4096, bf16, random weights from seed 0) runs
   GenerationEngine.generate on [8, 256] prompts for 24 tokens.  Every
   kernel's launch counter is zeroed just before and read just after: H1
   must launch n_layers = 4 times, H6-decode 4 * 23 = 92.  Each generated
   token is checked against a fresh full forward over the sequence so far
   (agreement, or a near-tie under LOGIT_GAP).  Tokens/s come from the
   host clock around a second, synchronized call;
11. multiturn: the same model holds its slots (generate(hold=True)), then
   continue_generation feeds a second turn of 256 tokens (turn 1's last
   token and 255 new ones, chunk at positions 279..534) and decodes 24
   more.  Counters: turn 1 H1 4, H6-decode 92; turn 2 H6-extend 4,
   H6-decode 92, H1 0.  Each turn-2 token is checked against the full
   forward over the whole stream so far, and every layer's cache against
   forward_collect_kv over the concatenated stream; release() must return
   every page;
12. train:  the same model, trainable (fresh weights from seed 0), takes
   make_train_step's AdamW steps (lr 1e-3) on tokens [8, 1025] from
   np.random.default_rng(0).  Every step must launch H1, H3-dkv and H3-dq
   n_layers = 4 times each.  Before the steps, the step-0 loss and every
   parameter's gradient are held against the same model with the plain
   attention patched in (mock.patch), with the diagonal key hidden in the
   forward (loss) and in the backward (gradients) as controls; the loss
   must fall strictly over 5 steps, and tokens/s and TFLOP/s come from the
   host clock around further synchronized steps;
13. encoder: the JAX suite's encoder entry (bench/suite.py:1057-1102):
   the same geometry, fresh weights from seed 0, trained bidirectionally
   by make_mlm_train_step (AdamW, lr 1e-3) on tokens [8, 1024] under one
   fixed MLM mask.  Every step must launch H1, H3-dkv and H3-dq n_layers
   = 4 times each, all without a mask.  The step-0 loss and every
   gradient are held against the plain attention patched in, with a
   causal forward (loss) and a causal backward (gradients) as controls;
   the loss must fall over 5 steps; encoder training tokens/s come from
   the host clock around further steps.

Kernel times come from CUDA events (L2 flushed before each call) beside
their plain versions, their bounds on the H100 (the larger of the
operations at 989 TFLOP/s bf16 and 1,979 TOP/s int8, 67 TFLOP/s for H2's
f32 work, and the bytes at 3.35 TB/s) and, where one PyTorch call
computes the same function, that call's time (scaled_dot_product_attention
for H1 and H5, causal or with a band mask where H1's mask is, its
autograd backward under the same mask for H3, which is timed causal and
without a mask, each kernel alone and the delta reduction apart).
Every check also runs a control: the same comparison against a
known-wrong path (one key hidden from each row, the scale off by 10%, the
last 64-key tile dropped, or a stream one token short).  The control must read beyond the check's
limit, so each limit is shown to tell a wrong path from a right one.

Then a JSON line describing the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances (bf16 inputs, f32 accumulation).  Each lies between what a
# sound kernel reads and what a known-wrong path reads (one key hidden from
# every row, printed as "control" beside each check, which must exceed it):
H1_O_TOL = 2e-2        # P and O rounded to bf16; one ulp at |x|~2 is 7.8e-3
H1_LSE_TOL = 4e-3      # l sums bf16-rounded P: ln(l) within ~2^-9
DECODE_O_TOL = 5e-3    # P*v_scale and O rounded to bf16; sound runs 1.4e-3
EXTEND_O_TOL = 5e-3    # as DECODE_O_TOL: P*v_scale and O rounded to bf16;
                       # sound runs 2.7e-3, its control 0.25
LOGIT_GAP = 0.0625     # decode vs full forward: a flip must be a near-tie,
                       # 4 bf16 ulps of a logit in [2, 4); sound runs 0.0312
CACHE_KV_TOL = 0.2     # cache after turn 2 vs forward_collect_kv: the int8
                       # step (|k| <= ~5: 5/254 = 0.02) plus bf16 rounding
                       # of K/V that two paths computed (ulp 0.03 at |k| ~ 4);
                       # sound runs 0.106, the one-token-short control 7.6

H3_REL_TOL = 2e-2      # per gradient, max|d| / max|ref|: P and dS rounded to
                       # bf16 before their products, the gradients to bf16;
                       # sound runs 3.4e-3..5.7e-3 (a CPU emulation of those
                       # roundings 3e-3..7e-3), the diagonal-hidden control
                       # 0.36..1.03
TRAIN_LOSS_TOL = 7e-5  # step-0 loss (10.6) vs the plain attention: a mean
                       # over 8,192 tokens of near-uniform predictions
                       # (random weights), moved only where H1's bf16 O
                       # differs by an ulp; sound runs 2.4e-5, the
                       # diagonal-hidden forward 1.8e-4
ENCODER_LOSS_TOL = 1e-3  # the encoder's step-0 MLM loss vs the plain
                       # attention, a mean over the ~1,270 masked tokens
                       # only: sound runs 1.4e-4, the causal forward 1.1e-2
GRAD_REL_TOL = 6e-2    # largest per-leaf ||dg|| / ||g_plain|| over the 38
                       # leaves: bf16 gradients through 4 layers; sound runs
                       # 2.4e-2, the diagonal-hidden backward 0.15

V1_GATE_TOL = 1e-3     # bench.py's gate (bench.py:66-82): f32 O of [:2, :2]
                       # at the canonical shape vs the f64 oracle on the
                       # bf16-rounded inputs
V1_O_TOL = 2e-3        # f32 O in the further v1 checks, vs the plain
                       # version and the oracle: P rounded to bf16 before
                       # P V; sound runs 1.6e-4..5.7e-4, the controls (scale
                       # off by 10%, last 64-key tile dropped) 2.7e-2 and up
V1_WINDOW_O_TOL = 1e-2  # the window cases: rows that see a handful of keys
                       # have |O| up to ~3 and move by up to ~2^-9 of
                       # |v0 - v1|; sound runs 4.3e-3, the controls 0.1 and
                       # up.  A CPU emulation of H1's roundings reads within
                       # half of each limit, both controls beyond 5x
                       # (tests/test_torch_attention_v1.py)
H2_O_TOL = 1e-5        # H2 vs its plain version on the same f32 partials:
                       # both merge in f32 and differ in summation order

# The quant and dtiled phases hold f32 O against the plain version (the
# whole tensor) and the f64 oracle over the dequantized tensors (a slice),
# each within its own limit; every known-wrong control must read beyond
# both.  The suite's gates (bench/suite.py) at its gate inputs come first.
# CPU emulations of each kernel's roundings on inputs made the same way
# read within half of each limit (tests/test_torch_quant.py,
# tests/test_torch_dtiled.py).
KVQ_GATE_TOL = 1e-3    # bench/suite.py:383
KVQ_O_TOL = 5e-4       # H4-kvq rounds P * v_scale / vmax to fp16 (vmax
                       # per 128-key tile): the emulation reads <= 8.1e-5,
                       # the controls 1.8e-2 and up
INT8_GATE_TOL = 1.5e-3  # bench/suite.py:420, :1200 (pv_mode bf16)
INT8_PV8_TOL = 3e-2    # pv_mode int8 vs the oracle, the JAX test's tier
                       # (tests/test_attention_int8.py:53); B18's own
                       # requantized P reads 2.7e-2 at the gate inputs
INT8_RAGGED_TOL = 1e-2  # tests/test_attention_int8.py:62, its ragged case
INT8_PLAIN_TOL = 1e-3  # H4-int8 vs the plain version, which computes B18's
                       # function: summation order and a rare P flip differ
DTILED_GATE_TOL = 2e-3  # bench/suite.py:299, :334
DTILED_O_TOL = 4e-3    # H5 vs the plain version over the whole tensor (32
                       # heads) and the oracle slice: p * v_scale rounded to
                       # bf16, as B19 does; the emulation reads <= 9.5e-4 on
                       # one or two heads, an H100 1.32e-3 over 32 (fp8),
                       # the controls 0.12 and up

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, SXM data sheet
H100_INT8_OPS = 1979e12       # dense int8 tensor-core peak, same source
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores, same
H100_HBM_BYTES_S = 3.35e12    # HBM3 rate, same source

H1_SRC = "exploring_flash_attention_tpu_torch/csrc/prefill_attention.cu"
H2_SRC = "exploring_flash_attention_tpu_torch/csrc/splitkv_combine.cu"
H6_SRC = "exploring_flash_attention_tpu_torch/csrc/paged_decode.cu"
H6E_SRC = "exploring_flash_attention_tpu_torch/csrc/paged_extend.cu"
H3_SRC = "exploring_flash_attention_tpu_torch/csrc/attention_bwd.cu"
H4KVQ_SRC = "exploring_flash_attention_tpu_torch/csrc/kvquant_attention.cu"
H4INT8_SRC = "exploring_flash_attention_tpu_torch/csrc/int8_attention.cu"
H5_SRC = "exploring_flash_attention_tpu_torch/csrc/dtiled_attention.cu"
KVQ_PY = "exploring_flash_attention_tpu/ops/attention_kvquant.py"
INT8_PY = "exploring_flash_attention_tpu/ops/attention_int8.py"
DTILED_PY = "exploring_flash_attention_tpu/ops/attention_v1_dtiled.py"
BWD_PY = "exploring_flash_attention_tpu/ops/attention_bwd.py"
V1_PY = "exploring_flash_attention_tpu/ops/attention_v1.py"
SPLITKV_PY = "exploring_flash_attention_tpu/ops/attention_v2_splitkv.py"

# (B, Hq, Hkv, Lq, Lkv, d) of the bwd phase: the training shape first (its
# error goes into the kernels line), a ragged cross case, and a length
# where the JAX package takes B12/B13
BWD_SHAPES = [(8, 8, 4, 1024, 1024, 128), (8, 8, 4, 200, 216, 128),
              (1, 8, 4, 3072, 3072, 128)]
# the masks H3 takes, as (causal, window): the bwd phase runs every shape
# under each; the window crosses the 64-key tiles and is narrower than
# every shape's Lkv
BWD_MASKS = {"none": (False, None), "causal": (True, None),
             "window": (True, 100)}

# the v1 phase: bench.py's canonical shape (bench.py:33), then one case per
# JAX route that flash_attention_v1 takes; (route, B, Hq, Hkv, Lq, Lkv, d,
# causal, window, heads refereed by the f64 oracle)
V1_CANON = (32, 8, 1024, 128)
V1_WINDOW = 512
V1_SPLIT_ROUTE = "long-KV split-KV route (B8 spans, B9, B10: H1 spans + H2)"
V1_CASES = [
    ("B6/B7 d=32 at the reference shape", 32, 8, 8, 1024, 1024, 32, False,
     None, 2),
    ("B2 GQA, ragged and cross", 8, 8, 2, 1000, 1100, 128, False, None, 2),
    ("B3 streaming, a KV no one-pass span tiles", 2, 8, 8, 1024, 8200, 128,
     False, None, 1),
    ("B4 causal, cross, GQA", 8, 8, 4, 512, 1024, 128, True, None, 2),
    ("B5 sliding window", 4, 8, 4, 4096, 4096, 128, True, V1_WINDOW, 1),
    (V1_SPLIT_ROUTE, 1, 8, 8, 1024, 8192, 128, False, None, 1),
]
SPLIT_SWEEP = (1, 2, 4, 8, 16)      # KV spans timed at the long-KV case

# the quant phase (bench/suite.py:363, :395, :1173): (case, B, H, Lq, Lkv,
# d, kind, block, seed, heads refereed by the f64 oracle)
KVQ_CASES = [
    ("canonical int8", 32, 8, 1024, 1024, 128, "int8", 512, 1, 2),
    ("canonical fp8", 32, 8, 1024, 1024, 128, "fp8", 512, 1, 2),
    ("B16's route (JAX streams)", 2, 8, 1024, 8192, 128, "int8", 128, 2, 1),
    ("ragged KV", 2, 8, 1024, 1100, 128, "fp8", 128, 3, 2),
]
# (case, B, H, Lq, Lkv, d, block, pv_modes, seed, heads, oracle limits)
INT8_CASES = [
    ("canonical", 32, 8, 1024, 1024, 128, 512, ("bf16", "int8"), 1, 2,
     {"bf16": INT8_GATE_TOL, "int8": INT8_PV8_TOL}),
    # kv blocks shorter than a 128-key tile: one run per block, each
    # issuing the tile's every P V step
    ("canonical, kv block 64", 32, 8, 1024, 1024, 128, 64, ("bf16", "int8"),
     1, 2, {"bf16": INT8_GATE_TOL, "int8": INT8_PV8_TOL}),
    ("canonical, kv block 16", 32, 8, 1024, 1024, 128, 16, ("bf16", "int8"),
     1, 2, {"bf16": INT8_GATE_TOL, "int8": INT8_PV8_TOL}),
    ("L=4096", 8, 8, 4096, 4096, 128, 512, ("bf16",), 4, 1,
     {"bf16": INT8_GATE_TOL}),
    ("ragged KV (tests/test_attention_int8.py:56)", 1, 1, 128, 200, 64, 128,
     ("bf16", "int8"), 0, 1, {"bf16": INT8_RAGGED_TOL, "int8": INT8_PV8_TOL}),
]
# the dtiled phase (bench/suite.py:279, :309): (case, B, H, Lq, Lkv, d,
# kind, block, seed, heads refereed by the f64 oracle)
DTILED_CASES = [
    ("d=512 bf16", 4, 8, 1024, 1024, 512, "bf16", None, 1, 2),
    ("d=512 fp8", 4, 8, 1024, 1024, 512, "fp8", 512, 1, 2),
    ("d=512 int8", 4, 8, 1024, 1024, 512, "int8", 512, 1, 2),
    ("d=256 ragged bf16", 2, 8, 1000, 1100, 256, "bf16", None, 5, 2),
]

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
    # registers, spills, and the notes where ptxas serializes wgmma
    # (C7510-C7520, "Potential Performance Loss")
    report = [ln.strip() for ln in kernels.ptxas_report().splitlines()
              if "Compiling entry" in ln or "Used" in ln or "spill" in ln
              or "(C75" in ln]
    for ln in report:
        print(f"  ptxas: {ln}")
    print(f"phase build: ok {lib.relative_to(ROOT)} in {dt:.1f} s")
    check_sass(kernels)


# the wgmma kernels' functions in the SASS: H1 (d 32, 64, 128), H4-int8
# (d 64, 128 x pv_mode), H4-kvq (d 64, 128 x int8, e4m3), H5 (d 128,
# 256, 384, 512 x bf16, int8, e4m3), H3-dkv and H3-dq (d 64, 128)
WGMMA_FUNCTIONS = {"prefill_attention_kernel": 3, "int8_attention_kernel": 4,
                   "kvquant_attention_kernel": 4,
                   "dtiled_attention_kernel": 12,
                   "attention_bwd_dkv_kernel": 2,
                   "attention_bwd_dq_kernel": 2}


def check_sass(kernels):
    """H1, H3, H4-int8, H4-kvq and H5 run on wgmma: HGMMA in every H1, H3,
    H4-kvq and H5 function and in the pv_mode bf16 H4-int8 ones (template
    argument false, ``Lb0E``), IGMMA in every H4-int8 function, no HMMA or
    IMMA in any of them."""
    sass = kernels.sass_by_function()
    found = dict.fromkeys(WGMMA_FUNCTIONS, 0)
    for name, text in sass.items():
        kind = next((k for k in found if k in name), None)
        if kind is None:
            continue
        found[kind] += 1
        counts = {op: len(re.findall(rf"\b{op}\b", text))
                  for op in ("HGMMA", "IGMMA", "HMMA", "IMMA")}
        print(f"  sass: {kind} {name.split(kind)[1][:12]}: {counts}")
        need = (["IGMMA"] + (["HGMMA"] if "Lb0E" in name else [])
                if kind.startswith("int8") else ["HGMMA"])
        _require(all(counts[op] > 0 for op in need),
                 f"{name}: no {need} in its SASS")
        _require(counts["HMMA"] == counts["IMMA"] == 0,
                 f"{name}: mma.sync / WMMA instructions in its SASS")
    _require(found == WGMMA_FUNCTIONS, f"kernel functions in the SASS: {found}")
    print("phase sass: ok")


def _bf16(torch, dev, gen, *shape):
    return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)


def phase_h1(torch, dev):
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
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
        o_ref, lse_ref = attention_plain(q, k, v, scale, True, lkv - lq)
        e_o = (o.float() - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        g = hq // hkv
        oracle = naive_attention(q, k.repeat_interleave(g, 1),
                                 v.repeat_interleave(g, 1), causal=True)
        e_or = float(np.abs(o.float().cpu().numpy() - oracle).max())
        # control: the plain version with each row's diagonal key hidden
        o_bad, _ = attention_plain(q, k, v, scale, True, lkv - lq - 1)
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


def roofline(flop: float, nbytes: float, peak: float = H100_BF16_FLOPS):
    """(bound_ms, bound_by): the least time the H100 could take, the larger
    of the operations over their peak (bf16 tensor cores unless said) and
    the bytes over HBM's rate."""
    t_op = flop / peak * 1e3
    t_mem = nbytes / H100_HBM_BYTES_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def visible_pairs(lq: int, lkv: int, causal: bool, window) -> int:
    """The (q row, key) pairs that attention needs under the decode
    convention: every pair, the causal ones, or those inside the band."""
    if not causal:
        return lq * lkv
    last = np.arange(lq) + lkv - lq                # each row's last key
    first = np.zeros(lq) if window is None else last - window + 1
    return int((np.minimum(last, lkv - 1) - np.maximum(first, 0) + 1)
               .clip(min=0).sum())


def v1_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed):
    """Standard-normal q, k, v from np.random.default_rng(seed), rounded to
    bf16 on the card, as bench.py makes its inputs."""
    from exploring_flash_attention_tpu_torch.oracle import make_qkv

    return [torch.from_numpy(x).to(dev, torch.bfloat16) for x in make_qkv(
        b, hq, lq, d, seed=seed, seq_len_kv=lkv, heads_kv=hkv)]


def v1_readings(torch, q, k, v, o, lse, causal, window, nb, nh):
    """One v1 check: max|dO| (and max|dLSE|, with lse) of the kernel's f32
    output vs the plain version over the whole tensor and vs the f64
    oracle over [:nb, :nh]; and two known-wrong controls vs the oracle on
    that slice: the plain version with the scale off by 10%, and with the
    last 64-key tile dropped."""
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops import attention_plain

    scale, diag = 1.0 / math.sqrt(q.shape[3]), k.shape[2] - q.shape[2]
    plain, lse_plain = attention_plain(q, k, v, scale, causal, diag, window)
    r = {"plain": (o - plain).abs().max().item()}
    del plain
    heads = torch.tensor([h * k.shape[1] // q.shape[1] for h in range(nh)],
                         device=q.device)
    qs, ks, vs = q[:nb, :nh], k[:nb, heads], v[:nb, heads]
    o64, lse64 = naive_attention(qs, ks, vs, causal=causal, window=window,
                                 return_lse=True)
    r["oracle"] = float(np.abs(o[:nb, :nh].cpu().numpy() - o64).max())
    bad, _ = attention_plain(qs, ks, vs, 1.1 * scale, causal, diag, window)
    r["scale"] = float(np.abs(bad.cpu().numpy() - o64).max())
    bad, _ = attention_plain(qs, ks[:, :, :-64], vs[:, :, :-64], scale,
                             causal, diag, window)
    r["drop"] = float(np.abs(bad.cpu().numpy() - o64).max())
    if lse is not None:
        fin = torch.isfinite(lse_plain)
        _require(torch.equal(torch.isfinite(lse), fin), "H1 LSE not finite "
                 "where the plain version's is")
        r["lse_plain"] = (lse - lse_plain)[fin].abs().max().item()
        r["lse_oracle"] = float(np.abs(lse[:nb, :nh].cpu().numpy()
                                       - lse64).max())
    _require(torch.isfinite(o).all().item(), "O not finite")
    return r


def v1_check(r, tol, what):
    """The readings within ``tol``, both controls beyond it."""
    _require(max(r["plain"], r["oracle"]) < tol, f"{what} outside tolerance")
    _require(min(r["scale"], r["drop"]) > tol,
             f"the check cannot tell a wrong path ({what})")


def counted_call(torch, fn, want):
    """Run fn with every counter zeroed; the launches must be ``want``."""
    zero_counters()
    out = fn()
    torch.cuda.synchronize()
    got = read_counters()
    _require(got == want, f"launches {got}, expected {want}")
    return out


def phase_v1(torch, dev):
    """flash_attention_v1, the dense forward, through its user entry
    points on H1 (and H2 where the KV is split): bench.py's gate at the
    canonical shape, one case per JAX route, H1 against the plain version
    and scaled_dot_product_attention's time, the window's loop bounds, and
    the split's spans."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        flash_attention_v1,
        flash_attention_v1_window_partial,
    )
    from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
        split_kv_span,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, h, l, d = V1_CANON
    q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, seed=1)
    # the main path: one call at the canonical shape, counters read
    zero_counters()
    o = flash_attention_v1(q, k, v, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches = read_counters()
    _require(launches == launches_only(h1=1),
             f"v1 launches {launches}, expected one H1")
    r = v1_readings(torch, q, k, v, o, None, False, None, 2, 2)
    print(f"  v1 gate B={b} H={h} L={l} d={d} bf16 in, f32 out (bench.py's "
          f"route B1): max|dO| on [:2, :2] vs f64 oracle {r['oracle']:.3e} "
          f"(bench.py's limit {V1_GATE_TOL:g}); whole tensor vs plain "
          f"{r['plain']:.3e} (tol {V1_O_TOL:g}); controls vs f64 oracle: "
          f"scale off by 10% {r['scale']:.3e}, last 64-key tile dropped "
          f"{r['drop']:.3e}; launches {launches}")
    _require(r["oracle"] <= V1_GATE_TOL, "H1 fails bench.py's gate")
    _require(r["plain"] < V1_O_TOL, "H1 differs from the plain version")
    _require(min(r["scale"], r["drop"]) > V1_GATE_TOL,
             "the gate cannot tell a wrong path")
    gate_err = r["plain"]
    del o

    scale = 1.0 / math.sqrt(d)
    t = {"ms": time_cuda(lambda: flash_attention_v1(q, k, v), n_iter=20),
         "plain_ms": time_cuda(lambda: attention_plain(q, k, v, scale, False),
                               n_iter=5, n_warmup=1),
         "library_ms": time_cuda(lambda: sdpa(q, k, v), n_iter=20)}
    flop = 4 * b * h * l * l * d
    t["bound_ms"], t["bound_by"] = roofline(flop, 4 * b * h * l * d * 2)
    t["tflops"] = flop / t["ms"] / 1e9
    print(f"  v1 times at B={b} H={h} L={l} d={d} bf16 (CUDA events, "
          f"median, L2 flushed): H1 {t['ms']:.4f} ms = "
          f"{flop / t['ms'] / 1e9:.1f} TFLOP/s ({flop / 1e9:.1f} GFLOP); "
          f"plain {t['plain_ms']:.4f} ms; scaled_dot_product_attention "
          f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']})")
    del q, k, v

    h2 = None
    for i, (route, b, hq, hkv, lq, lkv, d, causal, window, nh) in enumerate(
            V1_CASES):
        q, k, v = v1_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed=2 + i)
        span = None if causal else split_kv_span(b, hq, lq, lkv)
        _require((span is not None) == (route == V1_SPLIT_ROUTE),
                 f"{route}: KV span {span}")
        want = launches_only(h1=1, h2=int(span is not None))
        o = counted_call(torch, lambda: flash_attention_v1(
            q, k, v, causal=causal, window=window, out_dtype=torch.float32),
            want)
        tol = V1_O_TOL if window is None else V1_WINDOW_O_TOL
        r = v1_readings(torch, q, k, v, o, None, causal, window, 1, nh)
        print(f"  v1 {route}: B={b} Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} "
              f"d={d} causal={causal} window={window} KV span {span}: "
              f"max|dO| vs plain {r['plain']:.3e}, vs f64 oracle on "
              f"[:1, :{nh}] {r['oracle']:.3e} (tol {tol:g}); controls: "
              f"scale off by 10% {r['scale']:.3e}, last 64-key tile "
              f"dropped {r['drop']:.3e}; launches {want}")
        v1_check(r, tol, route)
        del o
        ms = time_cuda(lambda: flash_attention_v1(
            q, k, v, causal=causal, window=window), n_iter=10)
        ms_plain = time_cuda(lambda: attention_plain(
            q, k, v, 1.0 / math.sqrt(d), causal, lkv - lq, window),
            n_iter=3, n_warmup=1)
        flop = 4 * b * hq * d * visible_pairs(lq, lkv, causal, window)
        # SDPA masks causal top-left, which is H1's diagonal only where
        # Lq == Lkv; a window is a boolean band mask there
        lib = ""
        mask = None
        if window is not None and lq == lkv:
            i = torch.arange(lq, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                  - window)
        if not causal or mask is not None:
            ms_lib = time_cuda(lambda: sdpa(q, k, v, attn_mask=mask,
                                            enable_gqa=hq != hkv), n_iter=10)
            lib = f"; scaled_dot_product_attention {ms_lib:.4f} ms"
            if mask is not None:
                lib += " (a boolean band mask)"
                t["library_ms_by_case"] = {"B5 window": ms_lib}
        elif lq != lkv:
            lib = ("; SDPA's is_causal masks top-left, not H1's diagonal at "
                   "Lq != Lkv: its library time (an explicit bottom-right "
                   "mask) is in the times line")
        del mask
        bound = roofline(flop, 2 * d * 2 * (b * hq * lq + b * hkv * lkv))
        print(f"  v1 time of that call (bf16 O): {ms:.4f} ms = "
              f"{flop / ms / 1e9:.1f} TFLOP/s of the visible work "
              f"({flop / 1e9:.2f} GFLOP), bound {bound[0]:.4f} ms "
              f"({bound[1]}); plain {ms_plain:.4f} ms{lib}")
        if span is not None:
            h2 = split_timings(torch, q, k, v, span, want)
        if window is None:
            continue
        o, lse = counted_call(torch, lambda: flash_attention_v1_window_partial(
            q, k, v, window), launches_only(h1=1))
        r = v1_readings(torch, q, k, v, o, lse, True, window, 1, nh)
        print(f"  v1 flash_attention_v1_window_partial, same shape (B5 with "
              f"LSE): max|dO| vs plain {r['plain']:.3e}, vs f64 oracle "
              f"{r['oracle']:.3e} (tol {tol:g}); max|dLSE| vs plain "
              f"{r['lse_plain']:.3e}, vs f64 oracle {r['lse_oracle']:.3e} "
              f"(tol {H1_LSE_TOL:g}); controls {r['scale']:.3e}, "
              f"{r['drop']:.3e}; one H1 launch")
        v1_check(r, tol, "window partial")
        _require(max(r["lse_plain"], r["lse_oracle"]) < H1_LSE_TOL,
                 "the window partial's LSE is outside tolerance")
        del o, lse
        t_win = time_cuda(lambda: flash_attention_v1(
            q, k, v, causal=True, window=window), n_iter=10)
        t_causal = time_cuda(lambda: flash_attention_v1(q, k, v, causal=True),
                             n_iter=10)
        print(f"  v1 window {window} vs causal at B={b} Hq={hq} Hkv={hkv} "
              f"L={lq} d={d}: {t_win:.4f} ms vs {t_causal:.4f} ms, ratio "
              f"{t_win / t_causal:.3f} (must be < 0.5: tiles outside the "
              f"band are skipped)")
        _require(t_win < 0.5 * t_causal,
                 "the window call does not skip the tiles outside its band")
    _require(h2 is not None, "no v1 case ran the split-KV pair")
    print("phase v1: ok")
    return launches, gate_err, t, h2


def split_timings(torch, q, k, v, span, want):
    """At the split case: H2 against its plain version on H1's span
    partials (error, times, bound), then the whole call at several span
    counts, one span (H1 alone) first."""
    from exploring_flash_attention_tpu_torch.configs import cdiv
    from exploring_flash_attention_tpu_torch.ops import (
        prefill_attention,
        splitkv_combine,
        splitkv_combine_plain,
    )
    from exploring_flash_attention_tpu_torch.ops.attention import H1_TILE
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    o_part, lse = prefill_attention(q, k, v, scale, 0, False, kv_span=span,
                                    out_dtype=torch.float32)
    nkb = o_part.shape[2]
    got = splitkv_combine(o_part, lse, torch.float32)
    err = (got - splitkv_combine_plain(o_part, lse)).abs().max().item()
    _require(err < H2_O_TOL, f"H2 differs from its plain version: {err:.3e}")
    rows = b * hq * lq
    h2 = {"launches": want["h2"], "max_abs_err": err,
          "ms": time_cuda(lambda: splitkv_combine(o_part, lse, q.dtype)),
          "plain_ms": time_cuda(lambda: splitkv_combine_plain(o_part, lse)),
          "library_ms": None}
    # its operations (an FMA per partial element, an exp per partial) are
    # f32 outside the tensor cores
    h2["bound_ms"], h2["bound_by"] = roofline(
        nkb * rows * (2 * d + 1), nkb * rows * (d + 1) * 4 + rows * d * 2,
        H100_F32_FLOPS)
    spans = time_cuda(lambda: prefill_attention(
        q, k, v, scale, 0, False, kv_span=span, out_dtype=torch.float32),
        n_iter=10)
    sweep = []
    for n in SPLIT_SWEEP:
        sp = cdiv(cdiv(lkv, n), H1_TILE) * H1_TILE
        if n == 1:
            ms = time_cuda(lambda: prefill_attention(
                q, k, v, scale, 0, False, with_lse=False), n_iter=10)
        else:
            ms = time_cuda(lambda: splitkv_combine(*prefill_attention(
                q, k, v, scale, 0, False, kv_span=sp,
                out_dtype=torch.float32), q.dtype), n_iter=10)
        sweep.append(f"{n} span{'s' * (n > 1)} {ms:.4f} ms")
    print(f"  v1 split at B={b} Hq={hq} Lq={lq} Lkv={lkv} d={d}, {nkb} "
          f"spans of {span} keys: H2 vs its plain version {err:.3e} (tol "
          f"{H2_O_TOL:g}); H1 spans {spans:.4f} ms, H2 {h2['ms']:.4f} ms vs "
          f"plain {h2['plain_ms']:.4f} ms (bound {h2['bound_ms']:.4f} ms, "
          f"{h2['bound_by']}); whole call (bf16 O) by span count: "
          + ", ".join(sweep))
    return h2


def held(torch, what, o, plain, o64, bad, tol_plain, tol_oracle, nb, nh,
         note=""):
    """One check of the quant and dtiled phases: the kernel's f32 O vs the
    plain version over the whole tensor (within ``tol_plain``) and vs the
    f64 oracle on [:nb, :nh] (within ``tol_oracle``); every known-wrong
    control in ``bad`` (the plain version run wrongly on that slice) must
    read beyond both limits, vs the oracle and vs the plain version."""
    _require(torch.isfinite(o).all().item(), f"{what}: O not finite")
    e_plain = (o - plain).abs().max().item()
    e_oracle = float(np.abs(o[:nb, :nh].cpu().numpy() - o64).max())
    ps = plain[:nb, :nh].cpu().numpy()
    ctl = {name: (float(np.abs(x - o64).max()), float(np.abs(x - ps).max()))
           for name, x in bad.items()}
    print(f"  {what}: max|dO| vs plain {e_plain:.3e} (tol {tol_plain:g}), "
          f"vs f64 oracle on [:{nb}, :{nh}] {e_oracle:.3e} (tol "
          f"{tol_oracle:g}); controls vs oracle / plain: "
          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, (a, b) in ctl.items())
          + note)
    _require(e_plain < tol_plain and e_oracle < tol_oracle,
             f"{what} outside tolerance")
    _require(all(a > tol_oracle and b > tol_plain for a, b in ctl.values()),
             f"the check cannot tell a wrong path ({what})")
    return e_plain


def gate_reading(what, o, o64, tol):
    """A suite gate: max|dO| of the whole f32 O vs the f64 oracle, <= tol
    as bench/suite.py:57 holds it."""
    err = float(np.abs(o.cpu().numpy() - o64).max())
    print(f"  {what}: max|dO| vs f64 oracle {err:.3e} (the suite's limit "
          f"{tol:g})")
    _require(err <= tol, f"{what} fails the suite's gate")
    return err


def rolled(qt):
    """The neighbouring block's scales: what a wrong scale index reads."""
    from exploring_flash_attention_tpu_torch.ops import QuantizedTensor

    return QuantizedTensor(qt.values, qt.scales.roll(1, dims=2), qt.block)


def dropped_tile(qt):
    """The quantized tensor without its last 64 keys (scales unchanged)."""
    from exploring_flash_attention_tpu_torch.ops import QuantizedTensor

    return QuantizedTensor(qt.values[:, :, :-64], qt.scales, qt.block)


def heads(qt, b0, b1, nh=None):
    """Batch rows [b0, b1) and the first ``nh`` heads of a quantized
    tensor, values and scales alike."""
    from exploring_flash_attention_tpu_torch.ops import QuantizedTensor

    return QuantizedTensor(qt.values[b0:b1, :nh], qt.scales[b0:b1, :nh],
                           qt.block)


def kernel_times(call, plain, library, flop_by_peak, nbytes,
                 n_iter=20):
    """CUDA-event medians (L2 flushed) of one entry-point call, its plain
    version and the library call (if any), and the bound: the operations
    at each type's peak, summed, against the bytes at HBM's rate."""
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    t = {"ms": time_cuda(call, n_iter=n_iter),
         "plain_ms": time_cuda(plain, n_iter=3, n_warmup=1),
         "library_ms": library and time_cuda(library, n_iter=n_iter)}
    t_op = sum(f / peak for f, peak in flop_by_peak) * 1e3
    t_mem = nbytes / H100_HBM_BYTES_S * 1e3
    t["bound_ms"], t["bound_by"] = ((t_op, "operations") if t_op >= t_mem
                                    else (t_mem, "bytes"))
    return t


def phase_quant(torch, dev):
    """flash_attention_kvquant (H4-kvq) and flash_attention_int8 (H4-int8)
    through their entry points: the suite's gates at its gate inputs, one
    launch per call at the suite's shapes and the further JAX routes,
    each against the plain version and the f64 oracle beside its
    controls, and the times of the canonical calls."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops import (
        attention_int8_plain,
        attention_kvquant_plain,
        dequantize,
        flash_attention_int8,
        flash_attention_kvquant,
        quantize_fp8,
        quantize_int8,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    f32 = torch.float32
    gates = {}
    for kind in ("int8", "fp8"):        # bench/suite.py:375-383
        q, k, v = v1_inputs(torch, dev, 2, 4, 4, 512, 512, 128, seed=0)
        kq, vq = quant[kind](k, 512), quant[kind](v, 512)
        o = counted_call(torch, lambda: flash_attention_kvquant(
            q, kq, vq, out_dtype=f32), launches_only(h4kvq=1))
        gates[f"kvquant {kind}"] = gate_reading(
            f"quant kvquant {kind} gate (2, 4, 512, 128) block 512",
            o, naive_attention(q, dequantize(kq), dequantize(vq)),
            KVQ_GATE_TOL)
    for b, h, l, seed in ((2, 4, 512, 0), (1, 2, 512, 0)):   # :412, :1192
        q, k, v = v1_inputs(torch, dev, b, h, h, l, l, 128, seed=seed)
        qq, kq, vq = (quantize_int8(x, 512) for x in (q, k, v))
        o = counted_call(torch, lambda: flash_attention_int8(
            qq, kq, vq, out_dtype=f32), launches_only(h4int8=1))
        gates[f"int8 ({b}, {h})"] = gate_reading(
            f"quant int8 pv_mode bf16 gate ({b}, {h}, {l}, 128) "
            f"block 512", o,
            naive_attention(*(dequantize(x) for x in (qq, kq, vq))),
            INT8_GATE_TOL)
    del q, k, v, o

    kvq = {}
    for case, b, h, lq, lkv, d, kind, block, seed, nh in KVQ_CASES:
        q, k, v = v1_inputs(torch, dev, b, h, h, lq, lkv, d, seed=seed)
        kq, vq = quant[kind](k, block), quant[kind](v, block)
        del k, v
        o = counted_call(torch, lambda: flash_attention_kvquant(
            q, kq, vq, out_dtype=f32), launches_only(h4kvq=1))
        kvq.setdefault("launches", read_counters()["h4kvq"])
        scale = 1.0 / math.sqrt(d)
        qs, ks, vs = q[:1, :nh], heads(kq, 0, 1, nh), heads(vq, 0, 1, nh)
        bad = {"scale x1.1": attention_kvquant_plain(qs, ks, vs, 1.1 * scale),
               "last tile dropped": attention_kvquant_plain(
                   qs, dropped_tile(ks), dropped_tile(vs), scale)}
        if kq.scales.shape[2] > 1:
            bad["scales rolled"] = attention_kvquant_plain(
                qs, rolled(ks), rolled(vs), scale)
        err = held(torch, f"quant kvquant {case}: B={b} H={h} Lq={lq} "
                   f"Lkv={lkv} d={d} {kind} block {block}", o,
                   attention_kvquant_plain(q, kq, vq, scale),
                   naive_attention(qs, dequantize(ks), dequantize(vs)),
                   {n: x.cpu().numpy() for n, x in bad.items()},
                   KVQ_O_TOL, KVQ_O_TOL, 1, nh, "; one H4-kvq launch")
        if case.startswith("canonical"):
            qd, kd, vd = q, dequantize(kq, q.dtype), dequantize(vq, q.dtype)
            t = kernel_times(
                lambda: flash_attention_kvquant(q, kq, vq),
                lambda: attention_kvquant_plain(q, kq, vq, scale),
                lambda: sdpa(qd, kd, vd),
                [(4 * b * h * lq * lkv * d, H100_BF16_FLOPS)],
                2 * b * h * lq * d * 2 + 2 * b * h * lkv * d
                + 2 * kq.scales.numel() * 4)
            t["tflops"] = 4 * b * h * lq * lkv * d / t["ms"] / 1e9
            print(f"  quant kvquant {kind} times at B={b} H={h} L={lq} "
                  f"d={d}: H4-kvq {t['ms']:.4f} ms "
                  f"({t['tflops']:.1f} TFLOP/s), plain "
                  f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
                  f"over the dequantized bf16 K/V {t['library_ms']:.4f} ms "
                  f"(the dequant not counted), bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']})")
            kvq.setdefault("t", {})[kind] = t
        kvq.setdefault("err", err)
        del q, kq, vq, o

    int8 = {}
    for case, b, h, lq, lkv, d, block, modes, seed, nh, tols in INT8_CASES:
        q, k, v = v1_inputs(torch, dev, b, h, h, max(lq, lkv), max(lq, lkv),
                            d, seed=seed)
        q, k, v = q[:, :, :lq], k[:, :, :lkv], v[:, :, :lkv]
        qq, kq, vq = (quantize_int8(x, block) for x in (q, k, v))
        del k, v
        scale = 1.0 / math.sqrt(d)
        qs, ks, vs = (heads(x, 0, 1, nh) for x in (qq, kq, vq))
        o64 = naive_attention(*(dequantize(x) for x in (qs, ks, vs)))
        for mode in modes:
            o = counted_call(torch, lambda: flash_attention_int8(
                qq, kq, vq, out_dtype=f32, pv_mode=mode),
                launches_only(h4int8=1))
            int8.setdefault("launches", read_counters()["h4int8"])
            # the plain version one batch row at a time bounds its memory
            plain = torch.cat([attention_int8_plain(
                *(heads(x, i, i + 1) for x in (qq, kq, vq)), scale, mode)
                for i in range(b)])
            bad = {"scale x1.1": attention_int8_plain(qs, ks, vs, 1.1 * scale,
                                                      mode),
                   "last tile dropped": attention_int8_plain(
                       qs, dropped_tile(ks), dropped_tile(vs), scale, mode)}
            if kq.scales.shape[2] > 1:
                bad["scales rolled"] = attention_int8_plain(
                    qs, rolled(ks), rolled(vs), scale, mode)
            err = held(torch, f"quant int8 {case}: B={b} H={h} Lq={lq} "
                       f"Lkv={lkv} d={d} block {block} pv_mode {mode}", o,
                       plain, o64, {n: x.cpu().numpy() for n, x in bad.items()},
                       INT8_PLAIN_TOL, tols[mode], 1, nh,
                       "; one H4-int8 launch")
            int8.setdefault("err", err)
            del o, plain
            if not case.startswith(("canonical", "L=")):
                continue
            qd, kd, vd = (dequantize(x, q.dtype) for x in (qq, kq, vq))
            ops = 2 * b * h * lq * lkv * d
            pv_peak = H100_INT8_OPS if mode == "int8" else H100_BF16_FLOPS
            t = kernel_times(
                lambda: flash_attention_int8(qq, kq, vq, pv_mode=mode),
                lambda: [attention_int8_plain(
                    *(heads(x, i, i + 1) for x in (qq, kq, vq)), scale, mode)
                    for i in range(b)],
                lambda: sdpa(qd, kd, vd),
                [(ops, H100_INT8_OPS), (ops, pv_peak)],
                b * h * (lq + 2 * lkv) * d + b * h * lq * d * 2
                + 4 * (qq.scales.numel() + 2 * kq.scales.numel()))
            t["tops"] = 2 * ops / t["ms"] / 1e9
            t["ms_with_q_quant"] = time_cuda(lambda: flash_attention_int8(
                quantize_int8(q, block), kq, vq, pv_mode=mode), n_iter=20)
            print(f"  quant int8 {case} pv_mode {mode} times at B={b} H={h} "
                  f"L={lq} d={d}: H4-int8 {t['ms']:.4f} ms alone "
                  f"({t['tops']:.1f} TOP/s), "
                  f"{t['ms_with_q_quant']:.4f} ms with quantize_int8 of Q "
                  f"per call; plain {t['plain_ms']:.4f} ms; "
                  f"scaled_dot_product_attention over the dequantized bf16 "
                  f"Q/K/V {t['library_ms']:.4f} ms (the dequant not "
                  f"counted); bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
            int8.setdefault("t", {})[f"{case} {mode}"] = t
            del qd, kd, vd
        del q, qq, kq, vq
    print("phase quant: ok")
    return gates, kvq, int8


def sdpa_backends(torch, q, k, v):
    """The scaled_dot_product_attention backends that take these inputs,
    with the time of each, and the time of the default call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.utils import time_cuda

    out = {}
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            # a backend that refuses the inputs warns, then raises
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sdpa(q, k, v)
                torch.cuda.synchronize()
                out[name] = time_cuda(lambda: sdpa(q, k, v), n_iter=10)
        except RuntimeError:
            continue
    return out, time_cuda(lambda: sdpa(q, k, v), n_iter=20)


def phase_dtiled(torch, dev):
    """flash_attention_v1_dtiled (H5) through its entry point: the suite's
    gates at d=512, one launch per call at the suite's shape with bf16,
    fp8 and int8 K/V and a ragged d=256 case, each against the plain
    version and the f64 oracle beside its controls, and the times of the
    d=512 calls."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops import (
        attention_dtiled_plain,
        attention_plain,
        dequantize,
        flash_attention_v1_dtiled,
        quantize_fp8,
        quantize_int8,
    )

    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    f32 = torch.float32
    gates = {}
    for kind in ("bf16", "fp8", "int8"):        # bench/suite.py:295, :326
        q, k, v = v1_inputs(torch, dev, 1, 2, 2, 512, 512, 512, seed=0)
        if kind != "bf16":
            k, v = quant[kind](k, 512), quant[kind](v, 512)
        o = counted_call(torch, lambda: flash_attention_v1_dtiled(
            q, k, v, out_dtype=f32), launches_only(h5=1))
        kd, vd = (k, v) if kind == "bf16" else (dequantize(k), dequantize(v))
        gates[kind] = gate_reading(
            f"dtiled {kind} gate (1, 2, 512, 512) block 512", o,
            naive_attention(q, kd, vd), DTILED_GATE_TOL)

    out = {}
    for case, b, h, lq, lkv, d, kind, block, seed, nh in DTILED_CASES:
        q, k, v = v1_inputs(torch, dev, b, h, h, lq, lkv, d, seed=seed)
        if kind != "bf16":
            k, v = quant[kind](k, block), quant[kind](v, block)
        o = counted_call(torch, lambda: flash_attention_v1_dtiled(
            q, k, v, out_dtype=f32), launches_only(h5=1))
        out.setdefault("launches", read_counters()["h5"])
        scale = 1.0 / math.sqrt(d)
        if kind == "bf16":
            ks, vs = k[:1, :nh], v[:1, :nh]
            kd, vd = ks, vs
            short = ks[:, :, :-64], vs[:, :, :-64]
            bad_rolled = None
        else:
            ks, vs = heads(k, 0, 1, nh), heads(v, 0, 1, nh)
            kd, vd = dequantize(ks), dequantize(vs)
            short = dropped_tile(ks), dropped_tile(vs)
            bad_rolled = attention_dtiled_plain(q[:1, :nh], rolled(ks),
                                                rolled(vs), scale)
        qs = q[:1, :nh]
        bad = {"scale x1.1": attention_dtiled_plain(qs, ks, vs, 1.1 * scale),
               "last tile dropped": attention_dtiled_plain(qs, *short, scale),
               "last d-chunk out of S": attention_plain(
                   qs[..., :-128], kd[..., :-128], vd, scale, False)[0]}
        if bad_rolled is not None:
            bad["scales rolled"] = bad_rolled
        err = held(torch, f"dtiled {case}: B={b} H={h} Lq={lq} Lkv={lkv} "
                   f"d={d} block {block}", o,
                   attention_dtiled_plain(q, k, v, scale),
                   naive_attention(qs, kd, vd),
                   {n: x.cpu().numpy() for n, x in bad.items()},
                   DTILED_O_TOL, DTILED_O_TOL, 1, nh, "; one H5 launch")
        out.setdefault("err", err)
        del o
        if not case.startswith("d=512"):
            continue
        flop = 4 * b * h * lq * lkv * d
        kv_bytes = (2 * b * h * lkv * d * 2 if kind == "bf16" else
                    2 * b * h * lkv * d + 8 * k.scales.numel())
        lib = None
        if kind != "bf16":
            kd, vd = dequantize(k, q.dtype), dequantize(v, q.dtype)
            lib = lambda: sdpa(q, kd, vd)                   # noqa: E731
        t = kernel_times(lambda: flash_attention_v1_dtiled(q, k, v),
                         lambda: attention_dtiled_plain(q, k, v, scale),
                         lib, [(flop, H100_BF16_FLOPS)],
                         2 * b * h * lq * d * 2 + kv_bytes)
        if kind == "bf16":
            backends, t["library_ms"] = sdpa_backends(torch, q, k, v)
            t["library_backends_ms"] = backends
            default = t["library_ms"]
            lib_note = (f"scaled_dot_product_attention {default:.4f} ms "
                        f"(backends that take d={d}: "
                        + ", ".join(f"{n} {x:.4f} ms"
                                    for n, x in backends.items()) + ")")
        else:
            lib_note = (f"scaled_dot_product_attention over the dequantized "
                        f"bf16 K/V {t['library_ms']:.4f} ms (the dequant not "
                        f"counted)")
        print(f"  dtiled {case} times at B={b} H={h} L={lq}: H5 "
              f"{t['ms']:.4f} ms = {flop / t['ms'] / 1e9:.1f} TFLOP/s, plain "
              f"{t['plain_ms']:.4f} ms, {lib_note}, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
        out.setdefault("t", {})[kind] = t
        del q, k, v
    print("phase dtiled: ok")
    return gates, out


def make_decode_case(torch, dev, b=8, hq=8, hkv=4, d=128, ps=128,
                     max_len=1024, seed=1, chunk=0):
    """A cache like the engine's (max_len 1024 -> 8 pages per slot) filled
    through append_prompts with ragged contexts 257..280, and one bf16 q
    [B, Hq, d].  With ``chunk`` = C, append_chunks then adds C more tokens
    per sequence and q is [B, C, Hq, d]."""
    from exploring_flash_attention_tpu_torch.configs import cdiv
    from exploring_flash_attention_tpu_torch.serving import (
        append_chunks,
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
    if chunk:
        append_chunks(cache, slots,
                      torch.randn(b, chunk, hkv, d, generator=gen).to(dev),
                      torch.randn(b, chunk, hkv, d, generator=gen).to(dev))
        return cache, _bf16(torch, dev, gen, b, chunk, hq, d), slots, lens
    q = _bf16(torch, dev, gen, b, hq, d)
    return cache, q, slots, lens


@contextlib.contextmanager
def newest_token_hidden(cache, slots):
    """A known-wrong path: each sequence's newest cached token is hidden
    (an off-by-one length), for the controls of the decode and extend
    checks.  In extend, where row i sits at seq_lens - C + i, it hides
    every chunk row's own (diagonal) key."""
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


def phase_extend(torch, dev):
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.serving import (
        gather_kv,
        paged_extend_attention,
        paged_extend_plain,
    )

    c = 256
    cache, q, slots, lens = make_decode_case(torch, dev, chunk=c)
    b, _, hq, d = q.shape
    hkv = cache.num_kv_heads
    scale = 1.0 / math.sqrt(d)
    o = paged_extend_attention(q, cache, slots)
    torch.cuda.synchronize()
    ref = paged_extend_plain(q, cache, slots, scale)
    e_o = (o.float() - ref).abs().max().item()
    e_or = 0.0                  # first and last chunk row of every sequence
    for s in range(b):
        kf, vf = gather_kv(cache, s)
        for i in (0, c - 1):
            pos = int(lens[s]) + i
            oracle = naive_attention(q[s, i].view(hkv, hq // hkv, d),
                                     kf[:, :pos + 1], vf[:, :pos + 1])
            got = o[s, i].float().view(hkv, hq // hkv, d).cpu().numpy()
            e_or = max(e_or, float(np.abs(got - oracle).max()))
    with newest_token_hidden(cache, slots):         # control
        bad = paged_extend_plain(q, cache, slots, scale)
    e_bad = (o.float() - bad).abs().max().item()
    print(f"  extend B={b} C={c} Hq={hq} Hkv={hkv} d={d} "
          f"ps={cache.page_size} history {lens.min()}..{lens.max()}: "
          f"max|dO| vs plain {e_o:.3e} (tol {EXTEND_O_TOL:g}), vs f64 "
          f"oracle on rows 0 and C-1 {e_or:.3e} (tol {EXTEND_O_TOL:g}), "
          f"control (diagonal key hidden) {e_bad:.3e}")
    _require(torch.isfinite(o.float()).all().item(), "H6-extend O not finite")
    _require(e_o < EXTEND_O_TOL and e_or < EXTEND_O_TOL,
             "H6-extend outside tolerance")
    _require(e_bad > EXTEND_O_TOL,
             "H6-extend tolerance cannot tell a wrong mask")
    print("phase extend: ok")
    return e_o


def _rel(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def f64_attention_grads(torch, q, k, v, do, scale, causal, diag_off,
                        window=None):
    """Gradients of sum(o * do) by f64 autograd through the plain forward
    under the mask (every row must see a key: a row that sees none has no
    gradient)."""
    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
    )
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    o, _ = attention_plain(qd, kd, vd, scale, causal, diag_off, window)
    return torch.autograd.grad((o * do.double()).sum(), (qd, kd, vd))


def bwd_control(torch, mask, q, k, v, out, do, lse, scale, off, window):
    """(what, grads) of the known-wrong backward beside each mask: the
    diagonal key hidden (causal), the last 64-key tile dropped, its dK and
    dV rows left zero (none), the window one key narrower (window)."""
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
    )
    if mask == "causal":
        return "diagonal key hidden", attention_bwd_plain(
            q, k, v, out, do, lse, scale, True, off - 1)
    if mask == "window":
        return "window one key narrower", attention_bwd_plain(
            q, k, v, out, do, lse, scale, True, off, window - 1)
    dq, dk, dv = attention_bwd_plain(q, k[:, :, :-64], v[:, :, :-64], out,
                                     do, lse, scale, False)
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 64))  # noqa: E731
    return "last 64-key tile dropped", (dq, pad(dk), pad(dv))


def phase_bwd(torch, dev):
    """H3 through flash_attention_bwd at every BWD_SHAPES case under each
    mask (BWD_MASKS), against attention_bwd_plain and f64 autograd, beside
    the mask's known-wrong control; two runs must be bitwise equal."""
    from exploring_flash_attention_tpu_torch.ops.attention import (
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
        flash_attention_bwd,
    )

    gen = torch.Generator().manual_seed(3)
    errs = {}                   # max |d| vs plain at the first shape, by mask
    for b, hq, hkv, lq, lkv, d in BWD_SHAPES:
        q = _bf16(torch, dev, gen, b, hq, lq, d)
        k = _bf16(torch, dev, gen, b, hkv, lkv, d)
        v = _bf16(torch, dev, gen, b, hkv, lkv, d)
        do = _bf16(torch, dev, gen, b, hq, lq, d)
        scale, off = 1.0 / math.sqrt(d), lkv - lq
        for mask, (causal, window) in BWD_MASKS.items():
            out, lse = prefill_attention(q, k, v, scale, off, causal,
                                         window)        # H1's residuals
            run = lambda: flash_attention_bwd(                  # noqa: E731
                q, k, v, out, do, lse, scale, causal=causal, window=window)
            grads, again = run(), run()
            torch.cuda.synchronize()
            identical = all(torch.equal(x, y) for x, y in zip(grads, again))
            plain = attention_bwd_plain(q, k, v, out, do, lse, scale, causal,
                                        off, window)
            f64 = f64_attention_grads(torch, q, k, v, do, scale, causal, off,
                                      window)
            what, bad = bwd_control(torch, mask, q, k, v, out, do, lse,
                                    scale, off, window)
            e_plain = [_rel(g, r) for g, r in zip(grads, plain)]
            e_f64 = [_rel(g, r) for g, r in zip(grads, f64)]
            e_bad = [_rel(g, r) for g, r in zip(grads, bad)]
            fmt = lambda e: " ".join(                           # noqa: E731
                f"{n} {x:.3e}" for n, x in zip(("dq", "dk", "dv"), e))
            print(f"  bwd {mask}{f' {window}' if window else ''} B={b} "
                  f"Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} d={d}: "
                  f"max|d|/max|ref| vs plain {fmt(e_plain)}; vs f64 "
                  f"autograd {fmt(e_f64)} (tol {H3_REL_TOL:g}); control "
                  f"({what}) {fmt(e_bad)}; two runs bitwise equal: "
                  f"{identical}")
            _require(all(torch.isfinite(g.float()).all().item()
                         for g in grads), "H3 gradients not finite")
            _require(max(e_plain + e_f64) < H3_REL_TOL,
                     "H3 outside tolerance")
            _require(min(e_bad) > H3_REL_TOL,
                     f"H3 tolerance cannot tell a wrong mask ({mask})")
            _require(identical, "H3 is not deterministic")
            errs.setdefault(mask, [(g.float() - r.float()).abs().max().item()
                                   for g, r in zip(grads, plain)])
            del out, lse, grads, again, plain, f64, bad
    print("phase bwd: ok")
    return {m: {"h3dq": e[0], "h3dkv": max(e[1:])} for m, e in errs.items()}


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


def _counted():
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        flash_attention_int8,
        flash_attention_kvquant,
        flash_attention_v1_dtiled,
        prefill_attention,
        splitkv_combine,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
        paged_extend_attention,
    )
    return {"h1": prefill_attention, "h2": splitkv_combine,
            "h6": paged_decode_attention,
            "h6e": paged_extend_attention, "h3dkv": attention_bwd_dkv,
            "h3dq": attention_bwd_dq, "h4kvq": flash_attention_kvquant,
            "h4int8": flash_attention_int8, "h5": flash_attention_v1_dtiled}


def launches_only(**counts):
    """The expected counters: the named ones, every other kernel 0."""
    return {name: counts.get(name, 0) for name in _counted()}


def zero_counters():
    for fn in _counted().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in _counted().items()}


def make_flagship(torch, dev):
    """The full-width flagship LM with random weights from seed 0, and the
    [8, 256] prompts of both generation phases."""
    from types import SimpleNamespace

    from exploring_flash_attention_tpu_torch.models import (
        flagship_config,
        init_params,
    )

    cfg = flagship_config()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 256)).astype(np.int32)
    return SimpleNamespace(cfg=cfg, params=params, prompt=prompt,
                           t_init=t_init)


def phase_slice(torch, dev, lm):
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import GenerationEngine
    from exploring_flash_attention_tpu_torch.models import (
        generate as generate_module,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
    )

    cfg, params, prompt = lm.cfg, lm.params, lm.prompt
    (bsz, l_prompt), n_new = prompt.shape, 24
    eng = GenerationEngine(params, cfg, max_seqs=bsz, max_len=1024)

    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompt, max_new_tokens=n_new)
    t_first = time.perf_counter() - t0
    launches = read_counters()
    want = launches_only(h1=cfg.n_layers, h6=cfg.n_layers * (n_new - 1))
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
    print(f"  slice init {lm.t_init:.2f} s, first generate {t_first:.3f} s, "
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


def phase_multiturn(torch, dev, lm):
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        GenerationEngine,
        forward_collect_kv,
    )
    from exploring_flash_attention_tpu_torch.models import (
        generate as generate_module,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        gather_kv,
        paged_extend_attention,
    )

    cfg, params, prompt = lm.cfg, lm.params, lm.prompt
    bsz, n_new, l_turn = prompt.shape[0], 24, 256
    eng = GenerationEngine(params, cfg, max_seqs=bsz, max_len=1024)
    zero_counters()
    out1 = eng.generate(prompt, max_new_tokens=n_new, hold=True)
    turn1 = read_counters()
    # turn 2: turn 1's last token, which was never fed into the cache, then
    # 255 user tokens; the chunk sits at 256 + 23 = 279 .. 534
    turn = np.concatenate([out1[:, -1:], np.random.default_rng(1).integers(
        0, cfg.vocab_size, (bsz, l_turn - 1)).astype(np.int32)], axis=1)
    zero_counters()
    out2 = eng.continue_generation(turn, max_new_tokens=n_new)
    turn2 = read_counters()
    want1 = launches_only(h1=cfg.n_layers, h6=cfg.n_layers * (n_new - 1))
    want2 = launches_only(h6=cfg.n_layers * (n_new - 1), h6e=cfg.n_layers)
    print(f"  multiturn launches turn 1 {turn1} (expected {want1}), "
          f"turn 2 {turn2} (expected {want2})")
    _require(turn1 == want1 and turn2 == want2,
             "the multi-turn path missed a kernel")
    _require(out2.shape == (bsz, n_new) and out2.dtype == np.int32
             and (out2 >= 0).all() and (out2 < cfg.vocab_size).all(),
             f"bad tokens {out2.shape} {out2.dtype}")

    # the cache holds prompt ++ turn 1 ++ the user's tokens ++ turn 2 but
    # its last token; the control stream lacks turn 1's last token
    prefix = np.concatenate([prompt, out1, turn[:, 1:]], axis=1)
    stream = np.concatenate([prefix, out2[:, :-1]], axis=1)
    short = np.concatenate([prompt, out1[:, :-1], turn[:, 1:], out2[:, :-1]],
                           axis=1)
    n = stream.shape[1]
    _, kvs = forward_collect_kv(params, torch.from_numpy(stream).to(dev), cfg)
    _, kvs_bad = forward_collect_kv(params, torch.from_numpy(short).to(dev),
                                    cfg)
    e_kv = e_bad = 0.0
    for cache, (k_ref, v_ref), (k_bad, _) in zip(eng.caches, kvs, kvs_bad):
        _require(bool((cache.seq_lens[:bsz] == n).all()),
                 f"cache lengths {cache.seq_lens.tolist()}, expected {n}")
        for s in range(bsz):
            k, v = gather_kv(cache, s)                  # [Hkv, n, d] f32
            e_kv = max(e_kv,
                       (k - k_ref[s].transpose(0, 1)).abs().max().item(),
                       (v - v_ref[s].transpose(0, 1)).abs().max().item())
            e_bad = max(e_bad, (k[:, :n - 1] - k_bad[s].transpose(0, 1))
                        .abs().max().item())
    del kvs, kvs_bad
    eng.release()
    free = eng.allocator.free_pages

    torch.cuda.synchronize()
    eng.generate(prompt, max_new_tokens=n_new, hold=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.continue_generation(turn, max_new_tokens=n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eng.release()
    tok_s = bsz * n_new / dt

    # controls: the turn without its first token (turn 1's last), and the
    # turn with every chunk row's own key hidden in the extend kernel
    def hide_diagonal(q, cache, slots):
        with newest_token_hidden(cache, slots):
            return paged_extend_attention(q, cache, slots)

    eng.generate(prompt, max_new_tokens=n_new, hold=True)
    short_out = eng.continue_generation(turn[:, 1:], max_new_tokens=n_new)
    eng.release()
    eng.generate(prompt, max_new_tokens=n_new, hold=True)
    with mock.patch.object(generate_module, "paged_extend_attention",
                           hide_diagonal):
        diag_out = eng.continue_generation(turn, max_new_tokens=n_new)
    eng.release()
    agree, steps, worst_gap = compare_with_full_forward(
        torch, params, cfg, prefix, out2)
    bad_agree, _, bad_gap = compare_with_full_forward(
        torch, params, cfg, prefix, short_out)
    diag_agree, _, diag_gap = compare_with_full_forward(
        torch, params, cfg, prefix, diag_out)
    print(f"  multiturn cache after turn 2 ({n} tokens, {cfg.n_layers} "
          f"layers): max|dK|,|dV| vs forward_collect_kv over the stream "
          f"{e_kv:.3e} (tol {CACHE_KV_TOL:g}), control (turn without its "
          f"first token) {e_bad:.3e}; pages free after release {free}/"
          f"{eng.allocator.n_pages}")
    print(f"  multiturn turn 2 second call {dt:.4f} s: {tok_s:.1f} tokens/s "
          f"(B={bsz}, turn {l_turn}, {n_new} new, incl. the extend); repeat "
          f"identical: {bool(np.array_equal(out2, again))}; full-forward "
          f"agreement {agree}/{steps}, largest gap of a disagreement "
          f"{worst_gap:.4f} (limit {LOGIT_GAP}); control (turn without its "
          f"first token) {bad_agree}/{steps}, largest gap {bad_gap:.4f}; "
          f"diagonal key hidden in extend (not required to fail: a one-key "
          f"mask fault is the extend phase's to catch) {diag_agree}/{steps}, "
          f"largest gap {diag_gap:.4f}")
    _require(e_kv < CACHE_KV_TOL, "the cache after turn 2 differs from "
             "the forward over the stream")
    _require(e_bad > CACHE_KV_TOL,
             "the cache check cannot tell a stream one token short")
    _require(free == eng.allocator.n_pages, "release() kept pages")
    _require(worst_gap < LOGIT_GAP,
             "a turn-2 token differs from the full forward's beyond a tie")
    _require(bad_gap >= LOGIT_GAP,
             "the full-forward check cannot tell a turn one token short")
    print("phase multiturn: ok")
    return turn2, tok_s


def train_step_flop(cfg, b, l):
    """FLOPs of one train step (forward + backward): 6 per matmul weight
    per token for the projections, the SwiGLU FFN and the tied logits, and
    for causal attention 4·B·Hq·L²·d/2 forward (S and P V on the visible
    half) plus 2.5 times that backward (S recomputed, dP, dV, dQ, dK)."""
    e, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    per_layer = 2 * e * hq * dh + 2 * e * hkv * dh + 3 * e * cfg.d_ff
    weights = cfg.n_layers * per_layer + cfg.vocab_size * e
    attn_fwd = 4 * b * hq * l * l * dh / 2
    return 6 * weights * b * l + cfg.n_layers * 3.5 * attn_fwd


def plain_flash_attention(q, k, v, causal=True, hidden=0, as_causal=False):
    """The model's attention on the plain PyTorch forward, differentiated
    by autograd: the reference path of the train and encoder checks.
    Known-wrong forwards: ``hidden=1`` hides each row's diagonal key,
    ``as_causal`` masks a bidirectional call causally."""
    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
    )
    o, _ = attention_plain(q, k, v, 1.0 / math.sqrt(q.shape[3]),
                           causal or as_causal,
                           k.shape[2] - q.shape[2] - hidden)
    return o.to(q.dtype)


def hide_diagonal_bwd(q, k, v, out, do, lse, scale, causal, diag_off,
                      window):
    """A known-wrong backward: the plain one with each row's diagonal key
    hidden."""
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
    )
    return attention_bwd_plain(q, k, v, out, do, lse, scale, True,
                               diag_off - 1, window)


def causal_bwd(q, k, v, out, do, lse, scale, causal, diag_off, window):
    """A known-wrong backward of a bidirectional forward: the plain one
    under the causal mask."""
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
    )
    return attention_bwd_plain(q, k, v, out, do, lse, scale, True, diag_off)


def leaf_err(named_leaves, grads, ref):
    """The largest per-leaf ||g - ref|| / ||ref||, and its leaf's name."""
    errs = [((g.float() - r.float()).norm() / r.float().norm()).item()
            for g, r in zip(grads, ref)]
    worst = int(np.argmax(errs))
    return errs[worst], named_leaves[worst]


def phase_train(torch, dev):
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        flagship_config,
        init_params,
        loss_fn,
        make_train_step,
        make_trainable,
        named_param_leaves,
    )
    from exploring_flash_attention_tpu_torch.models import (
        transformer as transformer_module,
    )
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd as attention_bwd_module,
    )

    cfg = flagship_config()
    bsz, seq, n_steps, n_timed = 8, 1024, 5, 5
    params = make_trainable(init_params(cfg, seed=0, device=dev))
    names, leaves = zip(*named_param_leaves(params))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, seq + 1)).astype(np.int32)).to(dev)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def loss_and_grads():
        loss = loss_fn(params, inputs, targets, cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           plain_flash_attention):
        loss_p, grads_p = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           functools.partial(plain_flash_attention,
                                             hidden=1)):
        loss_bad = loss_and_grads()[0]
    with mock.patch.object(attention_bwd_module, "masked_attention_bwd",
                           hide_diagonal_bwd):
        grads_bad = loss_and_grads()[1]
    e_grad, leaf = leaf_err(names, grads_k, grads_p)
    e_bad, leaf_bad = leaf_err(names, grads_bad, grads_p)
    del grads_k, grads_p, grads_bad
    print(f"  train step-0 loss {loss_k:.6f}, with the plain attention "
          f"{loss_p:.6f}: |d| {abs(loss_k - loss_p):.3e} (tol "
          f"{TRAIN_LOSS_TOL:g}), control (diagonal key hidden in the "
          f"forward) {abs(loss_bad - loss_p):.3e}; largest per-leaf "
          f"||dg||/||g|| over {len(leaves)} leaves vs the plain path "
          f"{e_grad:.3e} at {leaf} (tol {GRAD_REL_TOL:g}), control "
          f"(diagonal key hidden in the backward) {e_bad:.3e} at {leaf_bad}")
    _require(math.isfinite(loss_k), "step-0 loss not finite")
    _require(abs(loss_k - loss_p) < TRAIN_LOSS_TOL,
             "the step-0 loss differs from the plain path's")
    _require(abs(loss_bad - loss_p) > TRAIN_LOSS_TOL,
             "the loss check cannot tell a wrong mask")
    _require(e_grad < GRAD_REL_TOL, "gradients differ from the plain path's")
    _require(e_bad > GRAD_REL_TOL,
             "the gradient check cannot tell a wrong backward")

    step, opt_init = make_train_step(cfg)
    opt = opt_init(params)
    want = launches_only(h1=cfg.n_layers, h3dkv=cfg.n_layers,
                         h3dq=cfg.n_layers)
    losses, counts = [], []
    for _ in range(n_steps):
        zero_counters()
        losses.append(step(params, opt, tokens).item())
        counts.append(read_counters())
    print(f"  train launches per step {counts[0]} (expected {want}); AdamW "
          f"losses over {n_steps} steps {[round(x, 6) for x in losses]}")
    _require(all(c == want for c in counts), "a train step missed a kernel")
    _require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    _require(all(b < a for a, b in zip(losses, losses[1:])),
             "the loss did not fall strictly over the AdamW steps")

    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    flop = train_step_flop(cfg, bsz, seq)
    print(f"  train step {flop / 1e12:.3f} TFLOP (matmuls, causal attention "
          f"incl. its recompute): {flop / med / 1e12:.1f} TFLOP/s at the "
          f"median step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    tok_s = bsz * seq / med
    print(f"  train step times s {[round(t, 5) for t in sorted(times)]}: "
          f"median {med:.5f} s, {tok_s:.1f} training tokens/s (B={bsz}, "
          f"L={seq}, forward + backward + AdamW)")
    print("phase train: ok")
    return counts[0], tok_s


def phase_encoder(torch, dev):
    """The JAX suite's encoder entry (bench/suite.py:1057-1102) on the
    port: the flagship geometry trained with make_mlm_train_step (AdamW,
    lr 1e-3) on tokens [8, 1024] from np.random.default_rng(0), under one
    fixed mask in every step, as the suite holds its rng fixed."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        flagship_config,
        init_params,
        make_mlm_train_step,
        make_trainable,
        mask_tokens,
        mlm_loss,
        named_param_leaves,
    )
    from exploring_flash_attention_tpu_torch.models import (
        transformer as transformer_module,
    )
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd as attention_bwd_module,
    )

    cfg = flagship_config()
    bsz, seq, n_steps, n_timed = 8, 1024, 5, 5
    mtok = cfg.vocab_size - 1
    params = make_trainable(init_params(cfg, seed=0, device=dev))
    names, leaves = zip(*named_param_leaves(params))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (bsz, seq)).astype(np.int32)).to(dev)
    _, mask = mask_tokens(tokens, torch.Generator(device=dev).manual_seed(0),
                          mtok)

    def loss_and_grads():
        loss = mlm_loss(params, tokens, None, cfg, mtok, mask=mask)
        return loss.item(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           plain_flash_attention):
        loss_p, grads_p = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           functools.partial(plain_flash_attention,
                                             as_causal=True)):
        loss_bad = loss_and_grads()[0]
    with mock.patch.object(attention_bwd_module, "masked_attention_bwd",
                           causal_bwd):
        grads_bad = loss_and_grads()[1]
    e_grad, leaf = leaf_err(names, grads_k, grads_p)
    e_bad, leaf_bad = leaf_err(names, grads_bad, grads_p)
    del grads_k, grads_p, grads_bad
    print(f"  encoder step-0 MLM loss {loss_k:.6f} over "
          f"{int(mask.sum())} masked tokens, with the plain attention "
          f"{loss_p:.6f}: |d| {abs(loss_k - loss_p):.3e} (tol "
          f"{ENCODER_LOSS_TOL:g}), control (causal forward) "
          f"{abs(loss_bad - loss_p):.3e}; largest per-leaf ||dg||/||g|| "
          f"over {len(leaves)} leaves vs the plain path {e_grad:.3e} at "
          f"{leaf} (tol {GRAD_REL_TOL:g}), control (causal backward) "
          f"{e_bad:.3e} at {leaf_bad}")
    _require(math.isfinite(loss_k), "encoder step-0 loss not finite")
    _require(abs(loss_k - loss_p) < ENCODER_LOSS_TOL,
             "the encoder's step-0 loss differs from the plain path's")
    _require(abs(loss_bad - loss_p) > ENCODER_LOSS_TOL,
             "the encoder's loss check cannot tell a causal forward")
    _require(e_grad < GRAD_REL_TOL,
             "encoder gradients differ from the plain path's")
    _require(e_bad > GRAD_REL_TOL,
             "the encoder's gradient check cannot tell a causal backward")

    step, opt_init = make_mlm_train_step(cfg)
    opt = opt_init(params)
    want = launches_only(h1=cfg.n_layers, h3dkv=cfg.n_layers,
                         h3dq=cfg.n_layers)
    losses, counts = [], []
    for _ in range(n_steps):
        zero_counters()
        losses.append(step(params, opt, tokens, None, mask).item())
        counts.append(read_counters())
    print(f"  encoder launches per step {counts[0]} (expected {want}); "
          f"AdamW MLM losses over {n_steps} steps "
          f"{[round(x, 6) for x in losses]}")
    _require(all(c == want for c in counts),
             "an encoder step missed a kernel")
    _require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    _require(all(b < a for a, b in zip(losses, losses[1:])),
             "the MLM loss did not fall strictly over the AdamW steps")

    times = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, tokens, None, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    tok_s = bsz * seq / med
    print(f"  encoder step times s {[round(t, 5) for t in sorted(times)]}: "
          f"median {med:.5f} s, {tok_s:.1f} encoder training tokens/s "
          f"(B={bsz}, L={seq}, MLM forward + backward + AdamW, fixed mask)")
    print("phase encoder: ok")
    return counts[0], tok_s


def time_kernels(torch, dev):
    """CUDA-event medians (L2 flushed before each call) of H6-decode,
    H6-extend and H3 beside their plain versions, their bounds from these
    inputs and, for H3, the backward of scaled_dot_product_attention; and
    H1 at the generation and training shapes and at the v1 phase's causal
    cross case beside scaled_dot_product_attention (is_causal where Lq ==
    Lkv, a bottom-right boolean mask at Lq=512, Lkv=1024); the v1 phase
    times H1 at the canonical shape."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        attention_bwd_plain,
        attention_plain,
        flash_attention_bwd,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
        paged_decode_plain,
        paged_extend_attention,
        paged_extend_plain,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    gen = torch.Generator().manual_seed(2)
    q = _bf16(torch, dev, gen, 8, 8, 256, 128)
    k = _bf16(torch, dev, gen, 8, 4, 256, 128)
    v = _bf16(torch, dev, gen, 8, 4, 256, 128)
    s = 1.0 / math.sqrt(128)
    h1 = (time_cuda(lambda: prefill_attention(q, k, v, s, 0)),
          time_cuda(lambda: attention_plain(q, k, v, s, True, 0)))
    # Lq == Lkv here, so SDPA's top-left causal diagonal is H1's
    out = {"h1_causal_library": {"L=256": time_cuda(lambda: sdpa(
        q, k, v, is_causal=True, enable_gqa=True))}}

    def h1_bound(l, b=8, hq=8, hkv=4, d=128):
        """H1's causal bound at the slice's widths: q, k, v and o in bf16,
        the f32 LSE."""
        return roofline(4 * b * hq * d * visible_pairs(l, l, True, None),
                        2 * d * 2 * (b * hq * l + b * hkv * l)
                        + 4 * b * hq * l)[0]

    # H6: int8 K and V rows plus their f32 scales for every cached token,
    # q and o in bf16; 4 flops per (q head, token, d)
    hq, hkv, d = 8, 4, 128
    cache, qd, slots, lens = make_decode_case(torch, dev)
    n_tok = int(lens.sum())
    out["h6"] = {
        "ms": time_cuda(lambda: paged_decode_attention(qd, cache, slots)),
        "plain_ms": time_cuda(lambda: paged_decode_plain(qd, cache, slots,
                                                         s)),
        "library_ms": None}
    out["h6"]["bound_ms"], out["h6"]["bound_by"] = roofline(
        4 * hq * d * n_tok,
        n_tok * hkv * (2 * d + 8) + 2 * len(lens) * hq * d * 2)
    c = 256
    cache, qe, slots, lens = make_decode_case(torch, dev, chunk=c)
    seen = sum(c * int(n) + c * (c + 1) // 2 for n in lens)  # (row, key)
    out["h6e"] = {
        "ms": time_cuda(lambda: paged_extend_attention(qe, cache, slots)),
        "plain_ms": time_cuda(lambda: paged_extend_plain(qe, cache, slots,
                                                         s)),
        "library_ms": None}
    out["h6e"]["bound_ms"], out["h6e"]["bound_by"] = roofline(
        4 * hq * d * seen,
        int(lens.sum() + c * len(lens)) * hkv * (2 * d + 8)
        + 2 * len(lens) * c * hq * d * 2)
    del cache
    # H3 at the training shape, causal (the train step) and without a mask
    # (the encoder step): each kernel alone, the delta reduction alone, the
    # pair through flash_attention_bwd, against the whole plain backward
    # and the autograd backward through scaled_dot_product_attention under
    # the same mask (its forward recorded once, outside the timed calls)
    b, l = 8, 1024
    q, do = (_bf16(torch, dev, gen, b, hq, l, d) for _ in range(2))
    k, v = (_bf16(torch, dev, gen, b, hkv, l, d) for _ in range(2))
    q_bytes, kv_bytes, row_bytes = b * hq * l * d * 2, b * hkv * l * d * 2, \
        b * hq * l * 4
    for causal in (True, False):
        o, lse = prefill_attention(q, k, v, s, 0, causal)
        delta = (do.float() * o.float()).sum(dim=-1)
        leaves = [x.detach().clone().requires_grad_() for x in (
            q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1))]
        o_lib = sdpa(*leaves, is_causal=causal)
        lib = time_cuda(lambda: torch.autograd.grad(
            o_lib, leaves, do, retain_graph=True), n_iter=20)
        plain = time_cuda(lambda: attention_bwd_plain(
            q, k, v, o, do, lse, s, causal, 0), n_iter=20)
        pairs = visible_pairs(l, l, causal, None) * b * hq
        t = {"h3dkv": {"ms": time_cuda(lambda: attention_bwd_dkv(
                 q, k, v, do, lse, delta, s, causal, 0), n_iter=20),
                 "plain_ms": plain, "library_ms": lib},
             "h3dq": {"ms": time_cuda(lambda: attention_bwd_dq(
                 q, k, v, do, lse, delta, s, causal, 0), n_iter=20),
                 "plain_ms": plain, "library_ms": lib}}
        t["h3dkv"]["bound_ms"], t["h3dkv"]["bound_by"] = roofline(
            8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes)
        t["h3dq"]["bound_ms"], t["h3dq"]["bound_by"] = roofline(
            6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes)
        for x in t.values():
            x["bound_share"] = x["bound_ms"] / x["ms"]
        delta_ms = time_cuda(lambda: (do.float() * o.float()).sum(dim=-1),
                             n_iter=20)
        pair = time_cuda(lambda: flash_attention_bwd(
            q, k, v, o, do, lse, s, causal=causal), n_iter=20)
        name = "causal" if causal else "none"
        out[f"h3_{name}"] = {**t, "delta_ms": delta_ms, "pair_ms": pair}
        print(f"  times at B=8 Hq=8 Hkv=4 L=1024 d=128, mask {name}: "
              f"H3-dkv {t['h3dkv']['ms']:.4f} ms (bound "
              f"{t['h3dkv']['bound_ms']:.4f} ms, "
              f"{t['h3dkv']['bound_share']:.1%}), H3-dq "
              f"{t['h3dq']['ms']:.4f} ms (bound {t['h3dq']['bound_ms']:.4f} "
              f"ms, {t['h3dq']['bound_share']:.1%}), the delta reduction "
              f"{delta_ms:.4f} ms, flash_attention_bwd (delta + both) "
              f"{pair:.4f} ms vs attention_bwd_plain {plain:.4f} ms and the "
              f"backward of scaled_dot_product_attention "
              f"(is_causal={causal}) {lib:.4f} ms")
        del leaves, o_lib
    h1_long = time_cuda(lambda: prefill_attention(q, k, v, s, 0), n_iter=20)
    out["h1_causal_library"]["L=1024"] = time_cuda(lambda: sdpa(
        q, k, v, is_causal=True, enable_gqa=True), n_iter=20)
    # the v1 phase's causal cross case (B4 at Lq != Lkv): SDPA's is_causal
    # masks top-left, so its library call takes H1's bottom-right diagonal
    # as an explicit boolean mask
    lq, lkv = 512, 1024
    q = _bf16(torch, dev, gen, b, hq, lq, d)
    k, v = (_bf16(torch, dev, gen, b, hkv, lkv, d) for _ in range(2))
    i = torch.arange(lq, device=dev)[:, None]
    cross = torch.arange(lkv, device=dev)[None, :] <= i + lkv - lq
    out["h1_causal_library"]["Lq=512 Lkv=1024"] = time_cuda(lambda: sdpa(
        q, k, v, attn_mask=cross, enable_gqa=True), n_iter=20)
    h1_cross = time_cuda(lambda: prefill_attention(q, k, v, s, lkv - lq),
                         n_iter=20)
    cross_bound = roofline(4 * b * hq * d * visible_pairs(lq, lkv, True, None),
                           2 * d * 2 * (b * hq * lq + b * hkv * lkv))[0]
    print(f"  times (CUDA events, median of 50 calls, 20 at L=1024, L2 "
          f"flushed before each): "
          f"H1 {h1[0]:.4f} ms vs plain {h1[1]:.4f} ms (bound "
          f"{h1_bound(256):.4f} ms; scaled_dot_product_attention causal "
          f"{out['h1_causal_library']['L=256']:.4f} ms) at B=8 Hq=8 Hkv=4 "
          f"L=256 d=128; H6-decode {out['h6']['ms']:.4f} ms vs plain "
          f"{out['h6']['plain_ms']:.4f} ms (bound "
          f"{out['h6']['bound_ms']:.4f} ms, {out['h6']['bound_by']}) at B=8 "
          f"Hq=8 Hkv=4 ctx 257..280 d=128; H6-extend "
          f"{out['h6e']['ms']:.4f} ms vs plain {out['h6e']['plain_ms']:.4f} "
          f"ms (bound {out['h6e']['bound_ms']:.4f} ms, "
          f"{out['h6e']['bound_by']}) at B=8 C=256 Hq=8 Hkv=4 history "
          f"257..280 d=128")
    print(f"  times at B=8 Hq=8 Hkv=4 L=1024 d=128 causal: H1 forward "
          f"{h1_long:.4f} ms (bound {h1_bound(1024):.4f} "
          f"ms; scaled_dot_product_attention causal "
          f"{out['h1_causal_library']['L=1024']:.4f} ms)")
    print(f"  times at B=8 Hq=8 Hkv=4 Lq={lq} Lkv={lkv} d=128 causal (B4 "
          f"cross): H1 {h1_cross:.4f} ms (bound {cross_bound:.4f} ms); "
          f"scaled_dot_product_attention with the bottom-right boolean mask "
          f"{out['h1_causal_library']['Lq=512 Lkv=1024']:.4f} ms")
    return out


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
    v1_launches, v1_err, v1_t, h2 = phase_v1(torch, dev)
    quant_gates, kvq, int8 = phase_quant(torch, dev)
    dtiled_gates, h5 = phase_dtiled(torch, dev)
    h6_err = phase_decode(torch, dev)
    h6e_err = phase_extend(torch, dev)
    h3_err = phase_bwd(torch, dev)
    lm = make_flagship(torch, dev)
    launches, _ = phase_slice(torch, dev, lm)
    turn2, _ = phase_multiturn(torch, dev, lm)
    del lm
    train, _ = phase_train(torch, dev)
    encoder, _ = phase_encoder(torch, dev)
    t = time_kernels(torch, dev)
    _require("jax" not in sys.modules, "JAX was imported")
    print(json.dumps({"kernels": [
        # H1's numbers are the v1 phase's: its main call at bench.py's
        # canonical shape, and its times there
        {"name": "H1 attention forward (none, causal, window; d 32/64/128)",
         "route": "cuda", "source": H1_SRC, "replaces": f"{V1_PY}:1139",
         "also_replaces": [f"{V1_PY}:{n}" for n in (387, 213, 489, 901,
                                                     1261, 1357)]
         + [f"{SPLITKV_PY}:51", f"{SPLITKV_PY}:213"],
         "launches": v1_launches["h1"], "max_abs_err": v1_err,
         "design": "wgmma",
         "bound_share": v1_t["bound_ms"] / v1_t["ms"],
         "launches_by_path": {"v1": v1_launches["h1"],
                              "slice": launches["h1"],
                              "train_step": train["h1"],
                              "encoder_step": encoder["h1"]},
         **v1_t, "library_ms_by_case": {
             **v1_t["library_ms_by_case"],
             **{f"B4 causal {n}": x
                for n, x in t["h1_causal_library"].items()}}},
        # H2 runs in the v1 phase's split case, its main path
        {"name": "H2 split-KV combine (LSE-weighted merge of span partials)",
         "route": "cuda", "source": H2_SRC, "replaces": f"{SPLITKV_PY}:330",
         **h2},
        {"name": "H6-decode paged INT8 decode attention", "route": "cuda",
         "source": H6_SRC,
         "replaces": "exploring_flash_attention_tpu/serving/decode.py:74",
         "launches": launches["h6"], "max_abs_err": h6_err, **t["h6"]},
        {"name": "H6-extend paged INT8 chunked-prefill attention",
         "route": "cuda", "source": H6E_SRC,
         "replaces": "exploring_flash_attention_tpu/serving/decode.py:257",
         "also_replaces": "exploring_flash_attention_tpu/serving/decode.py:455",
         "launches": turn2["h6e"], "max_abs_err": h6e_err, **t["h6e"]},
        # H3's numbers are the training shape's, causal as the train step
        # runs it; "none" holds them without a mask, as the encoder step
        # runs it.  plain_ms is the whole plain backward, and library_ms
        # the whole backward of scaled_dot_product_attention
        *({"name": f"H3-{n} attention backward, {what} (none, causal, "
                   "window; d 64/128)",
           "route": "cuda", "source": H3_SRC, "replaces": f"{BWD_PY}:458",
           "also_replaces": [f"{BWD_PY}:{x}" for x in (281, 377, 112, 205)],
           "launches": train[f"h3{n}"],
           "max_abs_err": h3_err["causal"][f"h3{n}"], "design": "wgmma",
           **t["h3_causal"][f"h3{n}"],
           "launches_by_path": {"train_step": train[f"h3{n}"],
                                "encoder_step": encoder[f"h3{n}"]},
           "max_abs_err_by_mask": {m: e[f"h3{n}"] for m, e in h3_err.items()},
           "none": t["h3_none"][f"h3{n}"],
           "delta_ms": {m: t[f"h3_{m}"]["delta_ms"]
                        for m in ("causal", "none")},
           "pair_ms": {m: t[f"h3_{m}"]["pair_ms"]
                       for m in ("causal", "none")}}
          for n, what in (("dkv", "dK and dV"), ("dq", "dQ"))),
        # the quant and dtiled phases: each call of the phase is one
        # launch; the numbers are those of the canonical int8 (H4-kvq),
        # pv_mode bf16 (H4-int8) and bf16 d=512 (H5) calls, and library_ms
        # of the quantized calls is SDPA over the dequantized bf16 tensors
        {"name": "H4-kvq attention over int8 / e4m3 K and V",
         "route": "cuda", "source": H4KVQ_SRC, "replaces": f"{KVQ_PY}:47",
         "also_replaces": f"{KVQ_PY}:114", "launches": kvq["launches"],
         "max_abs_err": kvq["err"], **kvq["t"]["int8"], "design": "wgmma",
         "bound_share": (kvq["t"]["int8"]["bound_ms"]
                         / kvq["t"]["int8"]["ms"]),
         "fp8": kvq["t"]["fp8"], "gates": {
             n: x for n, x in quant_gates.items() if n.startswith("kvquant")}},
        {"name": "H4-int8 attention, int8 Q, K and V (pv_mode bf16 / int8)",
         "route": "cuda", "source": H4INT8_SRC, "replaces": f"{INT8_PY}:50",
         "launches": int8["launches"], "max_abs_err": int8["err"],
         **int8["t"]["canonical bf16"], "design": "wgmma",
         "bound_share": (int8["t"]["canonical bf16"]["bound_ms"]
                         / int8["t"]["canonical bf16"]["ms"]),
         "by_case": {n: x for n, x in int8["t"].items()
                     if n != "canonical bf16"},
         "gates": {n: x for n, x in quant_gates.items()
                   if n.startswith("int8")}},
        {"name": "H5 d-tiled attention forward (bf16, int8, e4m3 K/V)",
         "route": "cuda", "source": H5_SRC, "replaces": f"{DTILED_PY}:75",
         "launches": h5["launches"], "max_abs_err": h5["err"],
         **h5["t"]["bf16"], "design": "wgmma",
         "bound_share": h5["t"]["bf16"]["bound_ms"] / h5["t"]["bf16"]["ms"],
         "by_kind": {n: x for n, x in h5["t"].items() if n != "bf16"},
         "gates": dtiled_gates},
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
