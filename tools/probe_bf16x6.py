"""Probe f32 products on bf16 wgmma by three-piece splits, on the card.

    python tools/probe_bf16x6.py

Builds ``probe_bf16x6.cu`` (beside this file) with nvcc into
``build/probe/`` and runs its two one-block kernels on standard-normal
f32 inputs from ``np.random.default_rng(0)`` at d=128: S = Q K^T over 64
keys and O = P V over 64 to 1024 keys (P = exp(scale * S - max) of an f64
S, V standard normal), each with 1 (the bf16 control), 3 (bf16x3) and 6
(bf16x6, Mosaic's HIGHEST) piece products in one wgmma accumulator.  For
each it prints max|dS| against the f64 product, and the max|dO| each
product's error alone gives attention's normalized O (softmax(scale * S)
V, or P V / l, the rest in f64), against the JAX package's f32 tiers:
1e-5 (``bench/suite.py:105-133``) and 2e-5 (``tests/test_attention_v1.py:
24-27``).  One block, synchronized: the numbers are accuracy, not time.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE.parent / "build" / "probe"
D, ROWS = 128, 64


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libprobe_bf16x6.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib), str(HERE / "probe_bf16x6.cu")],
                   check=True)
    so = ctypes.CDLL(str(lib))
    so.probe_qk.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    so.probe_pv.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    return so


def softmax_o(s, v, scale):
    """Normalized attention O in f64 from scores s [R, N] and v [N, d]."""
    z = s * scale
    p = np.exp(z - z.max(axis=1, keepdims=True))
    return (p @ v) / p.sum(axis=1, keepdims=True)


def main() -> None:
    import torch

    so = build()
    rng = np.random.default_rng(0)
    scale = 1.0 / math.sqrt(D)
    q = rng.standard_normal((ROWS, D)).astype(np.float32)
    k = rng.standard_normal((1024, D)).astype(np.float32)
    v = rng.standard_normal((1024, D)).astype(np.float32)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()  # noqa: E731

    s64 = q.astype(np.float64) @ k[:ROWS].astype(np.float64).T
    o_ref = softmax_o(s64, v[:ROWS].astype(np.float64), scale)
    qd, kd = dev(q), dev(k[:ROWS])          # held for the launches
    for terms in (1, 3, 6):
        s = torch.zeros(ROWS, ROWS, device="cuda")
        err = so.probe_qk(qd.data_ptr(), kd.data_ptr(), s.data_ptr(), terms)
        assert err == 0, f"probe_qk: CUDA error {err}"
        s_k = s.cpu().numpy().astype(np.float64)
        o_s = softmax_o(s_k, v[:ROWS].astype(np.float64), scale)
        print(f"S = Q K^T, 64 keys, d={D}, {terms} piece product(s): "
              f"max|dS| {np.abs(s_k - s64).max():.3e}, "
              f"max|dO| from S alone {np.abs(o_s - o_ref).max():.3e}")

    for keys in (64, 256, 1024):
        sf = q.astype(np.float64) @ k[:keys].astype(np.float64).T * scale
        p = np.exp(sf - sf.max(axis=1, keepdims=True))
        l_row = p.sum(axis=1, keepdims=True)
        o_ref = (p @ v[:keys].astype(np.float64)) / l_row
        pd, vd = dev(p.astype(np.float32)), dev(v[:keys])
        for terms in (1, 3, 6):
            o = torch.zeros(ROWS, D, device="cuda")
            err = so.probe_pv(pd.data_ptr(), vd.data_ptr(), o.data_ptr(),
                              keys, terms)
            assert err == 0, f"probe_pv: CUDA error {err}"
            o_k = o.cpu().numpy().astype(np.float64) / l_row
            print(f"O = P V, {keys} keys, d={D}, {terms} piece product(s): "
                  f"max|dO| {np.abs(o_k - o_ref).max():.3e}")


if __name__ == "__main__":
    main()
