"""Build and load the hand-written Hopper kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes).  One ``nvcc`` per source runs in parallel, then one
links the objects.  The build happens at first use, into
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources, headers and flags, so a fresh checkout builds its own kernels and
an edited source never loads a stale library.  Nothing here runs at import
time: the CPU-only test machines import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "kernels"
LIB_NAME = "libeft_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, batch, hq, hkv, lq, lkv, d, mask, diag_off, window,
    # offs, kv_span, out_f32, scale, q_rows, kmax, in_f32, device, stream
    # (offs: null, or the device int32 pair (q_pos0, kv_pos0) that replaces
    # diag_off; kmax: null, or the bound statistic's prefix maxima; in_f32:
    # f32 q/k/v, else bf16)
    "eft_prefill_attention": [_P] * 5 + [_I] * 9 + [_P] + [_I] * 2
                             + [_F, _I, _P, _I, _I, _P],
    # o_part, lse, o, n_bh, nkb, lq, d, out_f32, device, stream
    "eft_splitkv_combine": [_P] * 3 + [_I] * 6 + [_P],
    # q, pages, scales, page_table, seq_lens, slots, o_part, lse, o,
    # tickets, batch, hq, hkv, d, page_size, max_pages, max_seqs, window,
    # n_split, pages_per_split, fused, scale, q_f32, device, stream (q_f32:
    # f32 q and o, else bf16)
    "eft_paged_decode": [_P] * 10 + [_I] * 11 + [_F, _I, _I, _P],
    # q, pages, scales, page_table, seq_lens, slots, o, batch, c, hq, hkv, d,
    # page_size, max_pages, max_seqs, n_pages, window, scale, q_f32, device,
    # stream
    "eft_paged_extend": [_P] * 7 + [_I] * 10 + [_F, _I, _I, _P],
    # q, k, v, do, lse, delta, dk, dv, batch, hq, hkv, lq, lkv, d, mask,
    # diag_off, window, offs, scale, in_f32, device, stream (in_f32: f32
    # q, k, v, do and gradients, else bf16)
    "eft_attention_bwd_dkv": [_P] * 8 + [_I] * 9 + [_P, _F, _I, _I, _P],
    # q, k, v, do, lse, delta, dq, batch, hq, hkv, lq, lkv, d, mask,
    # diag_off, window, offs, scale, in_f32, device, stream (f32 at d 144
    # to 256 on both: a cluster of two blocks that split the columns)
    "eft_attention_bwd_dq": [_P] * 7 + [_I] * 9 + [_P, _F, _I, _I, _P],
    # kernel (0 H3-dkv, 1 H3-dq), device: the most clusters of H3's f32
    # D=256 instance active at once (cudaOccupancyMaxActiveClusters), or
    # minus a CUDA error
    "eft_attention_bwd_f32_clusters": [_I, _I],
    # q, k, v, ks, vs, o, batch, heads, lq, lkv, d, block, n_blocks,
    # kv_kind, out_f32, scale_log2, q_f32, device, stream (q_f32: f32 q,
    # else bf16)
    "eft_kvquant_attention": [_P] * 6 + [_I] * 9 + [_F, _I, _I, _P],
    # q, k, v, qs, ks, vs, o, batch, heads, lq, lkv, d, q_block, n_qb,
    # kv_block, n_kvb, pv_int8, out_f32, scale_log2, device, stream
    "eft_int8_attention": [_P] * 7 + [_I] * 11 + [_F, _I, _P],
    # q, k, v, ks, vs, o, batch, heads, lq, lkv, d, block, n_blocks,
    # kv_kind, out_f32, scale_log2, in_f32, cluster, nc, device, stream
    # (in_f32: f32 q, and f32 k and v where they are not codes; else bf16;
    # cluster, nc: ops.attention_v1_dtiled.h5_plan's blocks a cluster and
    # d-chunks a block)
    "eft_dtiled_attention": [_P] * 6 + [_I] * 9 + [_F] + [_I] * 4 + [_P],
    # d, in_f32, kv_kind, device: the most clusters of the H5 instance a
    # call at head dim d launches active at once
    # (cudaOccupancyMaxActiveClusters), or minus a CUDA error
    "eft_dtiled_clusters": [_I] * 4,
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """The directory of the library built from the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):          # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash is already built; return
    the library's path.  ``ptxas.log`` beside it holds nvcc's ``-Xptxas -v``
    report (registers, shared memory and spills per kernel), and
    ``nvcc_seconds.txt`` each source's compile time (:func:`nvcc_seconds`)."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()               # concurrent builds write apart
    jobs = []
    t0 = time.perf_counter()
    for src in _sources():
        obj = out / f"{src.stem}.{tag}.o"
        log = out / f"{src.stem}.{tag}.log"
        with open(log, "w") as err:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.DEVNULL, stderr=err)
        jobs.append((proc, obj, log))
    ends = {}                       # every job ends first
    while len(ends) < len(jobs):
        for i, (proc, _, _) in enumerate(jobs):
            if i not in ends and proc.poll() is not None:
                ends[i] = time.perf_counter() - t0
        time.sleep(0.05)
    codes = [proc.returncode for proc, _, _ in jobs]
    reports = [log.read_text() for _, _, log in jobs]
    for code, report in zip(codes, reports):
        if code != 0:
            raise RuntimeError(f"nvcc failed with code {code}:\n{report}")
    tmp = out / f"{LIB_NAME}.{tag}.tmp"
    res = subprocess.run(
        [_nvcc(), "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
        capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed with code {res.returncode}:\n{res.stderr}")
    (out / "ptxas.log").write_text("".join(reports))
    (out / "nvcc_seconds.txt").write_text("".join(
        f"{src.name} {ends[i]:.1f}\n" for i, src in enumerate(_sources())))
    os.replace(tmp, lib)            # atomic: concurrent builders agree
    return lib


def nvcc_seconds() -> dict:
    """Each source's compile time in seconds (wall clock, the sources
    compiled at once) in the build of the current sources."""
    text = (build().parent / "nvcc_seconds.txt").read_text()
    return {name: float(x) for name, x in
            (line.split() for line in text.splitlines())}


def ptxas_report() -> str:
    """nvcc's ``-Xptxas -v`` output of the current build."""
    return (build().parent / "ptxas.log").read_text()


def sass_by_function() -> dict:
    """The SASS of every kernel function in the current build, by its
    (mangled) name, from ``cuobjdump --dump-sass``: what the card runs, to
    check which tensor-core instructions a kernel issues (``HGMMA`` and
    ``IGMMA`` for wgmma, ``HMMA`` and ``IMMA`` for mma.sync and WMMA)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "--dump-sass", str(build())],
                         capture_output=True, text=True, check=True)
    out, name = {}, None
    for line in res.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {n: "\n".join(lines) for n, lines in out.items()}


def res_usage() -> dict:
    """``cuobjdump -res-usage`` of the current build: per kernel function
    (mangled name), its resources as ints (``REG`` registers a thread,
    ``STACK`` and ``LOCAL`` bytes a thread, where spills land, ``SHARED``
    static bytes ...)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-res-usage", str(build())],
                         capture_output=True, text=True, check=True)
    out, name = {}, None
    for line in res.stdout.splitlines():
        head = re.match(r"\s*Function (\S+):", line)
        if head:
            name = head.group(1)
        elif name is not None and "REG:" in line:
            out[name] = {k: int(x) for k, x in
                         re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line)}
            name = None
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.eft_error_string.argtypes = [ctypes.c_int]
    lib.eft_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (it then never ran)."""
    if err != 0:
        msg = library().eft_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
