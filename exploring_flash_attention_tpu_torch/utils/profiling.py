"""Profiling and the roofline table of the port.

Counterpart of ``utils/profiling.py`` in the JAX package:

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, for Perfetto or ``chrome://tracing``) of
  what ran inside it into ``logdir``, the device's kernels included on a
  card;
- :func:`roofline_tflops`: attainable TFLOP/s of a kernel from its FLOPs
  and bytes, at the H100's published peaks by default;
- :func:`kernel_report`: times each entry with ``time_fn_chained`` and
  prints the JAX package's table of ms, TFLOP/s and roofline share.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Callable, Dict, Iterable, Tuple

import torch

from exploring_flash_attention_tpu_torch.utils.benchmark import (
    H100_HBM_GBPS,
    H100_PEAK_BF16_TFLOPS,
    time_fn_chained,
)


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(), "efa_trace")):
    """Record what runs inside the block with ``torch.profiler`` (the CPU,
    and the card where there is one) and write ``logdir/trace.json``:
    ``with trace(d) as p: run()``; the profiler is ``p.profiler`` and its
    ``key_averages()`` the per-kernel table."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities, acc_events=True)
    handle = _Trace(logdir, prof)
    prof.__enter__()
    try:
        yield handle
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(handle.path)


class _Trace(str):
    """The trace's directory (a ``str``, as the JAX package's ``trace``
    yields it), with the Chrome trace's ``path`` and the ``profiler``."""

    def __new__(cls, logdir: str, prof):
        obj = super().__new__(cls, logdir)
        obj.path = os.path.join(logdir, "trace.json")
        obj.profiler = prof
        return obj


def roofline_tflops(
    flops: int,
    bytes_moved: int,
    peak_tflops: float = H100_PEAK_BF16_TFLOPS,
    hbm_gbps: float = H100_HBM_GBPS,
) -> float:
    """Attainable TFLOP/s = min(compute peak, intensity * memory rate)."""
    intensity = flops / max(bytes_moved, 1)
    return min(peak_tflops, intensity * hbm_gbps / 1e3)


def kernel_report(
    entries: Iterable[Tuple[str, Callable[[torch.Tensor], torch.Tensor],
                            torch.Tensor, int, int]],
    file=None,
) -> Dict[str, Dict[str, float]]:
    """Time kernels and print a TFLOP/s-vs-roofline table.

    ``entries``: (name, fn, x0, flops_per_call, bytes_per_call), ``fn``
    mapping a tensor to one of its shape and dtype (see
    ``time_fn_chained``).  Returns {name: {ms, tflops, roofline_pct}}."""
    results: Dict[str, Dict[str, float]] = {}
    print(f"{'kernel':<32} {'ms':>9} {'TFLOP/s':>9} {'roofline%':>10}",
          file=file)
    for name, fn, x0, flops, nbytes in entries:
        sec = time_fn_chained(fn, x0)
        tf = flops / sec / 1e12
        roof = roofline_tflops(flops, nbytes)
        results[name] = {
            "ms": sec * 1e3,
            "tflops": tf,
            "roofline_pct": 100.0 * tf / roof,
        }
        print(f"{name:<32} {sec*1e3:>9.3f} {tf:>9.1f} "
              f"{100.0*tf/roof:>9.1f}%", file=file)
    return results
