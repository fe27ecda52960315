"""Kernel timing: CUDA events on the card, ``time.perf_counter`` on the
CPU.

Counterpart of ``utils/benchmark.py`` in the JAX package.  :func:`time_cuda`
times one call with events recorded on the stream around it.
:func:`time_fn_chained` and :func:`time_fn_chained_windows` keep the JAX
package's protocol and signatures: a chain of ``x -> fn(x, *extra)`` calls,
each fed the last one's output, timed at a long and a short length, the
minimum of each taken and the difference divided by the length difference,
so that a constant cost per chain (a graph's launch, a final
synchronisation) drops out.  On the card a chain is one CUDA graph of its
calls (``graphs.StepGraph``), as the JAX package's is one ``jax.jit``
around a ``lax.scan``, so the host's time between calls is not timed.  The roofline helpers take the H100's published
peaks (SXM data sheet, dense, without sparsity) as their defaults.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List

import torch

# NVIDIA H100 SXM, published dense peaks at its 700 W limit
H100_PEAK_BF16_TFLOPS = 989.0
H100_HBM_GBPS = 3350.0

# more than the H100's 50 MB L2, so writing it evicts everything
L2_FLUSH_BYTES = 128 << 20
# a spin kernel of this many cycles (~0.15 ms) runs between the flush and
# each timed call, so that the host has queued the call's kernels before
# the start event is reached: a wrapper's Python that outlasts the flush
# would otherwise leave the card idle inside the timed window
HOST_LEAD_CYCLES = 250_000


def time_cuda(fn: Callable[[], object], n_iter: int = 50,
              n_warmup: int = 5, flush_l2: bool = True) -> float:
    """Median device milliseconds of one call of ``fn`` over ``n_iter``
    calls, after ``n_warmup`` untimed ones.  The L2 cache is flushed before
    every timed call (unless ``flush_l2`` is False), because the decode
    step finds its KV cache cold (the other layers' weights pass through
    L2 in between); the flush writes, so the call also writes back the
    dirty lines it evicts.  The host's time before the call's first launch
    is kept out of the window; its time between two launches of one call
    is not.  Raises where there is no card: a timing taken on the CPU is
    not a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(n_warmup):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n_iter)]
    for start, end in events:
        if flush_l2:
            flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _chain_timer(fn: Callable, x0: torch.Tensor, extra,
                 n: int) -> Callable[[], float]:
    """A timer of ``n`` chained calls, returning seconds: on a CUDA tensor
    one replay of a CUDA graph of the chain between CUDA events (the chain
    is captured once, after one eager call has built its kernels), else
    the calls themselves on the host's ``time.perf_counter``."""
    def chain():
        x = x0
        for _ in range(n):
            x = fn(x, *extra)
        return x

    if x0.device.type != "cuda":
        def run_host() -> float:
            t0 = time.perf_counter()
            chain()
            return time.perf_counter() - t0
        return run_host
    from exploring_flash_attention_tpu_torch.graphs import StepGraph

    fn(x0, *extra)
    torch.cuda.synchronize(x0.device)
    graph = StepGraph(chain, x0.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run_graph() -> float:
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(x0.device)
        return start.elapsed_time(end) / 1e3
    return run_graph


def time_fn_chained(
    fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    *extra: torch.Tensor,
    n_long: int = 24,
    n_short: int = 4,
    reps: int = 4,
) -> float:
    """Per-iteration seconds of ``x -> fn(x, *extra)`` chained: ``fn``
    maps a tensor to one of the same shape and dtype (attention with q :=
    its output does), which makes each call wait for the last.  Each chain
    length is timed ``reps`` times and the minima are differenced, as the
    JAX package's ``time_fn_chained`` does: one-sided noise (a host pause)
    only ever inflates a reading."""
    return time_fn_chained_windows(
        fn, x0, *extra, n_long=n_long, n_short=n_short, reps=reps,
        windows=1,
    )[0]


def time_fn_chained_windows(
    fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    *extra: torch.Tensor,
    n_long: int = 24,
    n_short: int = 4,
    reps: int = 4,
    windows: int = 1,
    target_long_sec: float = 0.2,
    n_long_cap: int = 192,
) -> List[float]:
    """``windows`` independent :func:`time_fn_chained` readings after one
    calibration, the JAX package's protocol: the long chain is stretched
    (never below ``n_long``, at most ``n_long_cap``) until one long chain
    spans about ``target_long_sec``, then refined by differencing, growing
    geometrically while the difference carries no signal (at most 4096
    calls), so that a cost per chain that dwarfs the work cannot make the
    difference zero or negative.  On the card each length is one CUDA
    graph; the chain's kernels are each counted once per replay."""
    x0 = x0.detach()
    run_short = _chain_timer(fn, x0, extra, n_short)
    run_short()                                         # warm
    t_short = min(run_short() for _ in range(2))
    per_iter_est = t_short / n_short
    if per_iter_est > 0:
        n_long = max(n_long, min(n_long_cap, max(
            2 * n_short, int(target_long_sec / per_iter_est))))
    run_long = _chain_timer(fn, x0, extra, n_long)
    run_long()                                          # warm
    for _ in range(4):
        if n_long <= n_short or n_long >= 4096:
            break
        t_long = min(run_long() for _ in range(2))
        diff = t_long - t_short
        if diff >= 0.5 * target_long_sec:
            break
        if diff > 0:
            per_iter = diff / (n_long - n_short)
            n_better = min(4096, max(n_long * 2,
                                     int(target_long_sec / per_iter)))
        else:
            n_better = min(4096, n_long * 4)
        if n_better <= n_long:
            break
        n_long = n_better
        run_long = _chain_timer(fn, x0, extra, n_long)
        run_long()                                      # warm
    out = []
    for _ in range(windows):
        shorts, longs = [], []
        for _ in range(reps):
            shorts.append(run_short())
            longs.append(run_long())
        out.append((min(longs) - min(shorts)) / (n_long - n_short))
    return out


def attention_flops(b: int, h: int, lq: int, lkv: int, d: int,
                    causal: bool = False) -> int:
    """Forward attention FLOPs: two products of 2 Lq Lkv d each per (b, h),
    half of them under a causal mask (the JAX package's count)."""
    f = 4 * b * h * lq * lkv * d
    return f // 2 if causal else f


def roofline_attention_tflops(
    b: int, h: int, l: int, d: int,
    dtype_bytes: int = 2,
    peak_tflops: float = H100_PEAK_BF16_TFLOPS,
    hbm_gbps: float = H100_HBM_GBPS,
) -> float:
    """Attainable TFLOP/s of the attention forward on one card: the lesser
    of the compute peak and the intensity times the memory rate, with Q, K,
    V and O moved once each."""
    flops = attention_flops(b, h, l, l, d)
    bytes_moved = 4 * b * h * l * d * dtype_bytes
    intensity = flops / bytes_moved
    return min(peak_tflops, intensity * hbm_gbps / 1e3)
