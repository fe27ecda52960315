"""Float64 attention oracle and accuracy harness, in NumPy only.

Counterpart of ``exploring_flash_attention_tpu/oracle/reference.py``.  It
imports neither JAX nor a GPU library, so it can referee the CUDA kernels
on the card's machine.  Tolerance tiers are the JAX package's: max_abs
1e-2, filtered max_rel 0.5 where |ref| > 1e-3, mean_rel 0.05.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _f64(x) -> np.ndarray:
    """A tensor or array as float64 NumPy (torch tensors go through the
    host; bf16 goes through f32, which is exact)."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def naive_attention(q, k, v, scale: Optional[float] = None,
                    causal: bool = False, window: Optional[int] = None,
                    return_lse: bool = False):
    """Materialized-scores attention in float64 over [..., L, d] inputs.

    Causal uses the decode convention: the q rows are the LAST Lq
    positions, so row i sees keys j <= i + (Lkv - Lq).  ``window`` (causal
    only) keeps each row's last ``window`` positions, its own included:
    j >= i + (Lkv - Lq) - window + 1.  A row that sees no key gives O = 0
    and LSE = -inf.  ``return_lse`` also returns the natural-log row LSE
    of the scaled scores."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    q64, k64, v64 = _f64(q), _f64(k), _f64(v)
    if scale is None:
        scale = 1.0 / math.sqrt(q64.shape[-1])
    scores = np.einsum("...qd,...kd->...qk", q64, k64) * scale
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        mask = np.tril(np.ones((lq, lk), dtype=bool), k=lk - lq)
        if window is not None:
            mask &= ~np.tril(np.ones((lq, lk), dtype=bool),
                             k=lk - lq - window)
        scores = np.where(mask, scores, -np.inf)
    m = scores.max(axis=-1, keepdims=True)
    m = np.where(np.isneginf(m), 0.0, m)
    weights = np.exp(scores - m)
    denom = weights.sum(axis=-1, keepdims=True)
    safe = np.where(denom == 0.0, 1.0, denom)
    out = np.einsum("...qk,...kd->...qd", weights / safe, v64)
    if not return_lse:
        return out
    with np.errstate(divide="ignore"):
        lse = np.where(denom[..., 0] == 0.0, -np.inf,
                       m[..., 0] + np.log(safe[..., 0]))
    return out, lse


class AccuracyError(AssertionError):
    """Raised when an implementation drifts beyond tolerance vs the oracle."""


def error_stats(out, ref, rel_floor: float = 1e-3) -> dict:
    """max-abs / filtered max-rel / mean-rel error triple (relative error
    only where |ref| > rel_floor), and where the largest absolute error
    lies (``worst_index``, ``worst_out``, ``worst_ref``)."""
    out64, ref64 = _f64(out), _f64(ref)
    if out64.shape != ref64.shape:
        raise ValueError(f"shape mismatch: {out64.shape} vs {ref64.shape}")
    abs_err = np.abs(out64 - ref64)
    max_abs = float(abs_err.max()) if abs_err.size else 0.0
    mask = np.abs(ref64) > rel_floor
    if mask.any():
        rel = abs_err[mask] / np.abs(ref64[mask])
        max_rel, mean_rel = float(rel.max()), float(rel.mean())
    else:
        max_rel = mean_rel = 0.0
    worst = (np.unravel_index(int(abs_err.argmax()), abs_err.shape)
             if abs_err.size else ())
    return {"max_abs": max_abs, "max_rel": max_rel, "mean_rel": mean_rel,
            "worst_index": worst,
            "worst_out": float(out64[worst]) if abs_err.size else 0.0,
            "worst_ref": float(ref64[worst]) if abs_err.size else 0.0}


def check_accuracy(out, ref, name: str = "impl", max_abs_tol: float = 1e-2,
                   max_rel_tol: float = 0.5, mean_rel_tol: float = 0.05,
                   rel_floor: float = 1e-3) -> dict:
    """Raise :class:`AccuracyError` if ``out`` drifts beyond tolerance of
    ``ref``; return the error stats otherwise."""
    stats = error_stats(out, ref, rel_floor=rel_floor)
    failures = []
    if stats["max_abs"] > max_abs_tol:
        failures.append(f"max_abs {stats['max_abs']:.3e} > {max_abs_tol:.1e}")
    if stats["max_rel"] > max_rel_tol:
        failures.append(f"max_rel {stats['max_rel']:.3e} > {max_rel_tol:.1e}")
    if stats["mean_rel"] > mean_rel_tol:
        failures.append(
            f"mean_rel {stats['mean_rel']:.3e} > {mean_rel_tol:.1e}")
    if failures:
        raise AccuracyError(f"{name}: accuracy check failed: "
                            + "; ".join(failures))
    return stats


def print_comparison(out, ref, name: str = "impl",
                     rel_floor: float = 1e-3) -> None:
    """Print the error report of ``out`` against ``ref``, as the JAX
    package's ``print_comparison`` does."""
    stats = error_stats(out, ref, rel_floor=rel_floor)
    print(f"--- {name} vs oracle ---")
    print(f"  max abs err : {stats['max_abs']:.6e}")
    print(f"  max rel err : {stats['max_rel']:.6e}  (|ref| > {rel_floor:g})")
    print(f"  mean rel err: {stats['mean_rel']:.6e}")
    print(f"  worst @ {stats['worst_index']}: out={stats['worst_out']:.6f} "
          f"ref={stats['worst_ref']:.6f}")


def make_qkv(batch: int, heads: int, seq_len: int, head_dim: int,
             dtype=np.float32, seed: int = 0,
             seq_len_kv: Optional[int] = None,
             heads_kv: Optional[int] = None):
    """Seeded standard-normal q, k, v in the [B, H, L, d] layout, drawn as
    the JAX package's ``oracle/reference.py:make_qkv`` draws them (the same
    arrays for the same arguments).  ``heads_kv`` gives k and v fewer heads
    (GQA)."""
    rng = np.random.default_rng(seed)
    lkv = seq_len if seq_len_kv is None else seq_len_kv
    hkv = heads if heads_kv is None else heads_kv
    q = rng.standard_normal((batch, heads, seq_len, head_dim)).astype(dtype)
    k = rng.standard_normal((batch, hkv, lkv, head_dim)).astype(dtype)
    v = rng.standard_normal((batch, hkv, lkv, head_dim)).astype(dtype)
    return q, k, v
