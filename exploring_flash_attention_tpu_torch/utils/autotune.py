"""Runtime tile autotuner of the port.

Counterpart of ``utils/autotune.py`` in the JAX package, with its cache
protocol: the winner of a sweep is kept per (kernel, device name, shape,
Lkv, dtype) key in process (``_CACHE``) and on disk (JSON at
``$EFA_TORCH_AUTOTUNE_CACHE``, by default ``~/.cache/efa_torch_autotune.json``),
so a serving process or a training run pays the sweep once.  Failing
candidates are skipped; a sweep where every one fails raises rather than
cache an unvalidated config.

The candidates are the knobs the Hopper kernels read: H1's Q tile
(``block_q`` 64 or 128: :func:`autotune_v1`, :func:`autotune_window`) and
its KV span (``kv_tiles_per_block``: :func:`autotune_splitkv`).
``softmax`` is never swept: it changes the numbers.  H5 reads no field
(:func:`autotune_dtiled`).  The JAX package's ``autotune_decode`` and
``autotune_extend`` tune its TPU kernels' ``n_buf`` and ``q_strip``, which
H6 does not have; they are not ported.

Usage::

    cfg = autotune_v1(q, k, v)                 # best TileConfig for q/k/v
    out = flash_attention_v1(q, k, v, config=cfg)
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from exploring_flash_attention_tpu_torch.configs import (
    SplitKVConfig,
    TileConfig,
)

_CACHE: Dict[str, TileConfig] = {}
_CACHE_PATH = os.environ.get(
    "EFA_TORCH_AUTOTUNE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache",
                 "efa_torch_autotune.json"),
)


def _device_name(x: torch.Tensor) -> str:
    return (torch.cuda.get_device_name(x.device) if x.device.type == "cuda"
            else x.device.type)


def _key(kernel: str, x: torch.Tensor, lkv: int) -> str:
    """The cache key of a sweep over ``x`` (q): kernel, device name,
    shape, Lkv and dtype."""
    dtype = str(x.dtype).removeprefix("torch.")
    return f"{kernel}|{_device_name(x)}|{tuple(x.shape)}|{lkv}|{dtype}"


def _load_disk() -> Dict[str, dict]:
    try:
        with open(_CACHE_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _cfg_fields(cfg: TileConfig) -> dict:
    fields = {
        "block_q": cfg.block_q,
        "block_kv": cfg.block_kv,
        "d_tile_qk": cfg.d_tile_qk,
        "d_tile_v": cfg.d_tile_v,
        "q_chunk": cfg.q_chunk,
        "head_fold": cfg.head_fold,
    }
    if isinstance(cfg, SplitKVConfig):
        fields["kv_tiles_per_block"] = cfg.kv_tiles_per_block
    return fields


def _save_disk(key: str, cfg: TileConfig) -> None:
    data = _load_disk()
    data[key] = _cfg_fields(cfg)
    try:
        os.makedirs(os.path.dirname(_CACHE_PATH), exist_ok=True)
        with open(_CACHE_PATH, "w") as f:
            json.dump(data, f, indent=1)
    except OSError:
        pass  # read-only file system: the in-process cache still applies


def _cached(key: str, use_disk_cache: bool, cls=TileConfig):
    """The cached winner of ``key`` (in process, then on disk), or None."""
    if key in _CACHE:
        return _CACHE[key]
    if use_disk_cache:
        disk = _load_disk().get(key)
        if disk:
            cfg = cls(**disk)
            _CACHE[key] = cfg
            return cfg
    return None


def _store(key: str, cfg: TileConfig, use_disk_cache: bool) -> TileConfig:
    _CACHE[key] = cfg
    if use_disk_cache:
        _save_disk(key, cfg)
    return cfg


def _time_once(fn: Callable[[], torch.Tensor], x: torch.Tensor,
               iters: int) -> float:
    """Seconds of one call of ``fn``: on a CUDA tensor the median of
    ``time_cuda``'s event timings over ``max(iters, 5)`` calls, on the CPU
    the median over 3 runs of ``iters`` calls on ``time.perf_counter``."""
    if x.device.type == "cuda":
        from exploring_flash_attention_tpu_torch.utils.benchmark import (
            time_cuda,
        )
        return time_cuda(fn, n_iter=max(iters, 5), n_warmup=2) / 1e3
    fn()                                                # warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters)
    return statistics.median(times)


def _sweep_best(cands, run_cfg, x: torch.Tensor, iters: int):
    """Time every candidate and return the fastest (None if all fail)."""
    best, best_t = None, float("inf")
    for cfg in cands:
        try:
            t = _time_once(lambda cfg=cfg: run_cfg(cfg), x, iters)
        except Exception:  # noqa: BLE001 - a shape the kernel refuses
            continue
        if t < best_t:
            best, best_t = cfg, t
    return best


def default_candidates_v1(
    lq: int, lkv: int, d: int, causal: bool = False,
) -> List[TileConfig]:
    """H1's two Q tiles at this shape: ``block_q`` 64 (one consumer
    warpgroup, twice the blocks) and 128 (two warpgroups), 128-key
    tiles."""
    return [TileConfig(block_q=64, block_kv=128),
            TileConfig(block_q=128, block_kv=128)]


def autotune_v1(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    candidates: Optional[Sequence[TileConfig]] = None,
    iters: int = 8,
    causal: bool = False,
    use_disk_cache: bool = True,
) -> TileConfig:
    """The fastest TileConfig for ``flash_attention_v1`` on these operands,
    measured on their device and cached per shape and dtype.  Each
    candidate is timed by ``time_fn_chained`` (q := the last output), as
    the JAX package's is."""
    from exploring_flash_attention_tpu_torch.ops import flash_attention_v1
    from exploring_flash_attention_tpu_torch.utils.benchmark import (
        time_fn_chained,
    )

    key = _key("v1" + ("c" if causal else ""), q, k.shape[2])
    hit = _cached(key, use_disk_cache)
    if hit is not None:
        return hit
    cands = list(candidates or default_candidates_v1(
        q.shape[2], k.shape[2], q.shape[3], causal=causal))
    best, best_t = None, float("inf")
    for cfg in cands:
        try:
            t = time_fn_chained(
                lambda x, kk, vv, cfg=cfg: flash_attention_v1(
                    x, kk, vv, config=cfg, causal=causal),
                q, k, v, n_long=max(iters, 8), n_short=2, reps=3,
            )
        except Exception:  # noqa: BLE001 - a shape the kernel refuses
            continue
        if t < best_t:
            best, best_t = cfg, t
    if best is None:
        raise RuntimeError(
            f"autotune_v1: every candidate config failed for {key}; "
            "not caching an unvalidated config")
    return _store(key, best, use_disk_cache)


def default_candidates_dtiled(
    lq: int, lkv: int, d: int, quant_block: Optional[int] = None,
) -> List[TileConfig]:
    """The JAX package's candidate geometries for its d-tiled kernel
    (``block_kv`` pinned to the quant block of quantized K/V).  H5 reads
    none of their fields."""
    bk_opts = (quant_block,) if quant_block is not None else (256, 512)
    cands = []
    for bq in (512, 1024):
        for bk in bk_opts:
            for dt in (128, 256):
                if d % dt or bq > lq or bk > lkv:
                    continue
                cands.append(TileConfig(block_q=bq, block_kv=bk,
                                        d_tile_qk=dt, d_tile_v=dt))
    if not cands:
        cands.append(TileConfig(
            block_q=min(256, max(lq, 8)),
            block_kv=(quant_block if quant_block is not None
                      else min(256, max(lkv, 8))),
            d_tile_qk=min(d, 128),
            d_tile_v=min(d, 128)))
    return cands


def autotune_dtiled(
    q: torch.Tensor,
    k,
    v,
    candidates: Optional[Sequence[TileConfig]] = None,
    iters: int = 8,
    use_disk_cache: bool = True,
) -> TileConfig:
    """A TileConfig for ``flash_attention_v1_dtiled`` (k/v may be
    QuantizedTensor), cached as the other tuners' winners are.

    H5 fixes its own tiles from d (64 Q rows, 64-key tiles, 32 at f32,
    128-column d chunks) and reads no field of the config, so every candidate runs the
    same kernel and timing them would rank noise: this returns the first
    candidate that runs (``iters`` is taken for the JAX signature and not
    read).  The key keeps quantized K/V apart from bf16, as JAX's does."""
    from exploring_flash_attention_tpu_torch.ops import (
        QuantizedTensor,
        flash_attention_v1_dtiled,
    )

    quantized = isinstance(k, QuantizedTensor)
    k_arr = k.values if quantized else k
    quant_block = k.block if quantized else None
    kv_tag = f"{str(k_arr.dtype).removeprefix('torch.')}:{quant_block}"
    key = _key(f"dtiled[{kv_tag}]", q, k_arr.shape[2])
    hit = _cached(key, use_disk_cache)
    if hit is not None:
        return hit
    cands = list(candidates or default_candidates_dtiled(
        q.shape[2], k_arr.shape[2], q.shape[3], quant_block=quant_block))
    for cfg in cands:
        try:
            flash_attention_v1_dtiled(q, k, v, config=cfg)
        except Exception:  # noqa: BLE001 - a shape the kernel refuses
            continue
        return _store(key, cfg, use_disk_cache)
    raise RuntimeError(f"autotune_dtiled: every candidate failed ({key})")


def autotune_splitkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    iters: int = 8,
    causal: bool = False,
    use_disk_cache: bool = True,
) -> SplitKVConfig:
    """The fastest SplitKVConfig for the ``flash_attention_v2`` pair: the
    span, ``kv_tiles_per_block`` 128-key tiles (1 to 16, at most the KV),
    which fixes how many H1 blocks a row's KV feeds and H2's merge
    depth."""
    from exploring_flash_attention_tpu_torch.ops import flash_attention_v2

    key = _key("v2" + ("c" if causal else ""), q, k.shape[2])
    hit = _cached(key, use_disk_cache, SplitKVConfig)
    if hit is not None:
        return hit
    lkv = k.shape[2]
    cands = [SplitKVConfig(block_q=128, block_kv=128,
                           kv_tiles_per_block=tiles)
             for tiles in (1, 2, 4, 8, 16)
             if tiles == 1 or tiles * 128 <= lkv]
    best = _sweep_best(
        cands,
        lambda cfg: flash_attention_v2(q, k, v, config=cfg, causal=causal),
        q, iters)
    if best is None:
        raise RuntimeError(f"autotune_splitkv: every candidate failed ({key})")
    return _store(key, best, use_disk_cache)


def autotune_window(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    iters: int = 8,
    use_disk_cache: bool = True,
) -> TileConfig:
    """The fastest TileConfig for the causal sliding-window call of
    ``flash_attention_v1``: H1's Q tile, ``block_q`` 64 or 128."""
    from exploring_flash_attention_tpu_torch.ops import flash_attention_v1

    key = _key(f"v1w{window}", q, k.shape[2])
    hit = _cached(key, use_disk_cache)
    if hit is not None:
        return hit
    best = _sweep_best(
        default_candidates_v1(q.shape[2], k.shape[2], q.shape[3], True),
        lambda cfg: flash_attention_v1(q, k, v, config=cfg, causal=True,
                                       window=window),
        q, iters)
    if best is None:
        raise RuntimeError(f"autotune_window: every candidate failed ({key})")
    return _store(key, best, use_disk_cache)
