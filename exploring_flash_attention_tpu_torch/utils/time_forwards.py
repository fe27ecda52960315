"""Time the quantized and d-tiled forwards, the backward pair, or the
split-KV merges, on the card, for A/B runs.

    python exploring_flash_attention_tpu_torch/utils/time_forwards.py [ROOT]
        [--bwd | --bwd-heads | --merge | --serve | --f32 | --clusters |
         --heads | --quant-heads]

ROOT (default: this checkout) is the root of a checkout of the port, for
example a ``git archive`` of another commit unpacked under ``build/``; its
package and kernels are the ones timed.  Prints one line: the CUDA-event
median milliseconds (L2 flushed before each call) of
``flash_attention_kvquant`` at the canonical shape (B=32, H=8, L=1024,
d=128, int8 and e4m3 K/V, block 512) and at d=64 (int8), of
``flash_attention_int8`` at the canonical shape (Q, K and V in blocks of
512, both ``pv_mode``s) and of ``flash_attention_v1_dtiled`` at d=512
(B=4, H=8, L=1024; int8, e4m3 and bf16 K/V), inputs from
``make_qkv(seed=1)`` rounded to bf16; with ``--bwd``, of H3-dkv and H3-dq
alone at the training shape (B=8, Hq=8, Hkv=4, L=1024, d=128), causal and
without a mask, at d=64 causal, and at the ring hops of 256 and 8192 rows
(diagonal and past; ``BWD_CASES``); with ``--bwd-heads``, of H3-dkv
and H3-dq alone, causal, at d 80, 128 and 256 in bf16 and f32 at the
models' training shapes (``BWD_HEADS_CASES``); with ``--merge``, of H2
(``splitkv_combine``, bf16 O) on random f32 partials at the v1 split case
(8192 rows of 2 partials, d=128), at the slice's decode merge (64 rows of
8), at one long sequence's (8 rows of 64) and on 8 rows of 2 (what any
launch costs in this harness), each with L2 flushed (``time_cuda``) and
warm, then of ``paged_decode_attention`` and the kernel without its merge
(``paged_decode_partials``; a root without the fused kernel runs its H2
after it) at the slice's shape (B=8, Hq=8, Hkv=4, contexts 257..280) and at
B=1 over 8100 tokens (64 runs); with ``--serve``, of the serving kernels at
the flagship's shapes (``time_serve``); with ``--f32``, of the f32 core's
kernels and H5 at f32, and their accuracy over long key counts
(``time_f32``); with ``--clusters``, of H5's cluster launches beside its
single-block launches on the same work a block (``time_clusters``); with
``--heads``, of H1, H6-decode and H6-extend at d 80 and 128
(``time_heads``); with ``--quant-heads``, of H4-kvq, H4-int8 and H5 at d
80, 128 and 256 (``time_quant_heads``).
Alternate two roots in one call (parent, change, change, parent) to
compare them on one card.
"""

from __future__ import annotations

import sys
from pathlib import Path


# H3's A/B cases at the tuned instances (D = d = 64 and 128): (label, B,
# Hq, Hkv, L, d, causal, diag_off).  The training shape, causal and
# without a mask, the same at d=64, and the ring hops of 256 and 8192 rows
# a rank (a 4-rank ring at B=8 L=1024 and B=1 L=32768): the diagonal hop
# and a past hop, every key visible
BWD_CASES = (("train causal", 8, 8, 4, 1024, 128, True, 0),
             ("train none", 8, 8, 4, 1024, 128, False, 0),
             ("train d=64 causal", 8, 8, 4, 1024, 64, True, 0),
             ("hop 256 diagonal", 8, 8, 4, 256, 128, True, 0),
             ("hop 256 past", 8, 8, 4, 256, 128, True, 256),
             ("hop 8192 diagonal", 1, 8, 4, 8192, 128, True, 0),
             ("hop 8192 past", 1, 8, 4, 8192, 128, True, 8192))


def time_bwd(root: Path) -> str:
    """H3-dkv and H3-dq alone at each of BWD_CASES (static offsets)."""
    import math

    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    out = []
    for label, b, hq, hkv, l, d, causal, diag in BWD_CASES:
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in make_qkv(b, hq, l, d, seed=1, heads_kv=hkv))
        do = torch.from_numpy(make_qkv(b, hq, l, d, seed=2)[0]).to(
            "cuda", torch.bfloat16)
        scale = 1.0 / math.sqrt(d)
        o, lse = prefill_attention(q, k, v, scale, diag, causal)
        delta = (do.float() * o.float()).sum(dim=-1)
        for name, fn in (("H3-dkv", attention_bwd_dkv),
                         ("H3-dq", attention_bwd_dq)):
            ms = time_cuda(lambda: fn(q, k, v, do, lse, delta, scale, causal,
                                      diag), n_iter=30)
            out.append(f"{name} {label} {ms:.4f} ms")
    return f"{root.name or root}: " + " | ".join(out)


# H3 at the multiples of 16 the models train at, each dtype: (label, B,
# Hq, Hkv, L, d), causal, the heads models' and the flagship's training
# shapes (heads80g16, the flagship, heads256)
BWD_HEADS_CASES = (("d=80 heads80g16", 8, 16, 1, 1024, 80),
                   ("d=128 flagship", 8, 8, 4, 1024, 128),
                   ("d=256 heads256", 8, 4, 1, 1024, 256))


def time_bwd_heads(root: Path) -> str:
    """H3-dkv and H3-dq alone, causal, at each of BWD_HEADS_CASES in bf16
    and f32 (static offsets; inputs from make_qkv, dO from the next
    seed)."""
    import math

    import numpy as np
    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, hq, hkv, l, d in BWD_HEADS_CASES:
            q, k, v = (torch.from_numpy(x).to("cuda", dtype) for x in
                       make_qkv(b, hq, l, d, dtype=np.float32, seed=1,
                                heads_kv=hkv))
            do = torch.from_numpy(make_qkv(b, hq, l, d, dtype=np.float32,
                                           seed=2)[0]).to("cuda", dtype)
            scale = 1.0 / math.sqrt(d)
            o, lse = prefill_attention(q, k, v, scale, 0, True)
            delta = (do.float() * o.float()).sum(dim=-1)
            for name, fn in (("H3-dkv", attention_bwd_dkv),
                             ("H3-dq", attention_bwd_dq)):
                ms = time_cuda(lambda: fn(q, k, v, do, lse, delta, scale,
                                          True, 0), n_iter=30)
                kind = "bf16" if dtype == torch.bfloat16 else "f32"
                out.append(f"{name} {kind} {label} {ms:.4f} ms")
            del q, k, v, do, o, lse, delta
    return f"{root.name or root}: " + " | ".join(out)


def _paged_case(b, hq, hkv, lens, max_len, seed=1, ps=128, chunk=0, d=128):
    """A cache of ``max_len`` tokens a slot with a permuted page table
    (page size ``ps``, head dim ``d``), sequences of ``lens`` tokens of
    random K/V, and one bf16 q [B, Hq, d]; with ``chunk`` = C, C more
    tokens a sequence appended after them and q [B, C, Hq, d]."""
    import numpy as np
    import torch

    from exploring_flash_attention_tpu_torch.serving import (
        append_chunks,
        append_prompts,
        make_cache,
    )

    gen = torch.Generator().manual_seed(seed)
    pages = -(-max_len // ps)
    cache = make_cache(hkv, d, b * pages, page_size=ps, max_seqs=b,
                       max_pages_per_seq=pages, device="cuda")
    cache.page_table.copy_(torch.randperm(b * pages, generator=gen)
                           .view(b, pages).to(torch.int32))
    slots = torch.arange(b, dtype=torch.int32, device="cuda")
    for s, n in enumerate(np.linspace(*lens, b).round().astype(int)):
        k, v = (torch.randn(1, int(n), hkv, d, generator=gen).to("cuda")
                for _ in range(2))
        append_prompts(cache, slots[s:s + 1], k, v)
    if chunk:
        k, v = (torch.randn(b, chunk, hkv, d, generator=gen).to("cuda")
                for _ in range(2))
        append_chunks(cache, slots, k, v)
    shape = (b, chunk, hq, d) if chunk else (b, hq, d)
    q = torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)
    return q, cache, slots


def _harness_time_cuda():
    """``time_cuda`` of this file's checkout (``benchmark.py`` beside it),
    so that both roots of an A/B are timed alike."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_eft_benchmark", Path(__file__).with_name("benchmark.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.time_cuda


def time_merge(root: Path) -> str:
    """H2 by shape, flushed and warm; the decode call and the kernel
    without its merge.  The timing harness is this file's checkout's."""
    import torch

    from exploring_flash_attention_tpu_torch.ops import splitkv_combine
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
        paged_decode_partials,
    )

    time_cuda = _harness_time_cuda()
    gen = torch.Generator().manual_seed(0)
    out = []
    for name, shape in (("v1 split", (1, 8, 2, 1024, 128)),
                        ("slice merge", (8, 8, 8, 1, 128)),
                        ("long merge", (1, 8, 64, 1, 128)),
                        ("8 rows", (1, 1, 2, 8, 128))):
        o_p = torch.randn(*shape, generator=gen).to("cuda")
        lse = (3 * torch.randn(*shape[:4], generator=gen)).to("cuda")
        ms = [time_cuda(lambda: splitkv_combine(o_p, lse, out_dtype=torch.bfloat16),
                        n_iter=100, flush_l2=f) for f in (True, False)]
        out.append(f"H2 {name} {ms[0]:.4f} / warm {ms[1]:.4f} ms")
    for name, b, lens, max_len in (("slice", 8, (257, 280), 1024),
                                   ("B=1 8100", 1, (8100, 8100), 8192)):
        q, cache, slots = _paged_case(b, 8, 4, lens, max_len)
        call = lambda: paged_decode_attention(q, cache, slots)  # noqa: E731
        alone = lambda: paged_decode_partials(q, cache, slots)  # noqa: E731
        ms = [time_cuda(fn, n_iter=100) for fn in (call, alone, call, alone)]
        out.append(f"decode {name} call {(ms[0] + ms[2]) / 2:.4f} ms, "
                   f"kernel without its merge {(ms[1] + ms[3]) / 2:.4f} ms")
    return f"{root.name or root}: " + " | ".join(out)


def time_serve(root: Path) -> str:
    """The serving kernels at the flagship's shapes, L2 flushed, with this
    file's timing harness: H1 through ``flash_attention_v1`` at bench.py's
    canonical shape (B=32, H=8, L=1024, d=128, no mask) and causal at the
    generation prefill (B=8, Hq=8, Hkv=4, L=256);
    ``paged_decode_attention`` at the slice (B=8, Hq=8, Hkv=4, contexts
    257..280), at the JAX suite's decode entry (B=32, Hq=Hkv=8, page size
    256, 2048 tokens) and at B=1 over 8100 tokens;
    ``paged_extend_attention`` at the multi-turn turn (C=256 after
    257..280)."""
    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import flash_attention_v1
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
        paged_extend_attention,
    )

    time_cuda = _harness_time_cuda()
    out = []
    for name, b, hq, hkv, l, causal in (("canonical", 32, 8, 8, 1024, False),
                                        ("prefill", 8, 8, 4, 256, True)):
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in make_qkv(b, hq, l, 128, seed=1, heads_kv=hkv))
        ms = time_cuda(lambda: flash_attention_v1(q, k, v, causal=causal),
                       n_iter=30)
        out.append(f"H1 {name} {ms:.4f} ms")
        del q, k, v
    for name, b, hq, hkv, lens, max_len, ps in (
            ("slice", 8, 8, 4, (257, 280), 1024, 128),
            ("suite", 32, 8, 8, (2048, 2048), 2048, 256),
            ("B=1 8100", 1, 8, 4, (8100, 8100), 8192, 128)):
        q, cache, slots = _paged_case(b, hq, hkv, lens, max_len, ps=ps)
        ms = time_cuda(lambda: paged_decode_attention(q, cache, slots),
                       n_iter=100)
        out.append(f"decode {name} {ms:.4f} ms")
    q, cache, slots = _paged_case(8, 8, 4, (257, 280), 1024, chunk=256)
    ms = time_cuda(lambda: paged_extend_attention(q, cache, slots),
                   n_iter=50)
    out.append(f"extend multi-turn {ms:.4f} ms")
    return f"{root.name or root}: " + " | ".join(out)


# the serving kernels at head dims both sides of an A/B take (d 80, the
# D=128 instance's zero-filled columns, and the flagship's 128): H1 (label,
# B, Hq, Hkv, L, d, causal), and the paged pair (label, B, Hq, Hkv, d, page
# size), contexts 257..1100, a 64-token chunk after them for H6-extend
HEADS_H1 = (("H1 d=80", 32, 16, 16, 1024, 80, False),
            ("H1 d=80 causal", 32, 16, 16, 1024, 80, True),
            ("H1 d=128", 32, 16, 16, 1024, 128, False),
            ("H1 d=128 causal", 32, 16, 16, 1024, 128, True))
HEADS_PAGED = (("d=80 G=16", 8, 16, 1, 80, 128),
               ("d=128 G=2", 8, 8, 4, 128, 128))


def time_heads(root: Path) -> str:
    """The serving kernels at d 80 and 128 (HEADS_H1, HEADS_PAGED), L2
    flushed, with this file's timing harness: H1 alone
    (``prefill_attention``, bf16 O, no LSE), ``paged_decode_attention``
    and ``paged_extend_attention``."""
    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import prefill_attention
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
        paged_extend_attention,
    )

    time_cuda = _harness_time_cuda()
    out = []
    for name, b, hq, hkv, l, d, causal in HEADS_H1:
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in make_qkv(b, hq, l, d, seed=1, heads_kv=hkv))
        ms = time_cuda(lambda: prefill_attention(
            q, k, v, d ** -0.5, 0, causal, with_lse=False), n_iter=30)
        out.append(f"{name} {ms:.4f} ms")
        del q, k, v
    for name, b, hq, hkv, d, ps in HEADS_PAGED:
        q, cache, slots = _paged_case(b, hq, hkv, (257, 1100), 1200, ps=ps,
                                      d=d)
        ms = time_cuda(lambda: paged_decode_attention(q, cache, slots),
                       n_iter=100)
        out.append(f"decode {name} {ms:.4f} ms")
        q, cache, slots = _paged_case(b, hq, hkv, (257, 1100), 1200, ps=ps,
                                      chunk=64, d=d)
        ms = time_cuda(lambda: paged_extend_attention(q, cache, slots),
                       n_iter=50)
        out.append(f"extend {name} {ms:.4f} ms")
    return f"{root.name or root}: " + " | ".join(out)


# H1 at f32 over long key counts, as chip_smoke.py's F32_LONG_KEYS: (label,
# B, Hq, Hkv, Lq, Lkv, d, causal, window); inputs from make_qkv(seed=Lkv +
# d) in f32
F32_LONG_KEYS = (("B3 route", 2, 8, 8, 1024, 8200, 128, False, None),
                 ("B3 route d=256", 2, 8, 8, 1024, 8200, 256, False, None),
                 ("32768 keys", 1, 8, 1, 256, 32768, 128, False, None),
                 ("32768 keys window 4096", 1, 8, 1, 256, 32768, 128, True,
                  4096))
# H5 at f32 over long key counts, d=512: (B, H, Lq, Lkv); inputs from
# make_qkv(seed=Lkv) in f32
H5_F32_LONG_KEYS = ((1, 8, 1024, 1024), (1, 8, 1024, 32768))
# H1 f32 timed through flash_attention_v1: (label, B, Hq, Hkv, Lq, Lkv,
# d, causal, window), bench.py's canonical shape, the v1 routes of TPU
# kernels B2, B4 and B5 (chip_smoke.py's V1_CASES) and B3's at d=256 (the
# D=256 instance)
F32_TIMED = (("canonical", 32, 8, 8, 1024, 1024, 128, False, None),
             ("B2", 8, 8, 2, 1000, 1100, 128, False, None),
             ("B4", 8, 8, 4, 512, 1024, 128, True, None),
             ("B5", 4, 8, 4, 4096, 4096, 128, True, 512),
             ("B3 route d=256", 2, 8, 8, 1024, 8200, 256, False, None))


def time_f32(root: Path) -> str:
    """The f32 core's kernels (``csrc/f32_attention.cuh``), L2 flushed,
    with this file's timing harness: H1 f32 at ``F32_TIMED``,
    ``paged_extend_attention`` with f32 q at the multi-turn turn (C=256
    after 257..280) and ``flash_attention_kvquant`` with f32 q at the
    canonical shape (int8 and e4m3, block 512); then max|O - oracle| of H1
    f32 at ``F32_LONG_KEYS`` against the plain attention in f64 on the
    card, and of H4-kvq f32 over 8192 keys (B16's route, int8, block 128,
    chip_smoke.py's KVQ_CASES) against the plain f32 version and the f64
    one over the dequantized K/V; ``flash_attention_v1_dtiled`` (H5) at
    f32 is timed at d=512 (B=4, H=8, L=1024, f32 K/V) and read against
    the f64 plain version at ``H5_F32_LONG_KEYS``; then the card's name
    and power limit."""
    import math
    import subprocess

    import numpy as np
    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import (
        attention_dtiled_plain,
        attention_kvquant_plain,
        attention_plain,
        flash_attention_kvquant,
        flash_attention_v1,
        flash_attention_v1_dtiled,
        prefill_attention,
        quantize_fp8,
        quantize_int8,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_extend_attention,
    )

    def f32(b, hq, hkv, lq, lkv, d, seed):
        return [torch.from_numpy(x).to("cuda") for x in make_qkv(
            b, hq, lq, d, dtype=np.float32, seed=seed, seq_len_kv=lkv,
            heads_kv=hkv)]

    torch.backends.cuda.matmul.allow_tf32 = False
    time_cuda = _harness_time_cuda()
    out = []
    for name, b, hq, hkv, lq, lkv, d, causal, window in F32_TIMED:
        q, k, v = f32(b, hq, hkv, lq, lkv, d, 1)
        ms = time_cuda(lambda: flash_attention_v1(q, k, v, causal=causal,
                                                  window=window), n_iter=20)
        out.append(f"H1 f32 {name} {ms:.4f} ms")
        del q, k, v
    q, cache, slots = _paged_case(8, 8, 4, (257, 280), 1024, chunk=256)
    q = q.float()
    ms = time_cuda(lambda: paged_extend_attention(q, cache, slots), n_iter=50)
    out.append(f"H6-extend f32 multi-turn {ms:.4f} ms")
    q, k, v = f32(32, 8, 8, 1024, 1024, 128, 1)
    for kind, quant in (("int8", quantize_int8), ("fp8", quantize_fp8)):
        kq, vq = quant(k, 512), quant(v, 512)
        ms = time_cuda(lambda: flash_attention_kvquant(q, kq, vq), n_iter=20)
        out.append(f"H4-kvq f32 {kind} {ms:.4f} ms")
    del q, k, v, kq, vq
    q, k, v = f32(4, 8, 8, 1024, 1024, 512, 1)
    ms = time_cuda(lambda: flash_attention_v1_dtiled(q, k, v), n_iter=20)
    out.append(f"H5 f32 d=512 {ms:.4f} ms")
    del q, k, v
    for name, b, hq, hkv, lq, lkv, d, causal, window in F32_LONG_KEYS:
        q, k, v = f32(b, hq, hkv, lq, lkv, d, lkv + d)
        scale, diag = 1.0 / math.sqrt(d), lkv - lq
        o, _ = prefill_attention(q, k, v, scale, diag, causal, window)
        ref, _ = attention_plain(q.double(), k.double(), v.double(), scale,
                                 causal, diag, window)
        out.append(f"H1 f32 {name} max|O - oracle| "
                   f"{(o.double() - ref).abs().max().item():.3e}")
        del q, k, v, o, ref
    for b, h, lq, lkv in H5_F32_LONG_KEYS:
        q, k, v = f32(b, h, h, lq, lkv, 512, lkv)
        o = flash_attention_v1_dtiled(q, k, v)
        ref = attention_dtiled_plain(q.double(), k.double(), v.double(),
                                     1.0 / math.sqrt(512))
        out.append(f"H5 f32 d=512 {lkv} keys max|O - oracle| "
                   f"{(o.double() - ref).abs().max().item():.3e}")
        del q, k, v, o, ref
    q, k, v = f32(2, 8, 8, 1024, 8192, 128, 2)
    kq, vq = quantize_int8(k, 128), quantize_int8(v, 128)
    scale = 1.0 / math.sqrt(128)
    o = flash_attention_kvquant(q, kq, vq)
    plain = attention_kvquant_plain(q, kq, vq, scale)
    o64 = attention_kvquant_plain(q.double(), kq, vq, scale)
    out.append(f"H4-kvq f32 8192 keys max|O - plain| "
               f"{(o - plain).abs().max().item():.3e}, max|O - oracle| "
               f"{(o.double() - o64).abs().max().item():.3e}")
    out.append(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return f"{root.name or root}: " + " | ".join(out)


# H5's cluster launches beside launches of the same blocks without the
# exchange: (label, d, f32, H) of the cluster call at B=4, L=1024, H=8 and
# of the call whose H heads give as many blocks of as many chunks each
H5_SAME_WORK = (("bf16 d=1024 C=2", 1024, False, 512, 16),
                ("bf16 d=2048 C=4", 2048, False, 512, 32),
                ("f32 d=512 C=2", 512, True, 256, 16),
                ("f32 d=1024 C=4", 1024, True, 256, 32),
                ("f32 d=2048 C=8", 2048, True, 256, 64))


def time_clusters(root: Path) -> str:
    """H5 (``flash_attention_v1_dtiled``, L2 flushed) at each cluster of
    ``H5_SAME_WORK`` beside the same number of blocks, each of the same
    d-chunks, of one block a Q tile (d 512 bf16, 256 f32) at more heads:
    the difference is the cost of the cluster's exchange of S.  Inputs
    from make_qkv(seed=1), bf16 (rounded) or f32."""
    import numpy as np
    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import (
        flash_attention_v1_dtiled,
    )

    time_cuda = _harness_time_cuda()
    out = []
    for label, d, f32, d1, h1 in H5_SAME_WORK:
        ms = []
        for dd, h in ((d, 8), (d1, h1)):
            q, k, v = (torch.from_numpy(x).to(
                "cuda", torch.float32 if f32 else torch.bfloat16)
                for x in make_qkv(4, h, 1024, dd, dtype=np.float32, seed=1))
            ms.append(time_cuda(lambda: flash_attention_v1_dtiled(q, k, v),
                                n_iter=20))
            del q, k, v
        out.append(f"H5 {label} {ms[0]:.4f} ms, d={d1} H={h1} (the same "
                   f"blocks, one a Q tile) {ms[1]:.4f} ms")
    return f"{root.name or root}: " + " | ".join(out)


def time_quant_heads(root: Path) -> str:
    """flash_attention_kvquant (H4-kvq: int8 and e4m3 K/V),
    flash_attention_int8 (H4-int8: both pv_modes) and
    flash_attention_v1_dtiled (H5: bf16 and int8 K/V) at d 80, 128 and
    256, B=32 H=8 L=1024, blocks of 512, inputs from make_qkv(seed=1)
    rounded to bf16: the instances whose rows TMA describes."""
    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import (
        flash_attention_int8,
        flash_attention_kvquant,
        flash_attention_v1_dtiled,
        quantize_fp8,
        quantize_int8,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    out = []
    for d in (80, 128, 256):
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in make_qkv(32, 8, 1024, d, seed=1))
        calls = {}
        for kind, quant in (("int8", quantize_int8), ("fp8", quantize_fp8)):
            kq, vq = quant(k, 512), quant(v, 512)
            calls[f"H4-kvq {kind}"] = (flash_attention_kvquant, q, kq, vq)
        qq, kq, vq = (quantize_int8(x, 512) for x in (q, k, v))
        calls["H4-int8 bf16"] = (flash_attention_int8, qq, kq, vq)
        calls["H4-int8 int8"] = (lambda *a: flash_attention_int8(
            *a, pv_mode="int8"), qq, kq, vq)
        calls["H5 bf16"] = (flash_attention_v1_dtiled, q, k, v)
        calls["H5 int8"] = (flash_attention_v1_dtiled, q, kq, vq)
        for name, (fn, *args) in calls.items():
            ms = time_cuda(lambda: fn(*args), n_iter=30)
            out.append(f"{name} d={d} {ms:.4f} ms")
        del q, k, v, qq, kq, vq, calls
    return f"{root.name or root}: " + " | ".join(out)


def main(root: Path, mode: str = "") -> str:
    sys.path.insert(0, str(root))
    if mode == "--bwd":
        return time_bwd(root)
    if mode == "--bwd-heads":
        return time_bwd_heads(root)
    if mode == "--merge":
        return time_merge(root)
    if mode == "--serve":
        return time_serve(root)
    if mode == "--f32":
        return time_f32(root)
    if mode == "--clusters":
        return time_clusters(root)
    if mode == "--heads":
        return time_heads(root)
    if mode == "--quant-heads":
        return time_quant_heads(root)
    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import (
        flash_attention_int8,
        flash_attention_kvquant,
        flash_attention_v1_dtiled,
        quantize_fp8,
        quantize_int8,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    out = []
    q, k, v = (quantize_int8(torch.from_numpy(x).to("cuda", torch.bfloat16),
                             512) for x in make_qkv(32, 8, 1024, 128, seed=1))
    for mode in ("bf16", "int8"):
        ms = time_cuda(lambda: flash_attention_int8(q, k, v, pv_mode=mode),
                       n_iter=30)
        out.append(f"int8 d=128 pv_mode {mode} {ms:.4f} ms")
    del q, k, v
    for b, d, fn, kinds in ((32, 128, flash_attention_kvquant, ("int8", "fp8")),
                            (32, 64, flash_attention_kvquant, ("int8",)),
                            (4, 512, flash_attention_v1_dtiled,
                             ("int8", "fp8", "bf16"))):
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in make_qkv(b, 8, 1024, d, seed=1))
        for kind in kinds:
            kq, vq = ((k, v) if kind == "bf16" else
                      (quant[kind](k, 512), quant[kind](v, 512)))
            ms = time_cuda(lambda: fn(q, kq, vq), n_iter=30)
            out.append(f"d={d} {kind} {ms:.4f} ms")
        del q, k, v
    return f"{root.name or root}: " + " | ".join(out)


if __name__ == "__main__":
    here = Path(__file__).resolve().parents[2]
    roots = [a for a in sys.argv[1:] if not a.startswith("--")]
    modes = [a for a in sys.argv[1:] if a.startswith("--")]
    print(main(Path(roots[0]).resolve() if roots else here,
               modes[0] if modes else ""))
