"""Time the quantized and d-tiled forwards, or the backward pair, on the
card, for A/B runs.

    python exploring_flash_attention_tpu_torch/utils/time_forwards.py [ROOT] [--bwd]

ROOT (default: this checkout) is the root of a checkout of the port, for
example a ``git archive`` of another commit unpacked under ``build/``; its
package and kernels are the ones timed.  Prints one line: the CUDA-event
median milliseconds (L2 flushed before each call) of
``flash_attention_kvquant`` at the canonical shape (B=32, H=8, L=1024,
d=128, int8 and e4m3 K/V, block 512) and of ``flash_attention_v1_dtiled``
at d=512 (B=4, H=8, L=1024; int8, e4m3 and bf16 K/V), inputs from
``make_qkv(seed=1)`` rounded to bf16; with ``--bwd``, of H3-dkv and H3-dq
alone at the training shape (B=8, Hq=8, Hkv=4, L=1024, d=128), causal and
without a mask.  Alternate two roots in one call (parent, change, change,
parent) to compare them on one card.
"""

from __future__ import annotations

import sys
from pathlib import Path


def time_bwd(root: Path) -> str:
    """H3-dkv and H3-dq alone, causal and without a mask."""
    import math

    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
               for x in make_qkv(8, 8, 1024, 128, seed=1, heads_kv=4))
    do = torch.from_numpy(make_qkv(8, 8, 1024, 128, seed=2)[0]).to(
        "cuda", torch.bfloat16)
    scale = 1.0 / math.sqrt(128)
    out = []
    for causal in (True, False):
        o, lse = prefill_attention(q, k, v, scale, 0, causal)
        delta = (do.float() * o.float()).sum(dim=-1)
        for name, fn in (("H3-dkv", attention_bwd_dkv),
                         ("H3-dq", attention_bwd_dq)):
            ms = time_cuda(lambda: fn(q, k, v, do, lse, delta, scale, causal,
                                      0), n_iter=30)
            out.append(f"{name} {'causal' if causal else 'none'} {ms:.4f} ms")
    return f"{root.name or root}: " + " | ".join(out)


def main(root: Path, bwd: bool = False) -> str:
    if bwd:
        sys.path.insert(0, str(root))
        return time_bwd(root)
    sys.path.insert(0, str(root))
    import torch

    from exploring_flash_attention_tpu_torch.oracle import make_qkv
    from exploring_flash_attention_tpu_torch.ops import (
        flash_attention_kvquant,
        flash_attention_v1_dtiled,
        quantize_fp8,
        quantize_int8,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    out = []
    for b, d, fn, kinds in ((32, 128, flash_attention_kvquant, ("int8", "fp8")),
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
    roots = [a for a in sys.argv[1:] if a != "--bwd"]
    print(main(Path(roots[0]).resolve() if roots else here,
               "--bwd" in sys.argv[1:]))
