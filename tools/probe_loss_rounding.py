"""How far a bf16 model's step-0 loss moves with the forward's roundings,
on the card.

    python tools/probe_loss_rounding.py

Takes the full-width flagship and chip_smoke.py's heads models
(``HEADS_MODELS``: the flagship's widths, another attention geometry; bf16,
random weights from seed 0) and the train phase's step-0 loss (tokens [8,
1025] from ``np.random.default_rng(0)``) with the model's attention five
ways: the kernels (H1), the plain forward (``plain_flash_attention``, f32
math, O rounded to bf16 once), the plain forward with P rounded to bf16
before P V as H1 rounds it (its row sum l of the rounded P, or of the f32
P), and the plain forward with each row's diagonal key hidden (the train
phase's known-wrong control).  Prints each loss and its distance from the
kernels'.  The distance between the plain forward and a forward that
rounds P is how far the loss moves with bf16 rounding choices alone,
what a loss limit between the kernels and the plain forward must clear.
It needs the card and reads no JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from exploring_flash_attention_tpu_torch.models import (  # noqa: E402
    flagship_config,
    init_params,
    loss_fn,
)
from exploring_flash_attention_tpu_torch.models import (  # noqa: E402
    transformer as transformer_module,
)
from exploring_flash_attention_tpu_torch.ops.attention import (  # noqa: E402
    hidden_keys,
)


def rounded_p_attention(q, k, v, causal=True, window=None, config=None,
                        l_of_rounded=True):
    """The model's attention with P = exp(s - max) rounded to bf16 before
    P V (f32 sums), divided by the row sum of the rounded P or of the f32
    P, O rounded to q's dtype."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(
        q.shape[3])
    hidden = hidden_keys(q.shape[2], k.shape[2], causal,
                         k.shape[2] - q.shape[2], window, q.device)
    if hidden is not None:
        s = s.masked_fill(hidden, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pr = p.bfloat16().float()
    den = (pr if l_of_rounded else p).sum(-1, keepdim=True)
    return (torch.einsum("bhqk,bhkd->bhqd", pr, vf) / den).to(q.dtype)


def main() -> None:
    dev = torch.device("cuda:0")
    print(chip_smoke.card_line())
    geos = {"flagship": {},
            **{name: {k: x for k, x in geo.items() if k != "page_size"}
               for name, geo in chip_smoke.HEADS_MODELS.items()}}
    ways = (("plain", chip_smoke.plain_flash_attention),
            ("P rounded, l of the rounded P", rounded_p_attention),
            ("P rounded, l of the f32 P",
             functools.partial(rounded_p_attention, l_of_rounded=False)),
            ("diagonal key hidden",
             functools.partial(chip_smoke.plain_flash_attention, hidden=1)))
    for name, geo in geos.items():
        cfg = dataclasses.replace(flagship_config(), **geo)
        params = init_params(cfg, seed=0, device=dev)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (8, 1025)).astype(np.int32)).to(dev)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        with torch.no_grad():
            kernels = loss_fn(params, inputs, targets, cfg).item()
            losses = {}
            for what, fn in ways:
                with mock.patch.object(transformer_module, "flash_attention",
                                       fn):
                    losses[what] = loss_fn(params, inputs, targets,
                                           cfg).item()
        print(f"{name}: kernels {kernels:.6f}; " + "; ".join(
            f"{w} {x:.6f} ({abs(kernels - x):.3e} from the kernels)"
            for w, x in losses.items()))
        del params


if __name__ == "__main__":
    main()
