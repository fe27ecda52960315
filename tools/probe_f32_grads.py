"""Where an f32 train step's gradient error comes from, on the card.

    python tools/probe_f32_grads.py

Takes the full-width flagship at ``dtype=torch.float32`` (random weights
from seed 0) and the step-0 gradients of chip_smoke.py's train and encoder
phases (the LM loss on tokens [8, 1025]; the MLM loss on tokens [8, 1024]
under one fixed mask), each leaf's gradient four ways: the kernels (H1 and
H3 at f32), the plain f32 attention in their place, the kernels' forward
with the plain backward in H3's place, and the whole model in f64 with the
plain attention (the reference).  Prints, per pair, the four leaves with
the largest ||g - ref|| / ||ref||, and the norms of the attention
projections' gradients, which are the small ones.  It needs the card and
reads no JAX.
"""

from __future__ import annotations

import dataclasses
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
    make_trainable,
    mask_tokens,
    mlm_loss,
    named_param_leaves,
)
from exploring_flash_attention_tpu_torch.models import (  # noqa: E402
    transformer as transformer_module,
)
from exploring_flash_attention_tpu_torch.models.tree import (  # noqa: E402
    tree_map,
)
from exploring_flash_attention_tpu_torch.ops import (  # noqa: E402
    attention_bwd as attention_bwd_module,
)


def losses(cfg, dev):
    """The LM loss and the encoder's MLM loss of chip_smoke.py's train and
    encoder phases, as functions of (params, config)."""
    rng = np.random.default_rng(0)
    lm = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1025)).astype(
        np.int32)).to(dev)
    enc = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (8, 1024)).astype(np.int32)).to(dev)
    mtok = cfg.vocab_size - 1
    _, mask = mask_tokens(enc, torch.Generator(device=dev).manual_seed(0),
                          mtok)
    return {"lm": lambda p, c: loss_fn(p, lm[:, :-1], lm[:, 1:], c),
            "encoder": lambda p, c: mlm_loss(p, enc, None, c, mtok,
                                             mask=mask)}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = dataclasses.replace(flagship_config(), dtype=torch.float32)
    params = make_trainable(init_params(cfg, seed=0, device=dev))
    names, leaves = zip(*named_param_leaves(params))
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    params64 = make_trainable(tree_map(lambda x: x.detach().double(),
                                       params))
    leaves64 = [x for _, x in named_param_leaves(params64)]
    plain_fwd = mock.patch.object(transformer_module, "flash_attention",
                                  chip_smoke.plain_flash_attention)
    plain_bwd = mock.patch.object(attention_bwd_module,
                                  "masked_attention_bwd", chip_smoke.plain_bwd)
    for kind, loss in losses(cfg, dev).items():
        def grads(p=params, c=cfg, lv=leaves):
            return [g.double() for g in torch.autograd.grad(loss(p, c), lv)]

        kernels = grads()
        with plain_fwd:
            plain = grads()
            f64 = grads(params64, cfg64, leaves64)
        with plain_bwd:
            kernel_fwd = grads()

        def worst(a, b):
            e = [((x - y).norm() / y.norm()).item() for x, y in zip(a, b)]
            return " ".join(f"{names[i]} {e[i]:.2e}"
                            for i in np.argsort(e)[::-1][:4])

        for what, a, b in (
                ("kernels vs the plain f32 attention", kernels, plain),
                ("kernels vs f64", kernels, f64),
                ("the plain f32 attention vs f64", plain, f64),
                ("the kernels' forward, the plain backward, vs f64",
                 kernel_fwd, f64),
                ("kernels vs the kernels' forward with the plain backward",
                 kernels, kernel_fwd)):
            print(f"{kind}: {what}: {worst(a, b)}")
        print(f"{kind}: gradient norms (f64): " + ", ".join(
            f"{n} {g.norm().item():.3e}" for n, g in zip(names, f64)
            if n.endswith(("wq", "wk"))))
    print(chip_smoke.card_line())


if __name__ == "__main__":
    main()
