"""Draft-model distillation for speculative decoding, in the port.

Counterpart of ``models/distill.py`` in the JAX package.  A draft pays for
itself only when its argmax agrees with the target's often enough; a
random draft sits at the 1/vocab floor.  The recipe (matched to the
greedy acceptance rule of ``models/speculative.py``):

  1. the target generates greedy continuations of prompts through the
     paged ``GenerationEngine`` (H1 prefill, H6-decode steps on the card):
     the distribution the draft will be verified on;
  2. every position is labelled with the target's argmax (one forward
     over the whole sequences);
  3. the draft is trained with cross-entropy against those hard labels
     under Adam (``torch.optim.Adam`` with optax's defaults, set
     explicitly), its attention through H1 and H3 on the card.

The batches are drawn from ``np.random.default_rng(seed + 1)`` as in JAX,
so that both packages see the same batches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from exploring_flash_attention_tpu_torch.models.generate import (
    GenerationEngine,
)
from exploring_flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    Params,
    adam,
    forward,
    make_trainable,
    param_leaves,
)


def target_labeled_corpus(
    tparams: Params,
    tcfg: ModelConfig,
    n_seqs: int = 32,
    prompt_len: int = 32,
    seq_len: int = 256,
    seed: int = 0,
    prompts=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens [N, L], labels [N, L]) int32 on the target's device:
    target-generated sequences with per-position target-argmax labels
    (labels[i, t] = the target's argmax given tokens[i, :t+1]).
    ``prompts`` [n_seqs, prompt_len] replaces the uniform-random default,
    so that the corpus follows the deployment's prompts."""
    dev = tparams["embed"].device
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = rng.integers(0, tcfg.vocab_size,
                               (n_seqs, prompt_len)).astype(np.int32)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                              device=dev)
    n_seqs, prompt_len = prompts.shape
    eng = GenerationEngine(tparams, tcfg, max_seqs=n_seqs,
                           max_len=max(seq_len + 8, 2 * seq_len))
    toks = eng.generate(prompts, max_new_tokens=seq_len - prompt_len)
    tokens = torch.cat([prompts, torch.from_numpy(toks).to(dev)],
                       dim=1)[:, :seq_len]
    with torch.no_grad():
        logits = forward(tparams, tokens, tcfg)
    labels = torch.argmax(logits, dim=-1).to(torch.int32)
    return tokens, labels


def distill_draft(
    tparams: Params,
    tcfg: ModelConfig,
    dparams: Params,
    dcfg: ModelConfig,
    steps: int = 300,
    batch: int = 16,
    n_seqs: int = 32,
    prompt_len: int = 32,
    seq_len: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    prompts=None,
) -> Tuple[Params, dict]:
    """Distill ``dparams`` toward the target's argmax behaviour.

    Returns the draft's params, trained in place (``requires_grad`` set on
    every leaf), where the JAX function returns new ones, and a stats dict:
    ``agree_first`` / ``agree_last`` (the batch's argmax agreement at the
    first and last step, what greedy acceptance tracks), ``loss_last`` and
    ``steps``."""
    tokens, labels = target_labeled_corpus(
        tparams, tcfg, n_seqs=n_seqs, prompt_len=prompt_len,
        seq_len=seq_len, seed=seed, prompts=prompts)
    opt = adam(param_leaves(make_trainable(dparams)), lr=lr)
    rng = np.random.default_rng(seed + 1)
    n = tokens.shape[0]
    first_agree = None
    for s in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, (min(batch, n),)),
                              device=tokens.device)
        tok, lab = tokens[idx], labels[idx]
        opt.zero_grad(set_to_none=True)
        logits = forward(dparams, tok, dcfg)
        loss = F.cross_entropy(logits.flatten(0, 1), lab.flatten().long())
        agree = (torch.argmax(logits, dim=-1) == lab).float().mean()
        loss.backward()
        opt.step()
        if s == 0:
            first_agree = float(agree)
    return dparams, {"agree_first": first_agree, "agree_last": float(agree),
                     "loss_last": float(loss.detach()), "steps": steps}
