"""Speculative decoding of the port: a draft model proposes, the target
verifies.

Counterpart of ``models/speculative.py`` in the JAX package.  Each round:

    1. the DRAFT runs gamma autoregressive steps, proposing d_1..d_gamma,
       then one catch-up step that appends d_gamma's K/V (its logits are
       dropped): through the paged decode path (kernel H6-decode) with
       ``draft_mode="paged"``, or a rolling window of dense K/V per layer
       (plain torch, as the JAX package runs it on XLA einsums) with
       ``draft_mode="dense"``;
    2. the TARGET scores [pending, d_1..d_gamma] in one chunked extend
       (kernel H6-extend at C = gamma + 1);
    3. acceptance: greedy (``temperature == 0``: d_i is kept while it
       equals the target's argmax, the first mismatch is replaced by the
       target's argmax), or rejection sampling (d_i kept with probability
       min(1, p_target / p_draft); the first rejection resamples from the
       normalized residual max(p_target - p_draft, 0); a bonus token from
       the target's last row when all survive);
    4. both caches roll back past the rejected tokens (``set_seq_lens``:
       the pages keep them, the kernels mask past ``seq_lens``, the next
       append overwrites them);
    5. the accepted tokens and the corrected or bonus token are written
       into the output buffer, each row at its own count.

Greedy output is exactly what target-only greedy decoding gives, up to
ties between the decode and extend kernels' roundings.

The JAX package runs every round inside one jitted ``lax.while_loop``
with no host round trip.  On the card the port runs a generation's first
round eagerly (which builds the kernels and reserves H6-decode's
tickets), then captures the round as one CUDA graph (``graphs.StepGraph``,
keyed by batch size, gamma, temperature and draft mode, with the engine's
``torch.Generator`` registered) and replays it.  The one host sync a round
is the 4-byte read of the smallest output count that decides whether to
stop: the price of the port's loop, where JAX's has none.  Torch has no
``mode="drop"`` scatter: the output buffer has one spare column that takes
every dropped write.

Sequences keep going until every one has its tokens, as in JAX, so one
that runs ahead keeps writing its cache; past its mapped pages the writes
land in its last page (``append_tokens`` and ``append_chunks`` clamp the
page index, as JAX's gathers clamp it), which changes only tokens past
``max_new_tokens``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from exploring_flash_attention_tpu_torch.configs import cdiv
from exploring_flash_attention_tpu_torch.graphs import StepGraph
from exploring_flash_attention_tpu_torch.models.generate import (
    _decode_forward,
    _extend_forward,
    forward_collect_kv,
    sample,
)
from exploring_flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    Params,
    _rmsnorm,
    rope,
)
from exploring_flash_attention_tpu_torch.serving.kv_cache import (
    PageAllocator,
    append_prompts,
    make_cache,
    set_seq_lens,
)

DenseBufs = List[Tuple[torch.Tensor, torch.Tensor]]


# ---- dense rolling-window draft ----
#
# The draft's correctness never matters (any proposal verifies exactly);
# its cost does.  Each layer keeps a ring of ``window`` dense K/V slots
# [B, Hkv, W, d] and ``slot_pos`` [B, W], the position each slot holds (-1:
# none).  A step attends to the slots whose position is in (pos - W, pos];
# rollback is free: the next round restarts at the rolled-back position,
# the mask hides slots past it and re-generated positions overwrite them.

def _dense_draft_prefill(dparams: Params, dcfg: ModelConfig,
                         prompt: torch.Tensor, window: int
                         ) -> Tuple[DenseBufs, torch.Tensor]:
    """Seed the rolling ring from the prompt: (per-layer (k_buf, v_buf)
    [B, Hkv, W, d], slot_pos int32 [B, W])."""
    _, kvs = forward_collect_kv(dparams, prompt, dcfg)   # [B, L, Hkv, d]
    b, l = prompt.shape
    w = window
    n = min(w, l)
    dev = prompt.device
    ps = torch.arange(l - n, l, dtype=torch.int32, device=dev)
    slots = (ps % w).long()
    bufs = []
    for k, v in kvs:
        kb = torch.zeros((b, dcfg.n_kv_heads, w, dcfg.d_head),
                         dtype=dcfg.dtype, device=dev)
        vb = torch.zeros_like(kb)
        kb[:, :, slots, :] = k[:, l - n:].transpose(1, 2).to(dcfg.dtype)
        vb[:, :, slots, :] = v[:, l - n:].transpose(1, 2).to(dcfg.dtype)
        bufs.append((kb, vb))
    slot_pos = torch.full((w,), -1, dtype=torch.int32, device=dev)
    slot_pos[slots] = ps
    return bufs, slot_pos[None].repeat(b, 1)


def _dense_draft_step(dparams: Params, dcfg: ModelConfig, tok: torch.Tensor,
                      bufs: DenseBufs, slot_pos: torch.Tensor,
                      pos: torch.Tensor
                      ) -> Tuple[torch.Tensor, DenseBufs, torch.Tensor]:
    """One dense rolling-window decode step: tokens ``tok`` [B] at
    positions ``pos`` [B].  Returns (logits f32 [B, V], bufs, slot_pos),
    the ring and ``slot_pos`` updated in place.  The block structure of
    ``transformer.forward`` (same params), attention in f32."""
    c = dcfg
    b = tok.shape[0]
    w = slot_pos.shape[1]
    bi = torch.arange(b, device=tok.device)
    pos = pos.to(torch.int32)
    slot = (pos % w).long()
    slot_pos[bi, slot] = pos
    scale = 1.0 / math.sqrt(c.d_head)
    g = c.n_heads // c.n_kv_heads
    vis = ((slot_pos >= 0) & (slot_pos <= pos[:, None])
           & (slot_pos > pos[:, None] - w))                  # [B, W]
    x = dparams["embed"][tok.long()].to(c.dtype)
    for p, (kb, vb) in zip(dparams["layers"], bufs):
        h = _rmsnorm(x, p["ln1"], c.norm_eps)
        q = torch.einsum("be,ehd->bhd", h, p["wq"])
        k = torch.einsum("be,ehd->bhd", h, p["wk"])
        v = torch.einsum("be,ehd->bhd", h, p["wv"])
        if c.use_rope:
            q = rope(q[:, :, None, :], pos[:, None, None],
                     c.rope_theta)[:, :, 0, :]
            k = rope(k[:, :, None, :], pos[:, None, None],
                     c.rope_theta)[:, :, 0, :]
        kb[bi, :, slot, :] = k
        vb[bi, :, slot, :] = v
        q4 = q.reshape(b, c.n_kv_heads, g, c.d_head).float()
        s = torch.einsum("bkgd,bkwd->bkgw", q4, kb.float()) * scale
        s = s.masked_fill(~vis[:, None, None, :], float("-inf"))
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgw,bkwd->bkgd", a, vb.float())
        o = o.reshape(b, c.n_heads, c.d_head).to(c.dtype)
        x = x + torch.einsum("bhd,hde->be", o, p["wo"])
        hh = _rmsnorm(x, p["ln2"], c.norm_eps)
        gate = torch.einsum("be,ef->bf", hh, p["w_gate"])
        up = torch.einsum("be,ef->bf", hh, p["w_up"])
        act = F.silu(gate.float()).to(x.dtype) * up
        x = x + torch.einsum("bf,fe->be", act, p["w_down"])
    xf = _rmsnorm(x, dparams["ln_f"], c.norm_eps)
    logits = torch.einsum("be,ve->bv", xf, dparams["embed"].to(c.dtype))
    return logits.float(), bufs, slot_pos


@dataclasses.dataclass
class _Loop:
    """What a round reads and writes in place, kept per (batch size,
    gamma, temperature, draft mode) so that its CUDA graph finds it at the
    same addresses in every call."""
    pending: torch.Tensor          # int32 [B] the last emitted token
    count: torch.Tensor            # int32 [B] tokens emitted so far
    out: torch.Tensor              # int32 [B, max_len + 1], last column spare
    limit: torch.Tensor            # int32 [] max_new_tokens of the call
    rounds: torch.Tensor           # int64 []
    accepted: torch.Tensor         # int64 [] accepted draft tokens
    bufs: DenseBufs                # the dense draft's ring (dense mode)
    slot_pos: Optional[torch.Tensor]
    graph: Optional[StepGraph] = None


class SpeculativeEngine:
    """Batch speculative generation: target and draft over twin paged
    INT8 caches (the draft's only with ``draft_mode="paged"``), on the
    device of the target's parameters.  Slot and page geometry as
    ``GenerationEngine``'s.

    ``draft_mode="dense"`` runs the draft through the rolling dense window
    of ``draft_window`` positions (:func:`_dense_draft_step`) instead of
    the paged kernels.  Windowed models are refused, as in JAX.  On the
    card the rounds after a batch's first replay one CUDA graph; set
    ``graphed = False`` to run every round eagerly (the reference the
    graphed rounds are held to, bitwise)."""

    def __init__(
        self,
        target_params: Params,
        target_config: ModelConfig,
        draft_params: Params,
        draft_config: ModelConfig,
        max_seqs: int = 8,
        max_len: int = 2048,
        page_size: int = 128,
        draft_mode: str = "paged",
        draft_window: int = 128,
    ):
        if target_config.vocab_size != draft_config.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        if target_config.window is not None or draft_config.window is not None:
            raise ValueError("speculative decoding over windowed caches is "
                             "not supported yet")
        if draft_mode not in ("paged", "dense"):
            raise ValueError(f"draft_mode must be 'paged' or 'dense', "
                             f"got {draft_mode!r}")
        self.tparams, self.tcfg = target_params, target_config
        self.dparams, self.dcfg = draft_params, draft_config
        self.device = target_params["embed"].device
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.draft_mode = draft_mode
        self.draft_window = draft_window
        self.pages_per_seq = cdiv(max_len, page_size)
        self.max_len = self.pages_per_seq * page_size
        n_pages = max_seqs * self.pages_per_seq

        def caches(cfg: ModelConfig):
            return [
                make_cache(cfg.n_kv_heads, cfg.d_head, n_pages,
                           page_size=page_size, max_seqs=max_seqs,
                           max_pages_per_seq=self.pages_per_seq,
                           device=self.device)
                for _ in range(cfg.n_layers)
            ]
        self.tcaches = caches(target_config)
        self.dcaches = caches(draft_config) if draft_mode == "paged" else []
        self.t_alloc = PageAllocator(n_pages)
        self.d_alloc = PageAllocator(n_pages)
        self.graphed = True
        self._slot_ids: Dict[int, torch.Tensor] = {}
        self._generator = torch.Generator(device=self.device)
        self._loops: Dict[Tuple[int, int, float, str], _Loop] = {}

    # ---- slot/page mapping (one host-assembled table per model) ----

    def _map(self, bsz: int) -> Tuple[torch.Tensor, Dict[str, List[int]]]:
        mapped: Dict[str, List[int]] = {"t": []}
        pairs = [("t", self.t_alloc, self.tcaches)]
        if self.draft_mode == "paged":
            mapped["d"] = []
            pairs.append(("d", self.d_alloc, self.dcaches))
        try:
            for key, alloc, cache_list in pairs:
                table = np.zeros((self.max_seqs, self.pages_per_seq),
                                 np.int32)
                for s in range(bsz):
                    pages = alloc.alloc(self.pages_per_seq)
                    mapped[key].extend(pages)
                    table[s, :len(pages)] = pages
                table_t = torch.from_numpy(table).to(self.device)
                for cache in cache_list:
                    cache.page_table.copy_(table_t)
                    cache.seq_lens.zero_()
        except BaseException:
            self._release(mapped)
            raise
        if bsz not in self._slot_ids:
            self._slot_ids[bsz] = torch.arange(bsz, dtype=torch.int32,
                                               device=self.device)
        return self._slot_ids[bsz], mapped

    def _release(self, mapped: Dict[str, List[int]]) -> None:
        self.t_alloc.free(mapped["t"])
        if "d" in mapped:
            self.d_alloc.free(mapped["d"])

    # ---- public API ----

    @torch.no_grad()
    def generate(
        self,
        prompt,                        # [B, L_prompt] int (array or tensor)
        max_new_tokens: int,
        gamma: int = 4,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> Tuple[np.ndarray, Dict[str, float]]:
        """Returns (tokens [B, max_new_tokens] int32, stats).

        stats: ``acceptance_rate`` (accepted draft tokens / proposed),
        ``rounds`` (verify passes run), ``tokens_per_round``.  A batch over
        ``max_seqs``, or ``prompt + max_new_tokens + 2 * (gamma + 1)`` over
        ``max_len``, raises ``ValueError``; the pages are freed whatever
        happens."""
        prompt = (prompt.to(self.device) if isinstance(prompt, torch.Tensor)
                  else torch.as_tensor(np.asarray(prompt),
                                       device=self.device))
        bsz, l_prompt = prompt.shape
        if bsz > self.max_seqs:
            raise ValueError(f"batch {bsz} > max_seqs {self.max_seqs}")
        # peak cache length: accepted history can overshoot max_new by a
        # round (gamma+1) and verification holds gamma+1 unaccepted slots
        if l_prompt + max_new_tokens + 2 * (gamma + 1) > self.max_len:
            raise ValueError("prompt + max_new_tokens + 2*(gamma+1) must "
                             f"fit max_len={self.max_len}")
        slots, mapped = self._map(bsz)
        try:
            self._generator.manual_seed(seed)
            out, rounds, accepted = self._run(prompt, slots, max_new_tokens,
                                              gamma, temperature)
        finally:
            self._release(mapped)
        proposed = rounds * gamma * bsz
        stats = {
            "acceptance_rate": accepted / max(proposed, 1.0),
            "rounds": rounds,
            "tokens_per_round": (bsz * out.shape[1]) / max(rounds * bsz, 1.0),
        }
        return out, stats

    # ---- the loop ----

    def _loop(self, bsz: int, gamma: int, temperature: float) -> _Loop:
        key = (bsz, gamma, temperature, self.draft_mode)
        loop = self._loops.get(key)
        if loop is None:
            dev, int32 = self.device, torch.int32
            bufs, slot_pos = [], None
            if self.draft_mode == "dense":
                shape = (bsz, self.dcfg.n_kv_heads, self.draft_window,
                         self.dcfg.d_head)
                bufs = [(torch.zeros(shape, dtype=self.dcfg.dtype,
                                     device=dev),
                         torch.zeros(shape, dtype=self.dcfg.dtype,
                                     device=dev))
                        for _ in range(self.dcfg.n_layers)]
                slot_pos = torch.zeros((bsz, self.draft_window), dtype=int32,
                                       device=dev)
            loop = self._loops[key] = _Loop(
                pending=torch.zeros(bsz, dtype=int32, device=dev),
                count=torch.zeros(bsz, dtype=int32, device=dev),
                out=torch.zeros((bsz, self.max_len + 1), dtype=int32,
                                device=dev),
                limit=torch.zeros((), dtype=int32, device=dev),
                rounds=torch.zeros((), dtype=torch.int64, device=dev),
                accepted=torch.zeros((), dtype=torch.int64, device=dev),
                bufs=bufs, slot_pos=slot_pos)
        return loop

    def _prefill(self, loop: _Loop, prompt: torch.Tensor,
                 slots: torch.Tensor, max_new: int,
                 temperature: float) -> None:
        """Prefill both models on the prompt and reset the loop's state;
        the first token comes from the target's prefill logits, as in
        target-only decoding."""
        t_logits, t_kvs = forward_collect_kv(self.tparams, prompt, self.tcfg)
        for cache, (k, v) in zip(self.tcaches, t_kvs):
            append_prompts(cache, slots, k, v)
        if self.draft_mode == "dense":
            bufs, slot_pos = _dense_draft_prefill(
                self.dparams, self.dcfg, prompt, self.draft_window)
            for (kb, vb), (k, v) in zip(loop.bufs, bufs):
                kb.copy_(k)
                vb.copy_(v)
            loop.slot_pos.copy_(slot_pos)
        else:
            _, d_kvs = forward_collect_kv(self.dparams, prompt, self.dcfg)
            for cache, (k, v) in zip(self.dcaches, d_kvs):
                append_prompts(cache, slots, k, v)
        pending = sample(t_logits[:, -1, :], temperature, self._generator)
        loop.pending.copy_(pending)
        loop.out.zero_()
        loop.out[:, 0] = pending
        loop.count.fill_(1)
        loop.limit.fill_(max_new)
        loop.rounds.zero_()
        loop.accepted.zero_()

    def _run(self, prompt: torch.Tensor, slots: torch.Tensor, max_new: int,
             gamma: int, temperature: float) -> Tuple[np.ndarray, float,
                                                      float]:
        loop = self._loop(prompt.shape[0], gamma, temperature)
        self._prefill(loop, prompt, slots, max_new, temperature)
        graphed = self.graphed and self.device.type == "cuda"
        eager_done = False

        def step() -> torch.Tensor:
            return self._round(loop, slots, gamma, temperature)

        while int(loop.count.min()) < max_new:     # the round's host sync
            if loop.graph is not None and graphed:
                loop.graph.replay()
            elif graphed and eager_done:
                loop.graph = StepGraph(
                    step, self.device,
                    generators=(self._generator,) if temperature else ())
                loop.graph.replay()
            else:
                step()
                eager_done = True
        return (loop.out[:, :max_new].cpu().numpy(), float(loop.rounds),
                float(loop.accepted))

    def _round(self, loop: _Loop, slots: torch.Tensor, gamma: int,
               temperature: float) -> torch.Tensor:
        """One iteration of the JAX package's loop body (``:322-435``),
        every state tensor updated in place; no host sync."""
        gen = self._generator
        greedy = temperature == 0.0
        dense = self.draft_mode == "dense"
        sl = slots.long()
        base_t = self.tcaches[0].seq_lens[sl]            # [B] pre-round len

        # ---- draft: gamma proposal steps (+1 catch-up append) ----
        d_toks, d_dists = [], []
        tok = loop.pending
        if dense:
            for i in range(gamma + 1):
                lg, _, _ = _dense_draft_step(self.dparams, self.dcfg, tok,
                                             loop.bufs, loop.slot_pos,
                                             base_t + i)
                if i == gamma:
                    break               # catch-up: d_gamma's K/V only
                tok = sample(lg, temperature, gen)
                d_toks.append(tok)
                if not greedy:
                    d_dists.append(torch.softmax(lg / temperature, dim=-1))
        else:
            base_d = self.dcaches[0].seq_lens[sl]
            for _ in range(gamma):
                lg = _decode_forward(self.dparams, tok, self.dcaches, slots,
                                     self.dcfg)
                tok = sample(lg, temperature, gen)
                d_toks.append(tok)
                if not greedy:
                    d_dists.append(torch.softmax(lg / temperature, dim=-1))
            # catch-up: d_gamma's K/V, so the draft cache covers the
            # full-accept case (logits discarded)
            _decode_forward(self.dparams, tok, self.dcaches, slots,
                            self.dcfg)
        d = torch.stack(d_toks, dim=1)                   # [B, gamma]

        # ---- target: verify the whole chunk in one extend ----
        chunk = torch.cat([loop.pending[:, None], d], dim=1)
        t_logits = _extend_forward(self.tparams, chunk, self.tcaches, slots,
                                   self.tcfg)            # [B, gamma+1, V]

        # ---- acceptance ----
        if greedy:
            t_arg = torch.argmax(t_logits, dim=-1).to(torch.int32)
            match = t_arg[:, :gamma] == d
            n_acc = match.to(torch.int32).cumprod(dim=1).sum(dim=1)
            next_tok = t_arg.gather(1, n_acc[:, None].long())[:, 0]
        else:
            p_t = torch.softmax(t_logits / temperature, dim=-1)
            p_d = torch.stack(d_dists, dim=1)            # [B, gamma, V]
            idx = d[..., None].long()
            pt_i = p_t[:, :gamma].gather(-1, idx)[..., 0]
            pd_i = p_d.gather(-1, idx)[..., 0]
            u = torch.rand(d.shape, generator=gen, device=d.device)
            accept = u * pd_i < pt_i                     # min(1, pt/pd) rule
            n_acc = accept.to(torch.int32).cumprod(dim=1).sum(dim=1)
            # residual at the first rejected position; the bonus from the
            # target's last position when everything survived
            pos = n_acc.clamp_max(gamma - 1).long()[:, None, None].expand(
                -1, 1, p_t.shape[-1])
            resid = (p_t.gather(1, pos)[:, 0]
                     - p_d.gather(1, pos)[:, 0]).clamp_min(0.0)
            resid = resid / resid.sum(dim=-1, keepdim=True).clamp_min(1e-20)
            dist = torch.where((n_acc == gamma)[:, None], p_t[:, gamma],
                               resid)
            next_tok = torch.multinomial(dist.clamp_min(1e-30), 1,
                                         generator=gen)[:, 0]
        n_acc = n_acc.to(torch.int32)
        next_tok = next_tok.to(torch.int32)

        # ---- roll both caches back past the rejected tokens ----
        for cache in self.tcaches:                       # [pending, d_1..d_n]
            set_seq_lens(cache, slots, base_t + 1 + n_acc)
        if not dense:
            # dense rollback is implicit: the next round's positions
            # restart at the new length and the ring's mask hides the rest
            for cache in self.dcaches:
                set_seq_lens(cache, slots, base_d + 1 + n_acc)

        # ---- emit d_1..d_n, then the corrected or bonus token ----
        j = torch.arange(gamma + 1, dtype=torch.int32, device=d.device)[None]
        d_pad = torch.cat([d, d[:, -1:]], dim=1)
        emitted = torch.where(j == n_acc[:, None], next_tok[:, None], d_pad)
        posn = loop.count[:, None] + j
        valid = (j <= n_acc[:, None]) & (posn < loop.limit)
        spare = loop.out.shape[1] - 1                    # takes the drops
        loop.out.scatter_(1, torch.where(valid, posn, spare).long(), emitted)
        loop.count += n_acc + 1
        loop.pending.copy_(next_tok)
        loop.rounds += 1
        loop.accepted += n_acc.sum()
        return loop.count
