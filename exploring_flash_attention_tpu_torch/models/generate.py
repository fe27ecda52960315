"""LM inference engine of the port: prefill -> paged INT8 KV-cache -> decode,
and multi-turn continuation over the held cache.

Counterpart of ``models/generate.py`` in the JAX package:

- :func:`forward_collect_kv` runs the causal forward over the prompt
  (attention on kernel H1) and collects each layer's post-RoPE K and V;
- :func:`_decode_forward` advances every sequence one token: single-token
  projections, the cache append, paged decode attention (kernel H6-decode,
  one launch with its merge) per layer, logits;
- :func:`_extend_forward` feeds a new turn of C tokens per sequence: the
  chunk is appended to the cache, then attends over the whole paged
  history (kernel H6-extend), with no recompute of the earlier turns;
- :class:`GenerationEngine` owns the per-layer caches and the page
  allocation and exposes :meth:`GenerationEngine.generate`,
  :meth:`GenerationEngine.continue_generation` and
  :meth:`GenerationEngine.release`.

The cache stores post-rotation K, and decode and extend rotate each new
token's q/k at its per-sequence position read from the cache's
``seq_lens`` before the append, so ``seq_lens`` doubles as the RoPE
position counter.  Every attention call takes the config's ``window``, so
a windowed model is served on the same paths.

On the card each decode step after the first is one CUDA graph replay
(``graphs.StepGraph``): :func:`_decode_forward` and :func:`sample` over a
fixed token buffer, captured once per engine, batch size and temperature
after the first step of that batch has run eagerly, and shared by
``generate`` and ``continue_generation``: the JAX package's single
dispatch (a ``jax.jit`` around a ``lax.scan``).  On the CPU the steps run
eagerly.  The tokens stay on the device until the loop ends.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.configs import cdiv
from exploring_flash_attention_tpu_torch.graphs import StepGraph
from exploring_flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    Params,
    _mlp_block,
    _rmsnorm,
    rope,
)
from exploring_flash_attention_tpu_torch.ops.attention import flash_attention
from exploring_flash_attention_tpu_torch.serving.decode import (
    paged_decode_attention,
    paged_extend_attention,
)
from exploring_flash_attention_tpu_torch.serving.kv_cache import (
    PagedKVCache,
    PageAllocator,
    append_chunks,
    append_prompts,
    append_tokens,
    make_cache,
)


def forward_collect_kv(
    params: Params,
    tokens: torch.Tensor,          # [B, L] int
    config: ModelConfig,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Causal forward returning (logits f32 [B, L, V], per-layer (k, v) in
    cache layout [B, L, Hkv, d])."""
    c = config
    x = params["embed"][tokens.long()].to(c.dtype)
    kvs = []
    for p in params["layers"]:
        h = _rmsnorm(x, p["ln1"], c.norm_eps)
        q = torch.einsum("ble,ehd->bhld", h, p["wq"])
        k = torch.einsum("ble,ehd->bhld", h, p["wk"])
        v = torch.einsum("ble,ehd->bhld", h, p["wv"])
        if c.use_rope:
            pos = torch.arange(k.shape[2], device=x.device)
            q = rope(q, pos, c.rope_theta)
            k = rope(k, pos, c.rope_theta)     # the cache stores rotated K
        kvs.append((k, v))                     # [B, Hkv, L, d]
        o = flash_attention(q, k, v, config=c.tile, causal=True,
                            window=c.window)
        x = x + torch.einsum("bhld,hde->ble", o.to(x.dtype), p["wo"])
        x = x + _mlp_block(p, x, c)
    x = _rmsnorm(x, params["ln_f"], c.norm_eps)
    logits = torch.einsum("ble,ve->blv", x,
                          params["embed"].to(c.dtype)).float()
    return logits, [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in kvs]


def _decode_forward(
    params: Params,
    tokens: torch.Tensor,          # [B] int, the last sampled token per seq
    caches: List[PagedKVCache],
    slots: torch.Tensor,           # int32 [B]
    config: ModelConfig,
) -> torch.Tensor:
    """One decode step: appends each layer's new K/V to its cache in place
    and returns logits f32 [B, V]."""
    c = config
    x = params["embed"][tokens.long()].to(c.dtype)          # [B, E]
    for p, cache in zip(params["layers"], caches):
        h = _rmsnorm(x, p["ln1"], c.norm_eps)
        q = torch.einsum("be,ehd->bhd", h, p["wq"])          # [B, Hq, d]
        k = torch.einsum("be,ehd->bhd", h, p["wk"])          # [B, Hkv, d]
        v = torch.einsum("be,ehd->bhd", h, p["wv"])
        if c.use_rope:
            pos = cache.seq_lens[slots.long()]               # this token's pos
            q = rope(q, pos[:, None], c.rope_theta)
            k = rope(k, pos[:, None], c.rope_theta)
        append_tokens(cache, slots, k, v)
        o = paged_decode_attention(q.contiguous(), cache, slots,
                                   window=c.window)          # [B, Hq, d]
        x = x + torch.einsum("bhd,hde->be", o.to(x.dtype), p["wo"])
        x2 = x[:, None, :]                                   # [B, 1, E]
        x = (x2 + _mlp_block(p, x2, c))[:, 0]
    xf = _rmsnorm(x, params["ln_f"], c.norm_eps)
    return torch.einsum("be,ve->bv", xf, params["embed"].to(c.dtype)).float()


def _extend_forward(
    params: Params,
    tokens: torch.Tensor,          # [B, C] int, a new turn per sequence
    caches: List[PagedKVCache],
    slots: torch.Tensor,           # int32 [B]
    config: ModelConfig,
) -> torch.Tensor:
    """Multi-turn continuation forward: appends each layer's chunk K/V to
    its cache in place, attends over the paged history and returns logits
    f32 [B, C, V]."""
    c = config
    x = params["embed"][tokens.long()].to(c.dtype)          # [B, C, E]
    for p, cache in zip(params["layers"], caches):
        h = _rmsnorm(x, p["ln1"], c.norm_eps)
        q = torch.einsum("ble,ehd->bhld", h, p["wq"])        # [B, Hq, C, d]
        k = torch.einsum("ble,ehd->bhld", h, p["wk"])
        v = torch.einsum("ble,ehd->bhld", h, p["wv"])
        if c.use_rope:
            # the chunk's positions, read before the append moves seq_lens
            pos = cache.seq_lens[slots.long()][:, None] + torch.arange(
                tokens.shape[1], device=x.device)            # [B, C]
            q = rope(q, pos[:, None], c.rope_theta)
            k = rope(k, pos[:, None], c.rope_theta)
        # append first: the chunk reads itself back quantized, as decode does
        append_chunks(cache, slots, k.transpose(1, 2), v.transpose(1, 2))
        o = paged_extend_attention(q.transpose(1, 2).contiguous(), cache,
                                   slots, window=c.window)   # [B, C, Hq, d]
        x = x + torch.einsum("blhd,hde->ble", o.to(x.dtype), p["wo"])
        x = x + _mlp_block(p, x, c)
    xf = _rmsnorm(x, params["ln_f"], c.norm_eps)
    return torch.einsum("ble,ve->blv", xf, params["embed"].to(c.dtype)).float()


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling -> [B] int32."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class GenerationEngine:
    """Batch text generation over per-layer paged INT8 KV-caches, on the
    device of the parameters."""

    def __init__(
        self,
        params: Params,
        config: ModelConfig,
        max_seqs: int = 8,
        max_len: int = 2048,
        page_size: int = 128,
    ):
        self.params = params
        self.config = config
        self.device = params["embed"].device
        self.page_size = page_size
        pages_per_seq = cdiv(max_len, page_size)
        n_pages = max_seqs * pages_per_seq
        self.caches = [
            make_cache(
                config.n_kv_heads, config.d_head, n_pages,
                page_size=page_size, max_seqs=max_seqs,
                max_pages_per_seq=pages_per_seq, device=self.device,
            )
            for _ in range(config.n_layers)
        ]
        # all layers share one page map (identical table per layer)
        self.allocator = PageAllocator(n_pages)
        self.max_seqs = max_seqs
        self.pages_per_seq = pages_per_seq
        self._mapped_pages: List[int] = []
        self._held_slots: Optional[torch.Tensor] = None
        self._held_len = 0          # tokens in each held sequence's cache
        # what the decode graphs read stays in place: the slot ids of each
        # batch size, the generator (re-seeded per call) and the graphs
        self._slot_ids: Dict[int, torch.Tensor] = {}
        self._generator = torch.Generator(device=self.device)
        self._graphs: Dict[Tuple[int, float], StepGraph] = {}

    def _map_slots(self, bsz: int) -> torch.Tensor:
        # the table is built on the host and copied once per layer
        self._mapped_pages = []
        table = np.zeros((self.max_seqs, self.pages_per_seq), np.int32)
        for s in range(bsz):
            pages = self.allocator.alloc(self.pages_per_seq)
            self._mapped_pages.extend(pages)
            table[s, :len(pages)] = pages
        table_t = torch.from_numpy(table).to(self.device)
        for cache in self.caches:
            cache.page_table.copy_(table_t)
            cache.seq_lens.zero_()
        if bsz not in self._slot_ids:
            self._slot_ids[bsz] = torch.arange(bsz, dtype=torch.int32,
                                               device=self.device)
        return self._slot_ids[bsz]

    def _release_slots(self) -> None:
        self.allocator.free(self._mapped_pages)
        self._mapped_pages = []

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device)
        return torch.as_tensor(np.asarray(tokens), device=self.device)

    def _check_room(self, n_tokens: int) -> None:
        room = self.pages_per_seq * self.page_size
        if n_tokens > room:
            raise ValueError(f"{n_tokens} tokens per sequence exceed the "
                             f"{room} a slot holds (max_len)")

    def _decode(self, logits: torch.Tensor, slots: torch.Tensor,
                max_new_tokens: int, temperature: float) -> np.ndarray:
        """Sample from the last position's logits [B, V], then decode one
        token per step: [B, max_new_tokens] int32.  The newest sampled
        token is never fed into the cache.

        On the card the steps replay the CUDA graph of (batch size,
        temperature): :func:`_decode_forward` and :func:`sample` over a
        fixed token buffer.  A batch without a graph runs its first step
        eagerly (which builds and loads the kernels and reserves the
        decode tickets), then captures it; a failed capture raises."""
        gen = self._generator
        tok = sample(logits, temperature, gen)
        if self.device.type != "cuda":
            out = [tok]
            for _ in range(max_new_tokens - 1):
                logits = _decode_forward(self.params, tok, self.caches,
                                         slots, self.config)
                tok = sample(logits, temperature, gen)
                out.append(tok)
            return torch.stack(out, dim=1).cpu().numpy()
        out = torch.empty((tok.shape[0], max_new_tokens), dtype=torch.int32,
                          device=self.device)
        out[:, 0] = tok
        key, first = (tok.shape[0], temperature), 1
        graph = self._graphs.get(key)
        if graph is not None:
            graph.out.copy_(tok)
        elif max_new_tokens > 1:
            buf = tok.clone()

            def decode_step() -> torch.Tensor:
                logits = _decode_forward(self.params, buf, self.caches,
                                         slots, self.config)
                return buf.copy_(sample(logits, temperature, gen))

            out[:, 1] = decode_step()
            graph = self._graphs[key] = StepGraph(
                decode_step, self.device,
                generators=(gen,) if temperature else ())
            first = 2
        for i in range(first, max_new_tokens):
            out[:, i] = graph.replay()
        return out.cpu().numpy()

    @torch.no_grad()
    def generate(
        self,
        prompt,                     # [B, L_prompt] int (array or tensor)
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
        hold: bool = False,
    ) -> np.ndarray:
        """Returns the generated tokens [B, max_new_tokens] (int32).

        ``hold=True`` keeps the batch's cache slots mapped after the call,
        so :meth:`continue_generation` can extend the conversation without
        re-running the prompt; :meth:`release` frees them.  While slots are
        held, ``generate`` raises ``RuntimeError``.  An error during the
        call frees the slots."""
        prompt = self._tokens(prompt)
        bsz, l_prompt = prompt.shape
        if bsz > self.max_seqs:
            raise ValueError(f"batch {bsz} > max_seqs {self.max_seqs}")
        if self._held_slots is not None:
            raise RuntimeError("slots held: call release() first")
        self._check_room(l_prompt + max_new_tokens - 1)
        self._generator.manual_seed(seed)
        try:
            # inside the try so a partial allocation still gets freed
            slots = self._map_slots(bsz)
            logits, kvs = forward_collect_kv(self.params, prompt, self.config)
            for cache, (k, v) in zip(self.caches, kvs):
                append_prompts(cache, slots, k, v)
            result = self._decode(logits[:, -1, :], slots, max_new_tokens,
                                  temperature)
        except BaseException:
            self._release_slots()           # the engine stays reusable
            raise
        if hold:
            self._held_slots = slots
            self._held_len = l_prompt + max_new_tokens - 1
        else:
            self._release_slots()
        return result

    @torch.no_grad()
    def continue_generation(
        self,
        new_tokens,                 # [B, C] int: the next turn
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 1,
    ) -> np.ndarray:
        """Multi-turn continuation over the held slots: the new turn's
        tokens attend to the existing cache through the paged extend kernel
        (no recompute of the history), then decoding proceeds as in
        :meth:`generate`.  Returns [B, max_new_tokens] (int32).

        The turn starts with the previous call's last token, which was
        never fed into the cache.  Without held slots this raises
        ``RuntimeError``; a batch other than the held one, or a turn that
        would overflow a slot, raises ``ValueError`` and leaves the slots
        held.  An error during the call frees them."""
        if self._held_slots is None:
            raise RuntimeError("no held slots: generate(..., hold=True) first")
        slots = self._held_slots
        new_tokens = self._tokens(new_tokens)
        if new_tokens.shape[0] != slots.shape[0]:
            raise ValueError(f"batch {new_tokens.shape[0]} does not match "
                             f"the {slots.shape[0]} held slots")
        length = self._held_len + new_tokens.shape[1] + max_new_tokens - 1
        self._check_room(length)
        self._generator.manual_seed(seed)
        try:
            logits = _extend_forward(self.params, new_tokens, self.caches,
                                     slots, self.config)
            result = self._decode(logits[:, -1, :], slots, max_new_tokens,
                                  temperature)
        except BaseException:
            self.release()
            raise
        self._held_len = length
        return result

    def release(self) -> None:
        """Free the slots held by ``generate(..., hold=True)``."""
        if self._held_slots is not None:
            self._held_slots = None
            self._release_slots()
