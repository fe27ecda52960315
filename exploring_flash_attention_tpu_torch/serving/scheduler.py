"""Continuous-batching decode scheduler of the port over the paged INT8
KV cache.

Counterpart of ``serving/scheduler.py`` in the JAX package.  The scheduler
owns cache slots and pages: a request joins the running batch as soon as
a slot and its pages are free (no static batch barrier), every decode
step runs the paged decode kernel (H6-decode) over all active sequences at
once, and a finished sequence frees its pages at once.  It is
model-agnostic: each request brings its prompt K/V and a per-step input
callback (in an LM, the QKV projection of the last sampled token).

A step always runs at the full capacity (``max_seqs`` rows): the rows of
no active sequence append through an out-of-range slot id, which
``append_tokens`` drops, and decode against the permanently empty pad
slot, which gives zeros.  So the step's shapes never change, and on the
card it is one CUDA graph (``graphs.StepGraph``), captured after the
first step and replayed every step after: the JAX package's one device
dispatch a step.  The step inputs are staged into fixed buffers first, q
in bf16, the only q that H6-decode takes (``ROADMAP.md`` B.1 item 3), on
the CPU as on the card, so both round q alike.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.configs import cdiv
from exploring_flash_attention_tpu_torch.graphs import StepGraph
from exploring_flash_attention_tpu_torch.serving.decode import (
    paged_decode_attention,
)
from exploring_flash_attention_tpu_torch.serving.kv_cache import (
    PageAllocator,
    PagedKVCache,
    append_prompts,
    append_tokens,
    make_cache,
)

# step_idx -> (q [Hq, d], k_new [Hkv, d], v_new [Hkv, d])
StepInputFn = Callable[[int], Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]


def _fused_step(cache: PagedKVCache, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, append_ids: torch.Tensor,
                decode_slots: torch.Tensor) -> torch.Tensor:
    """One decode step at the scheduler's capacity C: append this step's
    K/V ([C, Hkv, d]; rows on an out-of-range id are dropped), then attend
    with q (bf16 [C, Hq, d]) over the paged history of ``decode_slots``
    (one H6-decode launch on the card): o bf16 [C, Hq, d].  The cache is
    written in place.  On the card the scheduler captures this call, on
    its fixed buffers, as its step's CUDA graph."""
    append_tokens(cache, append_ids, k, v)
    return paged_decode_attention(q, cache, decode_slots)


@dataclasses.dataclass
class Request:
    rid: int
    prompt_k: torch.Tensor        # [L, Hkv, d]
    prompt_v: torch.Tensor
    max_new_tokens: int
    step_inputs: StepInputFn


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    pages: List[int]
    tokens_done: int = 0


@dataclasses.dataclass
class _StepBuffers:
    """The fused step's fixed inputs: what its CUDA graph reads."""
    q: torch.Tensor               # bf16 [C, Hq, d]
    k: torch.Tensor               # [C, Hkv, d], the step inputs' dtype
    v: torch.Tensor
    append_ids: torch.Tensor      # int32 [C]
    decode_slots: torch.Tensor    # int32 [C]


class ContinuousBatchingScheduler:
    """Continuous batching over one paged INT8 cache, on ``device`` (the
    card by default; ``device="cpu"`` runs the plain versions, where the
    JAX package takes ``interpret``)."""

    def __init__(
        self,
        num_q_heads: int,
        num_kv_heads: int,
        head_dim: int,
        n_pages: int = 256,
        page_size: int = 128,
        max_seqs: int = 16,
        max_pages_per_seq: Optional[int] = None,
        device: torch.device | str = "cuda",
    ):
        self.num_q_heads = num_q_heads
        # one extra slot beyond capacity: the permanently empty PAD slot
        # that the step's inactive rows decode against (its length stays
        # 0, so the decode kernel gives zeros for them)
        self.capacity = max_seqs
        self.pad_slot = max_seqs
        self.cache = make_cache(
            num_kv_heads, head_dim, n_pages, page_size,
            max_seqs=max_seqs + 1, max_pages_per_seq=max_pages_per_seq,
            device=device,
        )
        self.device = self.cache.kv_pages.device
        self.allocator = PageAllocator(n_pages)
        self.free_slots: Deque[int] = deque(range(max_seqs))
        self.pending: Deque[Request] = deque()
        self.active: Dict[int, _Active] = {}
        self.completed: Dict[int, int] = {}      # rid -> tokens generated
        self._bufs: Optional[_StepBuffers] = None
        self._out_dtype: Optional[torch.dtype] = None
        # the slot ids are rewritten only when the batch changes
        self._slot_key: Optional[Tuple[int, ...]] = None
        self._graph: Optional[StepGraph] = None

    # ---------------- submission / admission ----------------

    def submit(self, req: Request) -> None:
        need = self._pages_needed(req)
        if need > self.allocator.n_pages:
            raise ValueError(
                f"request {req.rid} needs {need} pages but the cache only has "
                f"{self.allocator.n_pages} — it could never be admitted"
            )
        if need > self.cache.max_pages_per_seq:
            raise ValueError(
                f"request {req.rid} needs {need} pages > max_pages_per_seq "
                f"{self.cache.max_pages_per_seq}"
            )
        self.pending.append(req)

    def _pages_needed(self, req: Request) -> int:
        total = req.prompt_k.shape[0] + req.max_new_tokens
        return cdiv(total, self.cache.page_size)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device, copied from pinned memory without waiting
        for the steps already queued."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _try_admit(self) -> None:
        admitted: List[Tuple[Request, int, List[int]]] = []
        while self.pending:
            req = self.pending[0]
            need = self._pages_needed(req)
            if not self.free_slots or need > self.allocator.free_pages:
                break
            self.pending.popleft()
            slot = self.free_slots.popleft()
            pages = self.allocator.alloc(need)
            admitted.append((req, slot, pages))
        if not admitted:
            return
        # ONE batched page-table and length update for every admission of
        # this round
        rows = np.zeros((len(admitted), self.cache.max_pages_per_seq),
                        np.int32)
        for i, (_, _, pages) in enumerate(admitted):
            rows[i, :len(pages)] = pages
        ids = self._upload(np.array([s for _, s, _ in admitted], np.int32))
        rows_dev = self._upload(rows)
        self.cache.page_table[ids.long()] = rows_dev
        self.cache.seq_lens[ids.long()] = 0
        for i, (req, slot, pages) in enumerate(admitted):
            # the batched append (B=1) onto the allocator's pages, which
            # the uploaded rows already hold
            npg = cdiv(req.prompt_k.shape[0], self.cache.page_size)
            append_prompts(self.cache, ids[i:i + 1], req.prompt_k[None],
                           req.prompt_v[None], rows_dev[i:i + 1, :npg])
            self.active[slot] = _Active(req=req, slot=slot, pages=pages)

    # ---------------- decode step ----------------

    def _buffers(self, q: torch.Tensor, k: torch.Tensor) -> _StepBuffers:
        if self._bufs is None:
            cap, dev = self.capacity, self.device
            self._out_dtype = q.dtype
            self._bufs = _StepBuffers(
                q=torch.zeros((cap, *q.shape), dtype=torch.bfloat16,
                              device=dev),
                k=torch.zeros((cap, *k.shape), dtype=k.dtype, device=dev),
                v=torch.zeros((cap, *k.shape), dtype=k.dtype, device=dev),
                append_ids=torch.zeros(cap, dtype=torch.int32, device=dev),
                decode_slots=torch.zeros(cap, dtype=torch.int32, device=dev))
        return self._bufs

    def _run_fused_step(self) -> torch.Tensor:
        b = self._bufs

        def fused():
            return _fused_step(self.cache, b.q, b.k, b.v, b.append_ids,
                               b.decode_slots)

        if self.device.type != "cuda":
            return fused()
        if self._graph is None:
            # the first step runs eagerly: it builds and loads the kernels
            # and reserves the tickets, which the capture needs
            out = fused()
            self._graph = StepGraph(fused, self.device)
            return out
        return self._graph.replay()

    def step(self, sync: bool = True):
        """Admit what fits, run one batched decode step, retire finished.

        Returns ``[(rid, attention_output [Hq, d])]`` for this step, each
        output an f32 NumPy array (bf16-rounded values: the kernel's O).

        ``sync=False`` returns ``(rids, out)`` instead, ``out`` the device
        tensor [capacity, Hq, d] in the step inputs' dtype, whose first
        ``len(rids)`` rows are the rids' outputs: no host round trip, so
        steps queue on the device.  ``out`` is a copy of its own, which
        later steps leave alone.  Retirement does not depend on the output
        values, so it proceeds either way."""
        self._try_admit()
        if not self.active:
            return [] if sync else ([], None)

        slots = sorted(self.active.keys())
        qs, ks, vs = zip(*(self.active[s].req.step_inputs(
            self.active[s].tokens_done) for s in slots))
        b = self._buffers(qs[0], ks[0])
        n_act = len(slots)
        key = tuple(slots)
        if key != self._slot_key:
            append_ids = np.full(self.capacity, self.pad_slot + 1, np.int32)
            append_ids[:n_act] = slots           # out of range => dropped
            decode_slots = np.full(self.capacity, self.pad_slot, np.int32)
            decode_slots[:n_act] = slots
            b.append_ids.copy_(self._upload(append_ids))
            b.decode_slots.copy_(self._upload(decode_slots))
            for t in (b.q, b.k, b.v):            # the pad rows: zeros
                t[n_act:].zero_()
            self._slot_key = key
        b.q[:n_act].copy_(torch.stack(qs))       # rounds q to bf16
        b.k[:n_act].copy_(torch.stack(ks))
        b.v[:n_act].copy_(torch.stack(vs))
        out = self._run_fused_step().to(self._out_dtype, copy=True)

        rids = []
        for s in slots:
            a = self.active[s]
            a.tokens_done += 1
            rids.append(a.req.rid)
            if a.tokens_done >= a.req.max_new_tokens:
                self._retire(s)
        if not sync:
            return rids, out
        out_np = out.float().cpu().numpy()
        return [(rid, out_np[i]) for i, rid in enumerate(rids)]

    def _retire(self, slot: int) -> None:
        a = self.active.pop(slot)
        self.allocator.free(a.pages)
        self.free_slots.append(slot)
        self.completed[a.req.rid] = a.tokens_done

    # ---------------- introspection ----------------

    @property
    def num_active(self) -> int:
        return len(self.active)

    @property
    def num_pending(self) -> int:
        return len(self.pending)

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, int]:
        steps = 0
        while (self.pending or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.completed)
