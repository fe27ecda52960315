"""CUDA graphs of the port's decode steps.

The JAX package runs a decode step as one device dispatch: the
scheduler's ``_fused_step`` is one ``jax.jit`` with the cache donated
(``serving/scheduler.py:41-55``), and generation one ``jax.jit`` around a
``lax.scan`` (``models/generate.py:355-395``).  The port's counterpart is
a CUDA graph: a step's launches captured once and replayed, one host call
a step (:class:`StepGraph`).

The kernel wrappers count launches with a Python increment at call time,
which a replay never reaches.  A :class:`StepGraph` takes back what its
capture added to the counters (nothing ran then) and adds, at each
replay, the launches its graph holds, so the counters count the kernels'
launches whichever way a step runs.
"""

from __future__ import annotations

from typing import Callable, Generic, Sequence, TypeVar

import torch

T = TypeVar("T")


def launch_counted():
    """Every kernel wrapper of the port, each counting its launches in its
    ``launches`` attribute.  (Imported here, not at the top: the serving
    package imports this module.)"""
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        flash_attention_int8,
        flash_attention_kvquant,
        flash_attention_v1_dtiled,
        prefill_attention,
        splitkv_combine,
    )
    from exploring_flash_attention_tpu_torch.serving.decode import (
        paged_decode_partials,
        paged_extend_attention,
    )
    return (prefill_attention, splitkv_combine, paged_decode_partials,
            paged_extend_attention, attention_bwd_dkv, attention_bwd_dq,
            flash_attention_kvquant, flash_attention_int8,
            flash_attention_v1_dtiled)


class StepGraph(Generic[T]):
    """``step()`` captured as one CUDA graph on ``device``; :meth:`replay`
    runs it again and returns the same output tensors, rewritten.

    The caller has run ``step`` once eagerly on the same tensors (which
    builds and loads the kernels, and sizes the H6-decode tickets with
    ``reserve_tickets``), and keeps every tensor the step reads alive and
    in place: the graph holds their addresses.  ``generators`` are the
    ``torch.Generator`` objects the step draws from; a replay draws the
    numbers that the generator's state then gives.  A capture that fails
    raises; nothing falls back to running eagerly.  The graph keeps a
    reference to the tickets buffer it captured (``tickets``)."""

    def __init__(self, step: Callable[[], T], device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        from exploring_flash_attention_tpu_torch.serving.decode import (
            ticket_buffer,
        )
        counted = launch_counted()
        before = [fn.launches for fn in counted]
        try:
            with torch.cuda.graph(self.graph):
                self.out: T = step()
        finally:
            captured = [fn.launches - n for fn, n in zip(counted, before)]
            for fn, n in zip(counted, before):
                fn.launches = n             # the capture launched nothing
        self.launches = {fn: n for fn, n in zip(counted, captured) if n}
        self.tickets = ticket_buffer(device)

    def replay(self) -> T:
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self.out
