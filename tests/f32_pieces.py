"""The f32 core's arithmetic (``csrc/f32_attention.cuh``) in torch ops, for
the CPU tests that emulate the port's f32 kernels: every f32 operand split
exactly into three bf16 pieces (hi, mid, lo), a product the sum of the
piece products, smallest first; a model of how the tensor core adds them
into its accumulator; and the one-thread fixture of the test files that
run those emulations."""

import pytest
import torch

# the f32 core's piece products (A piece, B piece), 0 hi, 1 mid, 2 lo, the
# smallest first: bf16x6, and bf16x3 where B is exact in bf16 (one piece)
BF16X6 = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
BF16X3 = ((2, 0), (1, 0), (0, 0))


def split3(x):
    """x (f32) as three bf16 pieces held in f32, hi + mid + lo = x: each
    difference is exact in f32."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def piece_products(acc, a, b, terms):
    """acc plus a @ b as the f32 core computes it: the piece products of
    ``terms`` added to acc one by one (b whole for bf16x3)."""
    pa = split3(a)
    pb = split3(b) if terms is BF16X6 else (b,)
    for i, j in terms:
        acc = acc + pa[i] @ pb[j]
    return acc


def tc_add(acc, term):
    """acc + term as Hopper's tensor core adds a product into its f32
    accumulator, under a model: the bits of ``term`` below the last bit of
    the accumulator's f32 value (2^(e - 24) for |acc| in [2^(e-1), 2^e))
    are dropped, toward zero, and the sum is rounded to f32; into a zero
    accumulator the term goes whole.  The model is this repo's reading of
    what the card showed, not NVIDIA's description: H3 at f32 with one
    accumulator over hundreds of stages read 8.9e-5 of max|dV|, with a
    fresh accumulator a stage added in f32 2.8e-6 (PERF.md section 6, PRs
    17-18; the comment of ``issue_part_f32`` in
    ``csrc/attention_bwd.cu``)."""
    _, e = torch.frexp(acc)
    last = torch.ldexp(torch.ones_like(acc, dtype=torch.float64), e - 24)
    t = term.double()
    kept = torch.where(acc != 0, torch.trunc(t / last) * last, t)
    return (acc.double() + kept).float()


def tc_piece_products(acc, a, b, terms, k_step=16):
    """acc plus a @ b as the f32 core issues it on the tensor core, each
    add under :func:`tc_add`: per piece product of ``terms`` (smallest
    first) and per wgmma k-step of ``k_step`` along the contraction, that
    step's exact products summed and added to the accumulator.  ``acc``
    None is a fresh accumulator, which the first step writes (scale-d 0)."""
    pa = split3(a)
    pb = split3(b) if terms is BF16X6 else (b,)
    for i, j in terms:
        for c in range(0, a.shape[-1], k_step):
            step = (pa[i][..., c:c + k_step].double()
                    @ pb[j][..., c:c + k_step, :].double())
            acc = step.float() if acc is None else tc_add(acc, step)
    return acc


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The emulations run thousands of small torch ops: one intra-op
    thread each.  Beside the suite's other workers, a pool of one thread
    per core in every worker oversubscribes the cores, and each small op
    then waits on its pool.  Autouse in each test file that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
