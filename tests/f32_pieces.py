"""The f32 core's arithmetic (``csrc/f32_attention.cuh``) in torch ops, for
the CPU tests that emulate the port's f32 kernels: every f32 operand split
exactly into three bf16 pieces (hi, mid, lo), a product the sum of the
piece products, smallest first; and the one-thread fixture of the test
files that run those emulations."""

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
