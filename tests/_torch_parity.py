"""Shared tolerances and helpers for the PyTorch port's parity tests
(``tests/test_torch_*.py``).  Inputs are made from a seed with numpy and fed
to both the reference (JAX) function and its port; outputs are compared here.
"""

import functools

import numpy as np
import torch

# One table for every comparison between the port and the reference.
TOL = {
    "f32_op": 1e-5,  # one op in float32 (atol = rtol)
    "f32_layer": 1e-4,  # a layer or a whole step's logits in float32
    "bf16": 3e-2,  # anything in bfloat16 (as tests/test_kernels.py uses)
}
# integers (slot ids, loads, act_rep, dispatch plans, block tables,
# allocator state) are compared exactly.


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x).astype(np.float32)


def as_int(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def tol_for(dtype: str, level: str = "op") -> float:
    return TOL["bf16"] if dtype == "bfloat16" else TOL[f"f32_{level}"]


def assert_close(got, want, tol: float) -> None:
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=tol, rtol=tol)


# One bf16 rounding of an f32 result: an ulp is at most 2^-7 of the value, and
# f32 summation-order noise is kept under 2^-12 of the largest output.
ROUNDING_REL, ROUNDING_FLOOR = 2.0**-7, 2.0**-12


def rounding_excess(got, want) -> float:
    """Largest ``|got - want|`` over what one bf16 rounding of the same f32
    result allows (``ROUNDING_REL |want| + ROUNDING_FLOOR max|want|``): at most
    1 when both sides compute in f32 and round once.  Unlike ``TOL["bf16"]``
    it scales with the output, so it holds outputs of ~0.01 (attention over
    tens of thousands of rows) to a few of their ulps."""
    g, w = as_f32(got), as_f32(want)
    allow = ROUNDING_REL * np.abs(w) + ROUNDING_FLOOR * np.abs(w).max()
    return float((np.abs(g - w) / np.maximum(allow, 1e-30)).max())


def assert_one_rounding(got, want) -> None:
    excess = rounding_excess(got, want)
    assert excess <= 1.0, f"differs by {excess:.3g}x what one bf16 rounding allows"


def nan_past_lengths(k_pages, v_pages, block_tables, lengths):
    """Copies of a paged pool's K and V with every row at or past each
    slot's length set to NaN, in every page of its table (the last live
    page's tail and the stale pages after it): a kernel that lets a masked
    row reach its output turns it NaN."""
    k, v = k_pages.clone(), v_pages.clone()
    ps = k.shape[1]
    bt = block_tables.long().cpu()
    for b, n in enumerate(lengths.cpu().tolist()):
        rows = torch.arange(n, bt.shape[1] * ps)
        pages, offs = bt[b, rows // ps].to(k.device), (rows % ps).to(k.device)
        k[pages, offs] = float("nan")
        v[pages, offs] = float("nan")
    return k, v


def assert_equal_int(got, want) -> None:
    np.testing.assert_array_equal(as_int(got), as_int(want))


def first_divergence(a, b):
    """Index of the first differing element of two token streams, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


@functools.lru_cache(maxsize=None)
def gemm_rows_bitwise(total: int, rows: int, widths: tuple) -> bool:
    """Whether this host's float32 matrix product gives the first ``rows``
    rows of a ``total``-row product bit for bit when it is given those rows
    alone: ``x[:rows] @ w == (x @ w)[:rows]`` for every ``(K, N)`` in
    ``widths``.  Torch's CPU GEMM picks its kernel and blocking by the row
    count, and on some hosts a product of 1-3 rows rounds other than the
    same rows of a 6-row product, so a sharded step can equal the unsharded
    one bitwise on one host and only to float32 rounding on another."""
    gen = torch.Generator().manual_seed(0)
    for k, n in widths:
        x = torch.randn((total, k), generator=gen)
        w = torch.randn((k, n), generator=gen)
        if not torch.equal(x[:rows] @ w, (x @ w)[:rows]):
            return False
    return True


def matmul_widths(tree) -> tuple:
    """The ``(K, N)`` a step may multiply by, from a parameter tree: each
    weight of two or more axes split after its first axis and before its
    last (``[d, nh, hd]`` is a ``d x nh*hd`` product, ``[nh, hd, d]`` an
    ``nh*hd x d`` one)."""
    out = set()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor) and t.dim() >= 2:
            shape = [int(n) for n in t.shape]
            out.add((shape[0], int(np.prod(shape[1:]))))
            out.add((int(np.prod(shape[:-1])), shape[-1]))

    walk(tree)
    return tuple(sorted(out))
