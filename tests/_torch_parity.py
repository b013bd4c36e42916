"""Shared tolerances and helpers for the PyTorch port's parity tests
(``tests/test_torch_*.py``).  Inputs are made from a seed with numpy and fed
to both the reference (JAX) function and its port; outputs are compared here.
"""

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


def assert_equal_int(got, want) -> None:
    np.testing.assert_array_equal(as_int(got), as_int(want))


def first_divergence(a, b):
    """Index of the first differing element of two token streams, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))
