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


def assert_equal_int(got, want) -> None:
    np.testing.assert_array_equal(as_int(got), as_int(want))


def first_divergence(a, b):
    """Index of the first differing element of two token streams, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))
