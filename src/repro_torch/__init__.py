"""PyTorch/CUDA port of the Janus serving stack (``repro``) for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``configs/``, ``core/``,
``kernels/<name>/``, ``models/``, ``serving/``) so each counterpart sits at
the same path, but imports nothing of it: it is held against ``repro`` by the
``tests/test_torch_*.py`` parity tests, which pass numpy arrays between the
two.  Plain tensor code is PyTorch; the three kernels on the serving path
(paged decode attention, AEBS, grouped expert FFN) are hand-written CUDA
C++ under ``csrc/``, built with ``nvcc`` at first use.
"""
