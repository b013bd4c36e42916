"""The serving path's CUDA kernels (``csrc/``), each wrapper beside its plain version."""
