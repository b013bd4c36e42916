"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into
``build/kernels/lib<name>-<hash>.so`` (plain C interface, no PyTorch headers,
so a build takes seconds) and loaded with ``ctypes``.  The hash covers the
source, the shared header and the flags, so an edit rebuilds and an
unchanged tree reuses the library.  Nothing builds at import: the first
kernel call builds every missing library, all ``nvcc`` processes at once.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the serving
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "aebs", "expert_ffn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {
    "paged_decode_attention": 0,
    "decode_attention": 0,
    "decode_attention_int8": 0,
    "aebs_schedule": 0,
    "expert_ffn": 0,
}
BUILD_LOG: Dict[str, str] = {}  # nvcc/ptxas output of the builds this process ran

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}

# argument type shorthands for the launchers' declarations
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update((CSRC / "common.cuh").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every library that is missing, one ``nvcc`` per source, all
    started together.  Returns the wall seconds spent; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, proc, tmp, out))
    errors: List[str] = []
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [INT]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(source: str, symbol: str, argtypes: Sequence):
    """A declared launcher from ``csrc/<source>.cu`` (returns a cudaError_t)."""
    key = (source, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(library(source), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = INT
        _FNS[key] = fn
    return fn


def check(source: str, err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = library(source).repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: a launch
    through ``ctypes`` returns a tensor with no ``grad_fn``, and the kernels
    have no backward pass, so such a result must never pass as one.  The
    float kernels' wrappers (K1, K3, K4, K5) call it; K2 takes int32 tensors
    alone, which cannot require grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward pass; call it under torch.no_grad() "
                           "or on tensors that do not require grad (training runs the einsum dispatch)")


def check_tensors(tensors: Dict[str, torch.Tensor], device: torch.device) -> None:
    """Every tensor a launcher reads or writes: on ``device`` and contiguous."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]
