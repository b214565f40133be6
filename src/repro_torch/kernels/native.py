"""Build, load and launch the package's hand-written CUDA kernels.

The kernels live in ``repro_torch/csrc/*.cu`` as plain C entry points.
At first use :func:`load_library` compiles the sources with one
``nvcc -shared`` call for ``sm_90a`` into a shared library under
``repro_torch/_build/`` and loads it with ``ctypes``.  The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time: this module imports on hosts without
CUDA, and only a launch needs the toolkit.

:func:`launch` is the one place a kernel is started.  It runs the C
entry point on PyTorch's current stream, raises if the entry point
reports a CUDA error, and adds one to that kernel's launch count in
:data:`KERNELS` — so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class KernelInfo:
    """One CUDA kernel of the port and the TPU kernel it replaces."""

    name: str
    source: str          # repo-relative path of the CUDA source
    replaces: str        # file:line of the Pallas kernel it replaces
    launches: int = 0


_SOURCE = "src/repro_torch/csrc/stage_kernels.cu"

#: Every kernel this package launches, by C entry-point stem.
KERNELS: dict[str, KernelInfo] = {
    "reduce": KernelInfo(
        "K1 reduce", _SOURCE,
        "src/repro/kernels/codegen/stages.py:82"),
    "product": KernelInfo(
        "K2 product", _SOURCE,
        "src/repro/kernels/codegen/stages.py:155"),
    "splitk": KernelInfo(
        "K4 split-K partials", _SOURCE,
        "src/repro/kernels/codegen/lower_gpu.py:61"),
    "combine": KernelInfo(
        "K4 segment combine", _SOURCE,
        "src/repro/kernels/codegen/lower_gpu.py:109"),
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signatures, in the order of the entry points in csrc/stage_kernels.cu
# (every pointer and the stream as c_void_p, or ctypes would cut them)
_SIGNATURES = {
    "reduce": [_P, _L, _P, _L, _P, _P, _L, _I, _P, _P, _P, _I, _I, _P, _P],
    "splitk": [_P, _L, _P, _L, _P, _L, _I, _P, _P, _P, _I, _I, _P, _P],
    "product": [_P, _L, _P, _L, _L, _P, _P, _P, _I, _I, _P, _P],
    "combine": [_P, _P, _L, _I, _P, _P],
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {stem: k.launches for stem, k in KERNELS.items()}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return nvcc


def build() -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` into one shared library (reused when the
    sources and flags are unchanged).  Returns its path, the seconds
    spent building (0.0 when it was reused) and the compiler's report."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    lib = BUILD_DIR / f"libspttn_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", *map(str, sources),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"kernel build failed:\n$ {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)           # atomic: concurrent builders agree
    return lib, time.perf_counter() - t0, proc.stdout


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for stem, argtypes in _SIGNATURES.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"spttn_{stem}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def check_cuda_tensors(*tensors: torch.Tensor, dtype=None) -> None:
    """Raise unless every tensor is contiguous and on the first one's
    CUDA device (and, with ``dtype``, of that type)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"a CUDA kernel needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("a CUDA kernel needs contiguous tensors")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"expected {dtype}, got {t.dtype}")


def launch(stem: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Launch kernel ``stem`` in precision ``dtype`` on ``device``'s
    current stream.  ``args`` are the C arguments before the stream
    (tensors are passed by their data pointers)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"the CUDA kernels take float32 or float64, "
                        f"got {dtype}")
    fn = getattr(load_library(), f"spttn_{stem}_{_SUFFIX[dtype]}")
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        err = fn(*c_args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"CUDA kernel spttn_{stem}_{_SUFFIX[dtype]} "
                           f"failed to launch: cudaError {err}")
    KERNELS[stem].launches += 1


def column_threads(width: int) -> int:
    """Threads over output columns in a 256-thread block: the smallest
    power of two covering ``width``, at most 256 (the rest of the block
    splits fibers)."""
    tx = 1
    while tx < min(width, 256):
        tx *= 2
    return tx


def check_grid(x: int, y: int) -> None:
    """CUDA caps grid.x at 2**31 - 1 and grid.y at 65535."""
    if x >= 2**31 or y > 65535:
        raise ValueError(f"launch grid ({x}, {y}) exceeds the CUDA limits")
