"""Build, load and launch the package's hand-written CUDA kernels.

The kernels live in ``repro_torch/csrc/*.cu`` as plain C entry points.
At first use :func:`load_library` compiles each source with its own
``nvcc -c`` for ``sm_90a`` (all started together), links the objects
into one shared library under ``repro_torch/_build/`` and loads it with
``ctypes``.  The library's name carries a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged tree is reused.
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
    """One CUDA kernel of the port, the TPU kernel it replaces, and the
    precisions it has entry points for."""

    name: str
    source: str          # repo-relative path of the CUDA source
    replaces: str        # file:line of the Pallas kernel it replaces
    dtypes: tuple[torch.dtype, ...] = (torch.float32, torch.float64)
    launches: int = 0


_SOURCE = "src/repro_torch/csrc/stage_kernels.cu"
_PAPER = "src/repro_torch/csrc/paper_kernels.cu"
_LM = "src/repro_torch/csrc/lm_kernels.cu"
_LM_DTYPES = (torch.float32, torch.bfloat16)

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
    "chain": KernelInfo(
        "K3 fused chain", _SOURCE,
        "src/repro/kernels/codegen/stages.py:198"),
    "mttkrp": KernelInfo(
        "K5 mttkrp", _PAPER, "src/repro/kernels/mttkrp.py:41"),
    "ttmc": KernelInfo(
        "K6 ttmc", _PAPER, "src/repro/kernels/ttmc.py:33"),
    "tttp": KernelInfo(
        "K7 tttp", _PAPER, "src/repro/kernels/tttp.py:24"),
    "grouped_matmul": KernelInfo(
        "K8 grouped_matmul", _LM,
        "src/repro/kernels/grouped_matmul.py:39", _LM_DTYPES),
    "local_attn": KernelInfo(
        "K9 local_attn", _LM, "src/repro/kernels/local_attn.py:66",
        _LM_DTYPES),
    "wkv6": KernelInfo(
        "K10 wkv6", _LM, "src/repro/kernels/wkv6.py:44", _LM_DTYPES),
    "rglru": KernelInfo(
        "K11 rglru", _LM, "src/repro/kernels/rglru.py:38", _LM_DTYPES),
}

#: Shared memory one thread block may use on the H100 (227 KB, above
#: 48 KB only after ``cudaFuncSetAttribute``, which the entry points do).
MAX_SHARED_BYTES = 232448

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)

# C signatures of the entry points in csrc/*.cu (every pointer and the
# stream as c_void_p, or ctypes would cut them)
_SIGNATURES = {
    "reduce": [_P, _L, _P, _L, _P, _P, _L, _I, _P, _P, _P, _I, _I, _P, _P],
    "splitk": [_P, _L, _P, _L, _P, _L, _I, _P, _P, _P, _I, _I, _P, _P],
    "product": [_P, _I, _I, _I, _P, _I, _I, _I, _L, _I, _P, _P, _P, _I, _I,
                _I, _I, _I, _I, _P, _P],
    "combine": [_P, _P, _L, _I, _P, _P],
    "chain": [_P, _L, _P, _L, _P, _I, _P, _P, _P, _I, _I, _I, _P, _L, _P,
              _P, _L, _I, _I, _P, _P],
    "mttkrp": [_P, _P, _P, _P, _P, _L, _I, _I, _P, _P],
    "ttmc": [_P, _P, _P, _L, _I, _I, _I, _I, _P, _P],
    "tttp": [_P, _P, _P, _P, _L, _I, _I, _P, _P],
    "grouped_matmul": [_P, _P, _L, _I, _I, _I, _P, _P],
    "local_attn": [_P, _P, _P, _L, _I, _I, _I, _F, _P, _P],
    "wkv6": [_P, _P, _P, _P, _P, _L, _I, _I, _P, _P],
    "rglru": [_P, _P, _L, _I, _I, _P, _P],
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}


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


def _run(cmds: list[list[str]]) -> str:
    """Run the commands all at once; raise with the output of the first
    that fails, else return their outputs joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode:
            raise RuntimeError(f"kernel build failed:\n$ {' '.join(cmd)}"
                               f"\n{out}")
    return "".join(outs)


def source_digest(csrc: Path = CSRC_DIR) -> str:
    """The first 16 hex digits of a hash of the flags and of every source
    and header in ``csrc`` (``*.cu``, ``*.cuh``): the build's name, so
    that an edit of either is rebuilt."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        digest.update(src.name.encode() + src.read_bytes())
    return digest.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` into one shared library (reused when the
    sources and flags are unchanged): one ``nvcc -c`` per source, all
    started together, then one link.  Returns the library's path, the
    seconds spent building (0.0 when it was reused) and the compiler's
    report."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = source_digest()
    lib = BUILD_DIR / f"libspttn_{digest}.so"
    if lib.exists():
        return lib, 0.0, ""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    report = _run([[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                   for src, obj in zip(sources, objs)])
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    report += _run([[_nvcc(), *NVCC_FLAGS, "-shared", *map(str, objs),
                     "-o", str(tmp)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)           # atomic: concurrent builders agree
    return lib, time.perf_counter() - t0, report


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for stem, argtypes in _SIGNATURES.items():
        for dtype in KERNELS[stem].dtypes:
            fn = getattr(lib, f"spttn_{stem}_{_SUFFIX[dtype]}")
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


def check_dtype(stem: str, dtype: torch.dtype) -> None:
    """Raise ``TypeError`` unless kernel ``stem`` has an entry point in
    precision ``dtype`` (no kernel falls back to another precision)."""
    have = KERNELS[stem].dtypes
    if dtype not in have:
        names = " or ".join(str(d).removeprefix("torch.") for d in have)
        raise TypeError(f"the CUDA kernel {stem!r} takes {names}, "
                        f"got {dtype}")


def launch(stem: str, dtype: torch.dtype, device: torch.device,
           *args) -> None:
    """Launch kernel ``stem`` in precision ``dtype`` on ``device``'s
    current stream.  ``args`` are the C arguments before the stream
    (tensors are passed by their data pointers).  A precision the
    kernel has no entry point for raises ``TypeError``."""
    check_dtype(stem, dtype)
    fn = getattr(load_library(), f"spttn_{stem}_{_SUFFIX[dtype]}")
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    else:
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


def check_grid(x: int, y: int, z: int = 1) -> None:
    """CUDA caps grid.x at 2**31 - 1 and grid.y and grid.z at 65535."""
    if x >= 2**31 or y > 65535 or z > 65535:
        raise ValueError(f"launch grid ({x}, {y}, {z}) exceeds the CUDA "
                         f"limits")
