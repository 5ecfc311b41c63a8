"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface under the checkout's git-ignored ``build/`` directory,
at first use, and is loaded with ``ctypes``.  Every pointer and the CUDA
stream cross as ``c_void_p``; each C entry point returns
``cudaGetLastError()`` after its launch and the caller raises on a
non-zero code.  Nothing here runs at import time: the CPU-only test
machines import every module and have no ``nvcc``.  The binding helpers
the wrappers share (:func:`ptr`, :func:`stream_of`,
:func:`check_operand`, :func:`check`) live here too.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = (
    "fused_polymul", "fused_e2e_polymul",
    "ntt_channels", "intt_channels", "decompose", "compose", "attention",
    "fused_polymul_fs", "ntt_channels_fs", "intt_channels_fs", "fused_e2e_polymul_fs",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def ptxas_report(name: str) -> Path:
    """Where the build keeps ``-Xptxas -v``'s registers/smem/spill lines."""
    return BUILD_DIR / f"{name}.ptxas.txt"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build(names=SOURCES) -> dict[str, float]:
    """Compile every stale source in ``names``: one ``nvcc`` process per
    source, all started together.  Returns the wall seconds of each build
    that ran; raises with the compiler output if any fails (and stops the
    others)."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    try:
        for name in todo:
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
            )
        seconds = {}
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
            ptxas_report(name).write_text(out)
            os.replace(tmp, library_path(name))
        return seconds
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``lib<name>.so`` with its argument
    types declared, building the library first if it is missing or older
    than its sources."""
    key = (name, symbol)
    with _lock:
        fn = _fns.get(key)
        if fn is not None:
            return fn
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            lib.parentt_error_string.argtypes = [ctypes.c_int]
            lib.parentt_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
        return fn


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def stream_of(x: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``x``'s device, as a kernel argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def check_operand(x, shape: tuple, name: str, fn: str, dtypes=(torch.int64,)) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``shape`` with one
    of ``dtypes`` (int64 for the integer kernels; the attention kernel
    passes its float types)."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor like the first operand, "
                         f"got one on {x.device}")
    if x.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{fn}: {name} must be {names}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{fn}: expected {name} of shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def check(name: str, code: int) -> None:
    """Raise if a C entry point of ``lib<name>.so`` returned a CUDA error."""
    if code != 0:
        msg = _libs[name].parentt_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
