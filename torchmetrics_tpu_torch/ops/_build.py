"""Build and load the port's CUDA kernels.

Replaces ``torchmetrics_tpu/ops/_dispatch.py``: the port dispatches on
``tensor.is_cuda`` in each wrapper, and this module only turns the sources in
``csrc/`` into one shared library with a plain C interface, loaded with ``ctypes``.

The library is built at first use, from the package's own sources, with
``nvcc -gencode arch=compute_90a,code=sm_90a`` (Hopper). Each source compiles in its
own ``nvcc`` process, all started together, and one more ``nvcc`` links them. The
result is ``_build/libtm_kernels_<hash>.so``, where the hash covers the sources and
the flags, so an edited source builds anew and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of every C entry point in csrc/; each returns a cudaError_t
_SIGNATURES = {
    "tm_stat_counts": [_P, _I, _P, _I, _LL, _LL, _I, _LL, _I, _I, _I, _P, _P],
    "tm_multi_threshold_confmat": [
        _P, _I, _I,
        _P, _I, _I, _I,
        _P, _I, _I, _I,
        _P, _P, _I,
        _I, _I, _I, _I, _I, _I,
        _P, _P, _P,
    ],
    "tm_max_shared_optin": [_I, ctypes.POINTER(_I)],
}

_LIB: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin)")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libtm_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link them; a no-op if already built."""
    target = library_path()
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failures = []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"$ {' '.join(cmd)}\n{out.decode(errors='replace')}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        so_tmp = os.path.join(tmp, target.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", *(obj for _, obj, _ in procs), "-o", so_tmp]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n{res.stdout.decode(errors='replace')}")
        # atomic publish: a concurrent build of the same sources writes the same file
        os.replace(so_tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


_MAX_SHARED: dict = {}
_SM_COUNT: dict = {}


def device_index(device) -> int:
    """The CUDA device index of ``device`` (the current device when it has none)."""
    import torch

    return device.index if device.index is not None else torch.cuda.current_device()


def sm_count(index: int) -> int:
    """Streaming multiprocessors on device ``index``."""
    if index not in _SM_COUNT:
        import torch

        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def max_shared_optin(device_index: int) -> int:
    """Largest dynamic shared memory a block may opt in to on ``device_index``."""
    if device_index not in _MAX_SHARED:
        out = ctypes.c_int(0)
        check(library().tm_max_shared_optin(device_index, ctypes.byref(out)), "cudaDeviceGetAttribute")
        _MAX_SHARED[device_index] = out.value
    return _MAX_SHARED[device_index]
