"""Build and load the port's CUDA kernels (`ursonet_torch/csrc/*.cu`).

Each source is compiled with `nvcc` for sm_90a into its own shared
library with a plain C interface, at first use, into `.torch_ext/` at
the root of the checkout, and loaded with ctypes. The library name
carries a hash of the source, of every header in `csrc/` and of the
flags, so an edited source or header is rebuilt. `build_all()` starts
one `nvcc` per source at once and waits for all of them.

Flags: `-fmad=false` keeps nvcc from contracting a multiply and an add
into an FMA, so the kernels' float arithmetic rounds exactly where their
plain PyTorch versions round.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("warp", "int8_gemm", "int8_conv")

_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME to the CUDA toolkit)")


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu lives (hash of source, headers
    and flags in the name)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    lib = library_path(name)
    if lib.exists():
        return lib, None, None, None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, cmd, proc


def _finish(lib, tmp, cmd, proc) -> str:
    if proc is None:
        return "cached build"
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)
    return out


def build(name: str) -> tuple[Path, str]:
    """Compile csrc/<name>.cu unless an identical build exists. Returns
    (library path, compiler output)."""
    lib, tmp, cmd, proc = _start(name)
    return lib, _finish(lib, tmp, cmd, proc)


def build_all() -> dict:
    """Compile every source in parallel, one nvcc each, all started
    together. Returns {name: (library path, compiler output)}; raises
    if any build failed (after all of them ended)."""
    started = {n: _start(n) for n in SOURCES}
    out, errors = {}, []
    for n, job in started.items():
        try:
            out[n] = (job[0], _finish(*job))
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str, bind) -> ctypes.CDLL:
    """Build if needed and load csrc/<name>.cu's library once per
    process; `bind(lib)` sets the argument and return types."""
    if name not in _libs:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _libs[name] = lib
    return _libs[name]
