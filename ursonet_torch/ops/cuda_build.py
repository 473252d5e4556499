"""Build and load the port's CUDA kernels (`ursonet_torch/csrc/*.cu`)
and its host libraries (`csrc/jpeg.cpp`, the JPEG codec,
`csrc/host_loader.cpp`, the threaded batch loader, and `csrc/zstd.cpp`,
the zstd decoder and CRC-32C of the Orbax store).

Each source is compiled with `nvcc` for sm_90a into its own shared
library with a plain C interface, at first use, into `.torch_ext/` at
the root of the checkout, and loaded with ctypes. The library name
carries a hash of the source, of every header it includes from `csrc/`
(directly or through another header) and of the compile and link
flags, so an edited source or header is rebuilt. `build_all()` starts
one `nvcc` per source at once and waits for all of them.

The host sources are built the same way with `g++`, each with its own
link flags (`HOST_LINK`: zlib and threads for the loader).
`-ffp-contract=off` keeps g++ from contracting a multiply and an add
into an FMA on a machine whose default target has one, so the loader's
float resize rounds as its numpy version does.

The JAX package's persistent compilation cache
(`ursonet_tpu/utils/cache.py`) has no twin in the port: PyTorch runs
eagerly and compiles nothing per shape, and the kernels are built once
into `.torch_ext/`, where every later process of the checkout loads
them.

Flags: `-fmad=false` keeps nvcc from contracting a multiply and an add
into an FMA, so the kernels' float arithmetic rounds exactly where their
plain PyTorch versions round.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("warp", "int8_gemm", "int8_conv", "int8_stem", "int8_block",
           "mma_rate", "actq")
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")
# host source -> its link flags
HOST_LINK = {"jpeg": (), "host_loader": ("-lz", "-pthread"), "zstd": ()}
HOST_SOURCES = tuple(HOST_LINK)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_libs: dict = {}
_load_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME to the CUDA toolkit)")


def _gxx() -> str:
    for c in ("g++", "c++"):
        path = shutil.which(c)
        if path:
            return path
    raise RuntimeError("g++ not found: the host library cannot be built")


def source_path(name: str) -> Path:
    """csrc/<name>.cpp for a host source, else csrc/<name>.cu."""
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def local_headers(path: Path) -> list:
    """The headers of `csrc/` that `path` includes with quotes, directly
    or through another of them, sorted by name."""
    seen, todo = set(), [path]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            header = CSRC / inc
            if header not in seen:
                seen.add(header)
                todo.append(header)
    return sorted(seen)


def _command_flags(name: str) -> tuple:
    if name in HOST_SOURCES:
        return GXX_FLAGS + HOST_LINK[name]
    return NVCC_FLAGS


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu (or, for a host source,
    csrc/<name>.cpp) lives: the name hashes the source, the headers it
    includes and the compile and link flags."""
    src = source_path(name)
    h = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_command_flags(name)).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    lib = library_path(name)
    if lib.exists():
        return lib, None, None, None
    BUILD_DIR.mkdir(exist_ok=True)
    # a name of this thread's own: concurrent builds (test workers, a
    # loader's threads) each rename a whole library into place
    tmp = lib.with_name(
        f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    if name in HOST_SOURCES:
        # link flags after the source, where the linker resolves them
        cmd = [_gxx(), *GXX_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(source_path(name)), *HOST_LINK[name]]
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, cmd, proc


def _finish(lib, tmp, cmd, proc) -> str:
    if proc is None:
        return "cached build"
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)
    return out


def build(name: str) -> tuple[Path, str]:
    """Compile csrc/<name>.cu (or .cpp) unless an identical build exists.
    Returns (library path, compiler output)."""
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
    """Build if needed and load csrc/<name>.cu's (or, for a host source,
    csrc/<name>.cpp's) library once per process; `bind(lib)` sets the
    argument and return types. Threads that ask at once (a loader's
    train and validation prefetchers) wait for one build."""
    with _load_lock:
        if name not in _libs:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _libs[name] = lib
        return _libs[name]
