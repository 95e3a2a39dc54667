"""Build and load the hand-written CUDA kernels of `tpupose_torch/csrc`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for sm_90a into its own shared library under `tpupose_torch/_build/`
(named by a hash of the source and the flags, its link flags included, so
an edited source is rebuilt), then loaded with ctypes. A source that calls
a CUDA library names it in `LIBRARIES`; it is linked from the toolkit's
library directory, which the shared library keeps as its run path.
Nothing is built at import time: the first call that needs a kernel
builds it, and `build_all` compiles every source at once, one `nvcc`
process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: CUDA toolkit libraries a source links against, by kernel name.
LIBRARIES = {"jpeg_decode": ("nvjpeg",)}

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel name -> source file, for every `csrc/*.cu`."""
    return {p.stem: p for p in sorted(SOURCE_DIR.glob("*.cu"))}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ([os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []) + [
        shutil.which("nvcc") or ""
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit "
                       "with sm_90a support")


def link_flags(name: str) -> tuple[str, ...]:
    """`-l` flags for the source's `LIBRARIES`, with the toolkit's library
    directory as link path and run path; none for a source without any."""
    libs = LIBRARIES.get(name, ())
    if not libs:
        return ()
    lib_dir = str(Path(nvcc()).resolve().parent.parent / "lib64")
    return ("-L" + lib_dir, "-Xlinker", "-rpath=" + lib_dir, *("-l" + lib for lib in libs))


def _flags(name: str) -> tuple[str, ...]:
    return (*NVCC_FLAGS, *link_flags(name))


def _target(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None, verbose: bool = False) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    in parallel. Returns seconds per kernel that was compiled; raises with
    nvcc's output if any compile fails."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(sources()[name]), *link_flags(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        if verbose and log.strip():
            print(f"[nvcc {name}]\n{log.rstrip()}")
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
