"""Build the hand-written kernels and the host engine, and load them with
ctypes.

Each CUDA source under ``tensorrl_qas_tpu_torch/csrc/`` exposes a plain
``extern "C"`` interface and is compiled at first use into a shared
library under ``build/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>_<hash>.so <source>

The host statevector engine ``csrc/csim.cpp`` (``native/``) is built the
same way by g++ (``build_host``):

    g++ -O3 -std=c++17 -shared -fPIC -o build/lib<name>_<hash>.so <source>

The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``, for a CUDA source) and the flags, so a stale library is
never loaded.  The compiler's output (for nvcc ``-Xptxas -v``: registers,
shared memory and spills per kernel) is kept beside the library as
``.log``.  A build writes to a temporary name and renames it into place,
so an interrupted build leaves nothing that a later one waits on.  A
missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
GXX_TIMEOUT_S = 120


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host engine (csrc/csim.cpp) "
                       "builds only where a C++ compiler is installed")


def _library_path(name: str, sources, flags) -> pathlib.Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    return _library_path(name, [CSRC / f"{name}.cu",
                                *sorted(CSRC.glob("*.cuh"))], NVCC_FLAGS)


def host_library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cpp`` is (or will be) built."""
    return _library_path(name, [CSRC / f"{name}.cpp"], GXX_FLAGS)


def _compile(name: str, lib: pathlib.Path, compiler, flags, source,
             timeout_s: int) -> dict:
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(lib), "seconds": 0.0, "log": log}
    cmd = [compiler(), *flags]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd += ["-o", str(tmp), str(source)]
    tool = pathlib.Path(cmd[0]).name
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, check=False)
    except subprocess.TimeoutExpired as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{tool} timed out after {timeout_s} s "
                           f"building {name}") from exc
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{tool} failed building {name} "
                           f"(exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "log": log}


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` with nvcc unless its library exists.

    Returns {'path', 'seconds' (0.0 when already built), 'log'}.
    """
    return _compile(name, library_path(name), nvcc_path, NVCC_FLAGS,
                    CSRC / f"{name}.cu", NVCC_TIMEOUT_S)


def build_host(name: str) -> dict:
    """Compile ``csrc/<name>.cpp`` with g++ for the host unless its
    library exists; returns what ``build`` returns."""
    return _compile(name, host_library_path(name), gxx_path, GXX_FLAGS,
                    CSRC / f"{name}.cpp", GXX_TIMEOUT_S)


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it at first use."""
    return ctypes.CDLL(build(name)["path"])


def load_host(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cpp``, building it at first use."""
    return ctypes.CDLL(build_host(name)["path"])
