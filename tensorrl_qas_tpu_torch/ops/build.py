"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel source under ``tensorrl_qas_tpu_torch/csrc/`` exposes a plain
``extern "C"`` interface and is compiled at first use into a shared
library under ``build/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>_<hash>.so <source>

The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a stale library is never loaded.  The
compiler's output (``-Xptxas -v``: registers, shared memory and spills
per kernel) is kept beside the library as
``.log``.  A build writes to a temporary name and renames it into place,
so an interrupted build leaves nothing that a later one waits on.
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


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> pathlib.Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns {'path', 'seconds' (0.0 when already built), 'log'}.
    """
    lib = library_path(name)
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(lib), "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S, check=False)
    except subprocess.TimeoutExpired as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s "
                           f"building {name}") from exc
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "log": log}


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it at first use."""
    return ctypes.CDLL(build(name)["path"])
