"""Build one CUDA source of ``csrc/`` with ``nvcc`` and load it with ``ctypes``.

Every kernel wrapper of the port builds its own source the same way: CUDA
C++ for ``sm_90a`` with a plain C interface, compiled the first time a CUDA
tensor reaches the kernel into ``_build/`` beside the sources (git-ignored),
under a file name that carries a hash of the source, the headers it includes
and the flags, so a changed source is rebuilt and an unchanged one is not.
``nvcc``'s output (with ``-Xptxas=-v``: registers, shared memory and spills
of every kernel) is kept in ``build_logs``; a failed build raises with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # source name -> nvcc's output of its last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}; set CUDA_HOME")
    return str(nvcc)


def build(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>`` (once per version of it, of the ``*.cuh``
    headers beside it and of the flags) and load the shared library.
    ``defines`` are ``NAME=value`` macros for an experiment's build of the
    source; each set is a library of its own."""
    key = " ".join((name, *defines))
    if key in _libs:
        return _libs[key]
    source = CSRC / name
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    so = BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [_nvcc(), *flags, "-I", str(CSRC), "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        build_logs[key] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {key}:\n{build_logs[key]}")
        os.replace(tmp, so)
    _libs[key] = ctypes.CDLL(str(so))
    return _libs[key]


def build_all(names) -> None:
    """Build several sources at once, one ``nvcc`` each, all started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build, names))
