"""Host-side native helper of the chunked runtime, built on demand, loaded through ctypes.

``staging.cpp`` gathers a periodically wrapped subvolume of a C-order
``(C, D, H, W)`` host array by segment memcpys: the chunked runtime's host
staging of each padded input chunk (numpy's broadcast fancy index runs
element by element).  It is a host gather, not a device kernel.  The source
is compiled with ``g++ -O3 -shared -fPIC`` at first use into the package's
git-ignored ``_build/`` (the CUDA objects' directory).  Where the build
fails, ``periodic_gather`` returns None and the caller takes the numpy
fancy-index path, which gives the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("staging.cpp")
_CACHE: dict[str, object] = {}


def _build_dir() -> Path:
    from ..ops._cuda_build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def _compile_and_load():
    """Compile staging.cpp (once per version of it) and dlopen it; None on failure."""
    try:
        tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so = _build_dir() / f"staging_{tag}.so"

        def build():
            # a name of its own per process: concurrent first builds (pytest
            # workers) must not write into one file before the atomic publish
            tmp = so.parent / f"{so.name}.build.{os.getpid()}"
            try:
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                     str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=300,
                )
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)

        if not so.exists():
            build()
        try:
            return ctypes.CDLL(str(so))
        except OSError:
            so.unlink(missing_ok=True)  # a damaged file: rebuild once
            build()
            return ctypes.CDLL(str(so))
    except Exception:
        return None


def _load_staging():
    """The staging library (None if it cannot be built; probed once per process)."""
    if "staging" not in _CACHE:
        lib = _compile_and_load()
        if lib is not None:
            lib.periodic_gather.restype = ctypes.c_int
            lib.periodic_gather.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, *([ctypes.c_int64] * 11), ctypes.c_int,
            ]
        _CACHE["staging"] = lib
    return _CACHE["staging"]


def native_staging_available() -> bool:
    return _load_staging() is not None


def periodic_gather(src: np.ndarray, start, out_shape, out: np.ndarray | None = None):
    """Gather ``src[:, (start+i) % shape]``, a periodically wrapped subvolume of
    a C-order ``(C, D, H, W)`` array, by segment memcpys.

    ``start`` and ``out_shape`` are per spatial axis (3-tuples); extents
    larger than the source tile the torus, as numpy's broadcast fancy index
    does.  ``out`` (C-contiguous, ``src``'s dtype, e.g. a pinned buffer's
    numpy view) receives the result if given.  Returns None when the helper
    is unavailable (callers fall back to numpy).
    """
    lib = _load_staging()
    if lib is None:
        return None
    if src.ndim != 4 or not src.flags.c_contiguous:
        raise ValueError("src must be a C-contiguous (C, D, H, W) array")
    sd, sh, sw = (int(s) % int(n) for s, n in zip(start, src.shape[1:]))
    od, oh, ow = (int(m) for m in out_shape)
    if out is None:
        out = np.empty((src.shape[0], od, oh, ow), src.dtype)
    elif out.shape != (src.shape[0], od, oh, ow) or out.dtype != src.dtype \
            or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous (C, od, oh, ow) of src dtype")
    rc = lib.periodic_gather(
        src.ctypes.data, out.ctypes.data,
        *map(ctypes.c_int64, src.shape),
        ctypes.c_int64(sd), ctypes.c_int64(sh), ctypes.c_int64(sw),
        ctypes.c_int64(od), ctypes.c_int64(oh), ctypes.c_int64(ow),
        ctypes.c_int64(src.dtype.itemsize),
        ctypes.c_int(0),
    )
    if rc != 0:
        raise ValueError(f"native periodic_gather failed with code {rc}")
    return out
