"""Host-side native helpers, built on demand, loaded through ctypes.

- ``staging.cpp`` gathers a periodically wrapped subvolume of a C-order
  ``(C, D, H, W)`` host array by segment memcpys: the chunked runtime's host
  staging of each padded input chunk (numpy's broadcast fancy index runs
  element by element).
- ``fof.cpp`` is the friends-of-friends pair-linking loop of
  ``science.halos.friends_of_friends`` (a lock-free union-find over a sparse
  cell grid, threaded).

Both are host code, not device kernels.  Each source is compiled with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` at first use into the
package's git-ignored ``_build/`` (the CUDA objects' directory).  Where a
build fails, ``periodic_gather`` / ``fof_labels`` return None and the caller
takes its numpy path, which gives the same result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

FOF_THREADS_ENV = "JAX_NBODY_TORCH_FOF_THREADS"
_CACHE: dict[str, object] = {}


def _build_dir() -> Path:
    from ..ops._cuda_build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def _compile_and_load(name: str):
    """Compile <name>.cpp (once per version of it) and dlopen it; None on failure."""
    src = Path(__file__).with_name(f"{name}.cpp")
    try:
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = _build_dir() / f"{name}_{tag}.so"

        def build():
            # a name of its own per process: concurrent first builds (pytest
            # workers) must not write into one file before the atomic publish
            tmp = so.parent / f"{so.name}.build.{os.getpid()}"
            try:
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                     str(src), "-o", str(tmp)],
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


def _get_lib(name: str, configure):
    """The library of <name>.cpp with its ctypes signatures set by
    ``configure`` (None if it cannot be built; probed once per process)."""
    if name not in _CACHE:
        lib = _compile_and_load(name)
        if lib is not None:
            configure(lib)
        _CACHE[name] = lib
    return _CACHE[name]


def _load_staging():
    def configure(lib):
        lib.periodic_gather.restype = ctypes.c_int
        lib.periodic_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, *([ctypes.c_int64] * 11), ctypes.c_int,
        ]

    return _get_lib("staging", configure)


def _load_fof():
    def configure(lib):
        lib.fof_labels.restype = ctypes.c_int
        lib.fof_labels.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]

    return _get_lib("fof", configure)


def native_staging_available() -> bool:
    return _load_staging() is not None


def native_fof_available() -> bool:
    return _load_fof() is not None


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


def fof_labels(positions: np.ndarray, boxsize: float, linking_length: float,
               n_threads: int | None = None):
    """Union-find root label per particle, or None if the helper is unavailable.

    Roots are the minimum particle index of each component, the
    representative the numpy engine produces, so results are array-identical
    to it at any thread count (the lock-free union-find hooks larger roots
    under smaller; see fof.cpp).

    ``n_threads``: workers for the pair-linking loop.  Default: the
    ``JAX_NBODY_TORCH_FOF_THREADS`` environment variable, else all cores.
    """
    lib = _load_fof()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = int(os.environ.get(FOF_THREADS_ENV, "0"))
    pos = np.ascontiguousarray(positions, np.float32)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions must be (Np, 3), got {pos.shape}")
    labels = np.empty(len(pos), np.int64)
    rc = lib.fof_labels(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(pos)),
        ctypes.c_double(float(boxsize)),
        ctypes.c_double(float(linking_length)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(int(n_threads)),
    )
    if rc != 0:
        raise ValueError(f"native fof_labels failed with code {rc}")
    return labels
