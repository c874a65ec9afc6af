"""Build and load the native sum-tree (``sumtree.cpp``) through ctypes.

The C++ side is a plain ``extern "C"`` shared object, compiled with
``g++ -O2 -shared -fPIC`` at first use into ``native/_build/`` beside
the source (gitignored), keyed by the source's SHA-256. A failed build
raises ``NativeBuildError``; nothing falls back to the Python tree.

    python -m t2omca_tpu_torch.native.build     # build without loading
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "sumtree.cpp")
_BUILD = os.path.join(_DIR, "_build")
_LIB = {}


class NativeBuildError(RuntimeError):
    pass


def build() -> str:
    """→ the path of the built ``libsumtree.so`` (built if missing)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD, digest)
    so = os.path.join(out, "libsumtree.so")
    if os.path.exists(so):
        return so
    os.makedirs(out, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeBuildError(f"g++ build of {_SRC} failed: {detail}") \
            from e
    os.replace(tmp, so)
    return so


def load_sumtree() -> ctypes.CDLL:
    """→ the library with typed signatures (built at first use)."""
    if "lib" in _LIB:
        return _LIB["lib"]
    lib = ctypes.CDLL(build())
    c = ctypes
    i64p, f64p = c.POINTER(c.c_int64), c.POINTER(c.c_double)
    lib.sumtree_create.restype = c.c_void_p
    lib.sumtree_create.argtypes = [c.c_int64]
    lib.sumtree_free.argtypes = [c.c_void_p]
    lib.sumtree_set.argtypes = [c.c_void_p, c.c_int64, c.c_double]
    lib.sumtree_set_batch.argtypes = [c.c_void_p, i64p, f64p, c.c_int64]
    lib.sumtree_total.restype = c.c_double
    lib.sumtree_total.argtypes = [c.c_void_p]
    lib.sumtree_get.restype = c.c_double
    lib.sumtree_get.argtypes = [c.c_void_p, c.c_int64]
    lib.sumtree_get_batch.argtypes = [c.c_void_p, i64p, c.c_int64, f64p]
    lib.sumtree_find.restype = c.c_int64
    lib.sumtree_find.argtypes = [c.c_void_p, c.c_double]
    lib.sumtree_sample.argtypes = [c.c_void_p, f64p, c.c_int64, i64p, f64p]
    _LIB["lib"] = lib
    return lib


if __name__ == "__main__":
    print(build())
