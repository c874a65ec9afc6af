"""Build and load the port's CUDA kernels from the repo's sources.

``nvcc`` compiles each ``csrc/*.cu`` (plain C interface, no PyTorch
headers) for ``sm_90a`` while the host compiler compiles the op bindings
``csrc/*_op.cpp`` against PyTorch's headers; all of them run at the same
time, then ``nvcc`` links one shared library that
``torch.ops.load_library`` registers as ``torch.ops.t2omca``. Ninja and
``torch.utils.cpp_extension.load`` are not needed.

The library lands in ``kernels/_build/<key>/`` (gitignored), where the
key hashes the sources, the flags and the torch version, so an edit to
any source rebuilds and an unchanged tree reuses the library. A failed
build raises with the compiler's stderr; nothing falls back.

Run ``python -m t2omca_tpu_torch.kernels.build`` to build (and print the
build time and ``ptxas`` resource usage) without running anything.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build")
LIB_NAME = "libt2omca_kernels.so"
CUDA_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_fwd_tc.cu",
                "flash_fwd_dmma.cu", "flash_bwd_tc.cu",
                "flash_bwd_dkv_3xtf32.cu", "flash_bwd_dq_tc.cu",
                "dropout_mask.cu")
HOST_SOURCES = ("flash_fwd_op.cpp", "flash_bwd_op.cpp",
                "dropout_mask_op.cpp")
#: included by the CUDA sources (hashed into the build key with them)
HEADERS = ("flash_common.cuh", "flash_mma.cuh")
#: Hopper with the architecture-specific features (wgmma, setmaxnreg)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_loaded: Optional[str] = None
#: held while a thread builds and registers the library: threads that
#: call ``load`` at once (the serving fleet's engines) build it once
_load_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the port's CUDA "
                       "kernels build on a machine with the CUDA toolkit")


def _host_cxx() -> str:
    for cand in ("g++", "c++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++/c++) on PATH")


def _flags():
    import torch
    from torch.utils import cpp_extension
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    nvcc_flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v"]
    cxx_flags = ["-std=c++20", "-O2", "-fPIC",
                 f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
    cxx_flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    libdirs = cpp_extension.library_paths()
    link_flags = [f"-L{p}" for p in libdirs] + ["-lc10", "-ltorch_cpu"]
    link_flags += [f"-Xlinker", f"-rpath={':'.join(libdirs)}"]
    return nvcc_flags, cxx_flags, link_flags


def _key(nvcc_flags, cxx_flags, link_flags) -> str:
    import torch
    h = hashlib.sha256()
    for name in CUDA_SOURCES + HOST_SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    for part in (nvcc_flags, cxx_flags, link_flags, [torch.__version__]):
        h.update("\0".join(part).encode() + b"\1")
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]], cwd: str) -> List[str]:
    """Start every command at once, wait for all, raise on the first
    failure with its stderr. Returns each command's stderr (ptxas -v
    reports on stderr)."""
    procs = [subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({p.returncode}): {' '.join(cmd)}\n"
                f"{out}\n{err}")
    return [err for _, err in outs]


def build(verbose: bool = False) -> str:
    """→ path of the built library (built now unless already present)."""
    nvcc_flags, cxx_flags, link_flags = _flags()
    out_dir = os.path.join(BUILD_ROOT, _key(nvcc_flags, cxx_flags,
                                            link_flags))
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_ROOT, exist_ok=True)
    nvcc, cxx = _nvcc(), _host_cxx()
    tmp = tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-")
    try:
        cmds, objs = [], []
        for name in CUDA_SOURCES:
            obj = os.path.splitext(name)[0] + ".o"
            cmds.append([nvcc, *nvcc_flags, "-c", os.path.join(CSRC, name),
                         "-o", obj])
            objs.append(obj)
        for name in HOST_SOURCES:
            obj = os.path.splitext(name)[0] + ".o"
            cmds.append([cxx, *cxx_flags, "-c", os.path.join(CSRC, name),
                         "-o", obj])
            objs.append(obj)
        logs = _run_all(cmds, tmp)
        _run_all([[nvcc, ARCH, "-shared", *objs, "-o", LIB_NAME,
                   *link_flags]], tmp)
        with open(os.path.join(tmp, "build.log"), "w") as f:
            f.write("\n".join(logs))
        if verbose:
            sys.stdout.write("\n".join(logs) + "\n")
        try:
            os.replace(tmp, out_dir)
        except OSError:
            # another process finished the same build first
            if not os.path.isfile(lib):
                raise
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load():
    """Build if needed, register the ops once per process (under a lock,
    so concurrent first calls build once), → ``torch.ops.t2omca``."""
    global _loaded
    import torch
    if _loaded is None:
        with _load_lock:
            if _loaded is None:
                lib = build()
                torch.ops.load_library(lib)
                _loaded = lib
    return torch.ops.t2omca


if __name__ == "__main__":
    t0 = time.perf_counter()
    path = build(verbose=True)
    print(f"built {path} in {time.perf_counter() - t0:.1f} s")
