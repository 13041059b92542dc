"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is a plain-C shared library: nvcc compiles it for
``sm_90a`` without PyTorch's headers (a build takes seconds), and the
wrappers load it with ``ctypes`` and pass pointers and the stream as
``c_void_p``. Builds go to ``_build/`` beside this file, named by a hash
of the source and of every header in ``csrc/`` (``sampling.cuh`` is shared
by the plane-sweep kernels), so an edited source or header is rebuilt and
a stale library is never loaded. Nothing is built or loaded when this
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_costvol", "fused_costvol_bwd", "probstats", "sweep_sampler", "prob_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """The library of csrc/<name>.cu, named by what its build reads: the
    source, every header in csrc/ and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that has no up-to-date library, all nvcc
    processes at once. Returns {name: compiler log (ptxas register and
    spill report)}, empty for sources already built. Raises on a failed
    build with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        logs = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
            os.replace(tmp, out)  # atomic: a reader never sees a partial .so
            logs[name] = log
        return logs
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
