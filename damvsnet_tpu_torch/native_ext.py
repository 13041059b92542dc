"""ctypes bindings for the native host kernels of native/fusion.cpp; the
port's copy of damvsnet_tpu/native_ext.py.

The library is built on first use with g++ (a few seconds) from the
repository's native/fusion.cpp into damvsnet_tpu_torch/_build/native/,
named by the hash of the source. The committed native/libdamvsnet_native.so
belongs to the JAX package and is never read or written here. Every entry
point has a numpy fallback, so nothing depends on the toolchain: get_lib()
is None when g++ fails. Host code, not a device kernel. Exposes:

  * dypcd_consistency_native — fused consistency round trip (all dynamic
    thresholds in one pass) for the host fusion path.
  * grid_nn_distances        — capped NN distances (MaxDistCP.m semantics).
  * reduce_points_native     — stochastic 0.2 mm thinning.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "fusion.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build", "native")


def library_path() -> str:
    """Where the library of the current native/fusion.cpp is built."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libdamvsnet_native_{digest}.so")


def _build_lib(src: str, out: str):
    """g++ into a temporary name, renamed into place: concurrent builds
    (test workers) never load a partial file."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             src, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library; None when unavailable."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB or None
        try:
            out = library_path()
            if not os.path.exists(out):
                _build_lib(_SRC, out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError):
            _LIB = False
            return None

        f32p = ctypes.POINTER(ctypes.c_float)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.dypcd_consistency.argtypes = [
            f32p, f32p, f32p, f32p, f32p, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, u16p, f32p]
        lib.grid_nn_distances.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_float, f32p]
        lib.reduce_points_grid.argtypes = [
            f32p, ctypes.c_int64, i32p, ctypes.c_float, u8p]
        for fn in (lib.dypcd_consistency, lib.grid_nn_distances, lib.reduce_points_grid):
            fn.restype = None
        _LIB = lib
        return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def dypcd_consistency_native(depth_ref, intr_ref, ext_ref, depth_src,
                             intr_src, ext_src, dist_base=0.25,
                             rel_diff_base=1.0 / 1300, n_thresh=9):
    """Returns (masks [T, H, W] bool, final_mask [H, W] bool,
    depth_reproj [H, W] f32) — same contract as
    infer.fusion_dypcd.check_geometric_consistency. None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = depth_ref.shape
    depth_ref = np.ascontiguousarray(depth_ref, np.float32)
    depth_src = np.ascontiguousarray(depth_src, np.float32)
    k_ref = np.ascontiguousarray(intr_ref, np.float32)
    k_src = np.ascontiguousarray(intr_src, np.float32)
    e_ref = np.ascontiguousarray(ext_ref, np.float32)
    e_src = np.ascontiguousarray(ext_src, np.float32)
    mask_bits = np.empty((h, w), np.uint16)
    depth_reproj = np.empty((h, w), np.float32)
    lib.dypcd_consistency(
        _fp(depth_ref), _fp(k_ref), _fp(e_ref), _fp(depth_src), _fp(k_src),
        _fp(e_src), h, w, dist_base, rel_diff_base, n_thresh,
        mask_bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        _fp(depth_reproj))
    masks = [(mask_bits & (1 << t)) > 0 for t in range(n_thresh)]
    return masks, masks[-1], depth_reproj


def grid_nn_distances(q_to, q_from, max_dist=60.0):
    """Capped NN distances; falls back to scipy cKDTree."""
    lib = get_lib()
    if lib is None:
        from .eval.dtu_eval import nn_distances
        return nn_distances(q_to, q_from, max_dist)
    q_to = np.ascontiguousarray(q_to, np.float32)
    q_from = np.ascontiguousarray(q_from, np.float32)
    out = np.empty(len(q_from), np.float32)
    lib.grid_nn_distances(_fp(q_to), len(q_to), _fp(q_from), len(q_from),
                          max_dist, _fp(out))
    return out


def reduce_points_native(pts, dst=0.2, seed=0):
    """Stochastic min-distance thinning; falls back to the scipy path."""
    lib = get_lib()
    if lib is None:
        from .eval.dtu_eval import reduce_points
        return reduce_points(pts, dst, seed)
    pts = np.ascontiguousarray(pts, np.float32)
    order = np.random.default_rng(seed).permutation(len(pts)).astype(np.int32)
    keep = np.empty(len(pts), np.uint8)
    lib.reduce_points_grid(
        _fp(pts), len(pts),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), dst,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return pts[keep.astype(bool)]
