"""Minimal binary-little-endian PLY IO (vertex clouds with color); a copy
of damvsnet_tpu/core/ply.py.

Replaces the reference's dependency on `plyfile` (filter/dypcd.py:312-326)
with a self-contained writer/reader producing byte-compatible files for
xyz(f4)+rgb(u1) vertex clouds — the only layout the MVS pipeline emits.
"""
from __future__ import annotations

import numpy as np

_VERTEX_DTYPE = np.dtype(
    [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
     ("red", "u1"), ("green", "u1"), ("blue", "u1")]
)


def write_ply(filename, xyz: np.ndarray, rgb: np.ndarray | None = None):
    """Write an (N,3) float point cloud (+ optional (N,3) uint8 colors)."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    if rgb is None:
        rgb = np.zeros((n, 3), dtype=np.uint8)
    rgb = np.asarray(rgb, dtype=np.uint8).reshape(-1, 3)
    verts = np.empty(n, dtype=_VERTEX_DTYPE)
    verts["x"], verts["y"], verts["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    verts["red"], verts["green"], verts["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        verts.tofile(f)


def read_ply(filename):
    """Read a PLY vertex cloud. Returns (xyz (N,3) float32, rgb (N,3) uint8 or None).

    Supports binary_little_endian and ascii with float x/y/z (+ uchar rgb),
    which covers both our writer and the DTU ground-truth/eval clouds.
    """
    with open(filename, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element"):
                parts = line.split()
                in_vertex = parts[1] == b"vertex"
                if in_vertex:
                    n = int(parts[2])
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()
                props.append((parts[2].decode(), parts[1].decode()))
            elif line == b"end_header":
                break
        typemap = {
            "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
            "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
            "uint": "<u4", "short": "<i2", "ushort": "<u2", "char": "i1",
        }
        dt = np.dtype([(name, typemap[t]) for name, t in props])
        if fmt == "binary_little_endian":
            verts = np.fromfile(f, dtype=dt, count=n)
        elif fmt == "ascii":
            verts = np.loadtxt(f, dtype=dt, max_rows=n)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    xyz = np.stack([verts["x"], verts["y"], verts["z"]], axis=1).astype(np.float32)
    rgb = None
    if "red" in dt.names:
        rgb = np.stack([verts["red"], verts["green"], verts["blue"]], axis=1).astype(np.uint8)
    return xyz, rgb
