"""PFM (Portable Float Map) IO (copy of damvsnet_tpu/core/pfm.py).

Wire format of the reference reader/writer (datasets/data_io.py:6-71):
header 'PF'/'Pf', dims line, scale line (negative => little-endian), rows
stored bottom-up.
"""
from __future__ import annotations

import re
import sys

import numpy as np


def read_pfm(filename):
    """Read a PFM file. Returns (data, scale); data is (H, W) or (H, W, 3) float."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {filename}")
        dim_line = f.readline().decode("utf-8")
        m = re.match(r"^(\d+)\s(\d+)\s*$", dim_line)
        if not m:
            raise ValueError(f"Malformed PFM header in {filename}")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def write_pfm(filename, image, scale: float = 1.0):
    """Write a float32 image as PFM (grayscale H,W / H,W,1 or color H,W,3)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("PFM image dtype must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("PFM image must be HxW, HxWx1 or HxWx3")
    flipped = np.flipud(image)
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = flipped.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale:f}\n".encode())
        flipped.tofile(f)
