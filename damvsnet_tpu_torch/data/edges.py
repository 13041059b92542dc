"""Sobel edge-map extraction (copy of damvsnet_tpu/data/edges.py; the
reference's edge experiments: datasets/sobel_edgeDetect.py and the dtu_yao edge_extra path,
datasets/dtu_yao.py:86-101 — both commented out there; functional here for
the addEdge model variant)."""
from __future__ import annotations

import numpy as np


def sobel_edges(img: np.ndarray) -> np.ndarray:
    """RGB/gray [H, W(, C)] in [0, 1] -> gradient-magnitude edge map in
    [0, 1] (3x3 Sobel on the grayscale image, magnitude / 255)."""
    import cv2
    arr = np.asarray(img, dtype=np.float32) * 255.0
    if arr.ndim == 3:
        gray = cv2.cvtColor(arr, cv2.COLOR_RGB2GRAY)
    else:
        gray = arr
    gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0, ksize=3)
    gy = cv2.Sobel(gray, cv2.CV_32F, 0, 1, ksize=3)
    return np.sqrt(gx ** 2 + gy ** 2) / 255.0
