"""Metrics logging: TensorBoard event files + JSONL fallback; a copy of
damvsnet_tpu/train/logging.py (the same records, byte for byte, but for
their wall times).

Capability parity with the reference's tensorboardX SummaryWriter usage
(train.py:420, utils.py:70-100): scalar dicts per step and image summaries.
Event files are written in the TB wire format directly (no tensorboardX
dependency); if anything fails we fall back to JSONL so training never
stops on logging.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zlib


def _masked_crc32c(data: bytes) -> int:
    # TF record CRC: crc32c masked. zlib.crc32 is crc32 (not castagnoli) —
    # TensorBoard accepts records only with correct crc32c, so implement it.
    return _crc32c_mask(_crc32c(data))


_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _crc32c_mask(crc: int) -> int:
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint_bytes(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    """Hand-rolled Event proto: wall_time(1,double) step(2,int64)
    summary(5){ value(1){ tag(1,str) simple_value(2,float) } }."""
    tag_b = tag.encode()
    val = (b"\x0a" + _varint_bytes(len(tag_b)) + tag_b
           + b"\x15" + struct.pack("<f", value))
    summary = b"\x0a" + _varint_bytes(len(val)) + val
    event = (b"\x09" + struct.pack("<d", wall_time)
             + b"\x10" + _varint_bytes(step)
             + b"\x2a" + _varint_bytes(len(summary)) + summary)
    return event


def _image_event(tag: str, png: bytes, height: int, width: int,
                 colorspace: int, step: int, wall_time: float) -> bytes:
    """Event proto carrying Summary.Value{ tag(1) image(4){ height(1,i32)
    width(2,i32) colorspace(3,i32) encoded_image_string(4,bytes) } }."""
    tag_b = tag.encode()
    img = (b"\x08" + _varint_bytes(height)
           + b"\x10" + _varint_bytes(width)
           + b"\x18" + _varint_bytes(colorspace)
           + b"\x22" + _varint_bytes(len(png)) + png)
    val = (b"\x0a" + _varint_bytes(len(tag_b)) + tag_b
           + b"\x22" + _varint_bytes(len(img)) + img)
    summary = b"\x0a" + _varint_bytes(len(val)) + val
    event = (b"\x09" + struct.pack("<d", wall_time)
             + b"\x10" + _varint_bytes(step)
             + b"\x2a" + _varint_bytes(len(summary)) + summary)
    return event


def _to_png_u8(img) -> tuple:
    """Normalize an array to uint8 RGB/grayscale and PNG-encode it.

    Accepts [H, W] (scaled to the full range like torchvision make_grid
    normalize=True scale_each=True — the reference's save_images
    preprocessing, utils.py:83-93) or [H, W, 3] float/uint8.
    Returns (png_bytes, height, width, colorspace)."""
    import numpy as np
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = a.astype(np.float64)
        finite = np.isfinite(a)
        lo = a[finite].min() if finite.any() else 0.0
        hi = a[finite].max() if finite.any() else 1.0
        a = np.clip((a - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
        a = np.nan_to_num(a)
        a = (a * 255.0).astype(np.uint8)
    import cv2
    if a.ndim == 3 and a.shape[-1] == 3:
        ok, buf = cv2.imencode(".png", cv2.cvtColor(a, cv2.COLOR_RGB2BGR))
        cs = 3
    else:
        ok, buf = cv2.imencode(".png", a)
        cs = 1
    if not ok:
        raise ValueError("PNG encode failed")
    return buf.tobytes(), a.shape[0], a.shape[1], cs


class SummaryWriter:
    """Minimal TB event writer + JSONL mirror."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        fname = f"events.out.tfevents.{int(time.time())}.damvsnet"
        self._path = os.path.join(logdir, fname)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            self._f = open(self._path, "ab")
            self._write_event(_scalar_event("_start", 0.0, 0, time.time()))
        except OSError:
            self._f = None

    def _write_event(self, event: bytes):
        if self._f is None:
            return
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc32c(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc32c(event)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_event(_scalar_event(tag, float(value), int(step), time.time()))

    def add_image(self, tag: str, img, step: int):
        """img: [H, W] (auto-normalized, grayscale) or [H, W, 3] RGB."""
        try:
            png, h, w, cs = _to_png_u8(img)
        except Exception:
            return  # logging must never stop training
        self._write_event(_image_event(tag, png, h, w, cs, int(step),
                                       time.time()))

    def add_images(self, prefix: str, images: dict, step: int):
        """save_images parity (utils.py:83-101): each value is [H, W(, 3)]
        or batched [B, H, W(, 3)] — the first element of a batch is logged,
        normalized per image."""
        import numpy as np
        for k, v in images.items():
            a = np.asarray(v)
            if a.ndim == 4 or (a.ndim == 3 and a.shape[-1] != 3):
                a = a[0]
            self.add_image(f"{prefix}/{k}" if prefix else k, a, step)

    def add_scalars(self, prefix: str, scalars: dict, step: int):
        """save_scalars parity (utils.py:70-82): '<prefix>/<key>' tags."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}/{k}" if prefix else k, v, step)
            rec[k] = float(v)
        self._jsonl.write(json.dumps({"prefix": prefix, **rec}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._f:
            self._f.close()
        self._jsonl.close()
