"""ctypes bindings for the native asset-loading hot loops (native/).

Auto-builds native/libwadnative.so with the system compiler on first use;
callers fall back to the pure-Python implementations when unavailable
(set TPU_DOOM_NATIVE=0 to force the fallback).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libwadnative.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("TPU_DOOM_NATIVE", "1") == "0":
        return None
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-s", "libwadnative.so"],
                cwd=_NATIVE_DIR,
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception as e:  # no compiler: fall back
            log.info("native wad loader unavailable (%s); using Python", e)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        log.info("failed to load %s (%s); using Python", _LIB_PATH, e)
        return None
    lib.picture_header.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.picture_header.restype = ctypes.c_int
    lib.decode_picture.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.decode_picture.restype = ctypes.c_int
    lib.blit_u16.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.blit_u16.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode_picture(buffer: bytes):
    """Native picture decode -> (pixels (H, W) u16, x_off, y_off) or None
    (caller falls back to Python; corrupt input raises like the fallback)."""
    lib = _load()
    if lib is None:
        return None
    whxy = (ctypes.c_int32 * 4)()
    rc = lib.picture_header(buffer, len(buffer), whxy)
    if rc != 0:
        from .image import CorruptImage

        raise CorruptImage(f"native header decode failed ({rc})")
    w, h, xo, yo = whxy[0], whxy[1], whxy[2], whxy[3]
    out = np.empty((h, w), dtype=np.uint16)
    rc = lib.decode_picture(
        buffer,
        len(buffer),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        w,
        h,
    )
    if rc != 0:
        from .image import CorruptImage

        raise CorruptImage(f"native picture decode failed ({rc})")
    return out, xo, yo


def blit_u16(dst: np.ndarray, src: np.ndarray, ox: int, oy: int,
             ignore_transparency: bool) -> bool:
    """Native blit; returns False when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    assert dst.dtype == np.uint16 and src.dtype == np.uint16
    assert dst.flags.c_contiguous and src.flags.c_contiguous
    lib.blit_u16(
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        dst.shape[1],
        dst.shape[0],
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        src.shape[1],
        src.shape[0],
        ox,
        oy,
        1 if ignore_transparency else 0,
    )
    return True
