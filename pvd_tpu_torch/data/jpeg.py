"""JPEG frames for the blender-format reader (port of the JAX package's
cv2 path, pvd_tpu/data/provider.py:33).

`read_jpeg` decodes baseline and extended sequential Huffman JPEG (8-bit,
grey or YCbCr, any integral sampling such as 4:4:4, 4:2:2 or 4:2:0,
restart intervals, any size) into what cv2 gives the JAX package, bit for
bit: libjpeg's integer IDCT, its "fancy" upsampling and its fixed-point
YCbCr -> RGB (`csrc/jpeg.cpp` says which of its routines each step
follows).  Progressive, arithmetic-coded, lossless, 12-bit, CMYK and
RGB-coded files raise ValueError, as `data/png.py` refuses what it does
not read.  The decoder is host C++ (`csrc/jpeg.cpp`), built with g++ at
first use into `build/jpeg/` (`data/hostlib.py`) and bound through
ctypes; there is no other JPEG path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from pvd_tpu_torch.data import hostlib

SOURCE = hostlib.CSRC / "jpeg.cpp"
BUILD_DIR = hostlib.BUILD_ROOT / "jpeg"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
MAGIC = b"\xff\xd8"
_ERR_LEN = 256


@functools.cache
def load() -> ctypes.CDLL:
    """The decoder library, built first if needed."""
    lib = ctypes.CDLL(str(hostlib.build(SOURCE, BUILD_DIR, GXX_FLAGS)))
    ptr = ctypes.c_char_p
    lib.jpg_info.argtypes = [ptr, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.c_char_p, ctypes.c_int]
    lib.jpg_decode.argtypes = [ptr, ctypes.c_size_t, ctypes.c_void_p,
                               ctypes.c_char_p, ctypes.c_int]
    return lib


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """[H, W, 1] (grey) or [H, W, 3] (RGB) uint8 of a JPEG file's bytes;
    raises ValueError for a file it does not read."""
    lib = load()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                    ctypes.byref(c), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.jpg_decode(data, len(data), out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))
